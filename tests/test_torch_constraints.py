"""Port SETTLE / RATTLE vs the JAX package's dense SETTLE projector:
float64 to 1e-10, float32 to 1e-6 (absolute, nm and nm/ps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.runtime import constraints as jcons

from nonbondedslicing_tpu_torch.runtime import constraints as tcons

from tests.test_torch_plan import D_HH, D_OH, water_box

torch.set_num_threads(2)

TOL = {torch.float64: 1e-10, torch.float32: 1e-6}


def _setup(seed=4):
    _, _, positions, masses, (pairs, dists), _ = water_box(nbs, n_mol=27)
    rng = np.random.default_rng(seed)
    n = positions.shape[0]
    vel = rng.normal(scale=0.5, size=(n, 3))
    # an unconstrained leapfrog-sized update of the constrained positions
    pos_new = positions + 0.002 * vel + rng.normal(scale=1e-3, size=(n, 3))
    return positions, pos_new, vel, masses, np.asarray(pairs), np.asarray(dists)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_settle_matches_jax(dtype):
    pos, pos_new, vel, masses, pairs, dists = _setup()
    n = pos.shape[0]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    px_j, pv_j = jcons.make_constrainer(pairs, dists, masses, n, dtype=jdt)
    px_t, pv_t = tcons.make_constrainer(pairs, dists, masses, n)
    t = lambda a: torch.as_tensor(a).to(dtype)   # noqa: E731
    j = lambda a: jnp.asarray(a, jdt)            # noqa: E731

    x_t = px_t(t(pos), t(pos_new)).numpy()
    x_j = np.asarray(px_j(j(pos), j(pos_new)))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=TOL[dtype])
    v_t = pv_t(t(x_t), t(vel)).numpy()
    v_j = np.asarray(pv_j(j(x_j), j(vel)))
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=TOL[dtype])

    # and the constraints hold
    x = x_t.astype(np.float64).reshape(-1, 3, 3)
    for (a, b), d in (((0, 1), D_OH), ((0, 2), D_OH), ((1, 2), D_HH)):
        err = np.abs(np.linalg.norm(x[:, a] - x[:, b], axis=-1) - d)
        assert err.max() < (1e-12 if dtype == torch.float64 else 1e-6)


def test_cluster_constraints_matches_jax():
    _, _, _, _, (pairs, dists), _ = water_box(nbs, n_mol=8)
    flat = [(i, j, d) for p, dd in zip(pairs, dists)
            for (i, j), d in zip(p, dd)]
    flat.append((30, 31, 0.1))          # a lone constraint pads to width 3
    for a, b in zip(tcons.cluster_constraints(flat, 32),
                    jcons.cluster_constraints(flat, 32)):
        np.testing.assert_array_equal(a, b)


def test_unported_solvers_raise():
    _, _, _, masses, (pairs, dists), _ = water_box(nbs, n_mol=8)
    pairs = np.asarray(pairs)
    dists = np.asarray(dists).copy()
    dists[:, 1] *= 1.01                 # not isoceles: M-SHAKE in JAX
    with pytest.raises(NotImplementedError, match="A11"):
        tcons.make_constrainer(pairs, dists, masses, 24)
