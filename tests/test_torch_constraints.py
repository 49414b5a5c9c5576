"""Port constraint solvers vs the JAX package's.

* SETTLE / RATTLE vs the dense SETTLE projector: float64 to 1e-10, float32
  to 1e-6 (absolute, nm and nm/ps).
* The gather solver (M-SHAKE / RATTLE over gathered clusters) vs
  ``_make_gather_constrainer``, on waters beside an unconstrained 12-site
  chain (width 3, closed-form solve) and on clustered constraints with a
  4-wide cluster (padded rows, pseudo-inverse solve): float64 to 1e-10,
  float32 to 1e-5 (absolute, nm and nm/ps).
* Contiguous triangles that are not isoceles: the gather solver vs the
  JAX package's dense M-SHAKE triangle solver, float64 to 1e-10."""

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


def _chain_and_waters(case):
    """(positions, pos_new, vel, masses, pairs, dists, mask) of 27 waters
    after a 12-site chain; ``wide`` also constrains the chain's first
    four sites as one 4-constraint cluster."""
    _, _, positions, masses, (pairs, dists), _ = water_box(nbs, n_mol=27)
    ns = 12
    rng = np.random.default_rng(6)
    chain = 1.0 + np.cumsum(rng.normal(scale=0.09, size=(ns, 3)), axis=0)
    positions = np.concatenate([chain, positions])
    masses = np.concatenate([np.full(ns, 14.027), masses])
    pairs = np.asarray(pairs) + ns
    dists = np.asarray(dists)
    mask = None
    if case == "wide":
        flat = [(i, j, d) for p, dd in zip(pairs, dists)
                for (i, j), d in zip(p, dd)]
        for i, j in ((0, 1), (1, 2), (2, 3), (0, 2)):
            flat.append((i, j, float(np.linalg.norm(chain[i] - chain[j]))))
        pairs, dists, mask = tcons.cluster_constraints(flat, len(positions))
        assert pairs.shape[1] == 4
    n = positions.shape[0]
    vel = rng.normal(scale=0.5, size=(n, 3))
    pos_new = positions + 0.002 * vel + rng.normal(scale=1e-3, size=(n, 3))
    return positions, pos_new, vel, masses, pairs, dists, mask


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["waters_chain", "wide"])
def test_gather_constrainer_matches_jax(case, dtype):
    pos, pos_new, vel, masses, pairs, dists, mask = _chain_and_waters(case)
    n = pos.shape[0]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    px_j, pv_j = jcons._make_gather_constrainer(pairs, dists, masses, 8, jdt,
                                                mask=mask)
    px_t, pv_t = tcons.make_constrainer(pairs, dists, masses, n, mask=mask)
    # not contiguous triangles over every atom: the gather solver
    assert isinstance(px_t.__self__, tcons.GatherConstrainer)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    t = lambda a: torch.as_tensor(a).to(dtype)   # noqa: E731
    j = lambda a: jnp.asarray(a, jdt)            # noqa: E731

    x_t = px_t(t(pos), t(pos_new)).numpy()
    x_j = np.asarray(px_j(j(pos), j(pos_new)))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=tol)
    v_t = pv_t(t(x_t), t(vel)).numpy()
    v_j = np.asarray(pv_j(j(x_j), j(vel)))
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=tol)
    # the chain sites outside any constraint did not move
    free = slice(4, 12) if case == "wide" else slice(0, 12)
    np.testing.assert_array_equal(x_t[free], t(pos_new).numpy()[free])


def test_unported_solvers_raise():
    """Contiguous triangles that are not isoceles (a rigid three-site
    molecule with three different legs), which the JAX package solves with
    its dense M-SHAKE triangle solver, go to the port's gather solver,
    whose closed-form width-3 solve is the same iteration: positions and
    velocities equal the JAX solver's to 1e-10 in float64, and the
    constraints hold.  (Nothing of make_constrainer raises any more.)"""
    pos, pos_new, vel, masses, pairs, dists = _setup()
    n = pos.shape[0]
    dists = dists.copy()
    dists[:, 1] *= 1.04                 # O-H2 longer than O-H1
    dists[:, 2] *= 0.97
    masses = masses.copy()
    masses[2::3] = 2.014                # and the second H heavier
    px_j, pv_j = jcons.make_constrainer(pairs, dists, masses, n,
                                        dtype=jnp.float64)
    px_t, pv_t = tcons.make_constrainer(pairs, dists, masses, n)
    assert isinstance(px_t.__self__, tcons.GatherConstrainer)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)   # noqa: E731
    x_t = px_t(t(pos), t(pos_new)).numpy()
    x_j = np.asarray(px_j(jnp.asarray(pos), jnp.asarray(pos_new)))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-10)
    v_t = pv_t(t(x_t), t(vel)).numpy()
    v_j = np.asarray(pv_j(jnp.asarray(x_j), jnp.asarray(vel)))
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-10)
    x = x_t.reshape(-1, 3, 3)
    d = np.asarray(dists).reshape(-1, 3)
    for k, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
        err = np.abs(np.linalg.norm(x[:, a] - x[:, b], axis=-1) - d[:, k])
        assert err.max() < 1e-8
