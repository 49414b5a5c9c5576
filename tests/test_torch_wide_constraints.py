"""The gather constrainer's solve for clusters wider than 3 (CGLS, which a
CUDA graph captures) against ``torch.linalg.pinv``, and the MD step on a
constrained chain against the JAX package's.

* ``cgls_solve`` against the pseudo-inverse on a rigid CH4 (10 coupled
  constraints on 9 internal degrees of freedom: J is singular) and on the
  7-wide cluster of two waters joined by an O-O constraint
  (tests/test_torch_md.py::test_md_graph_flag_for_wide_clusters), at the
  velocity stage (RATTLE, J symmetric) and at a consistent position stage
  (M-SHAKE, J = 4 s (r_now . r_ref), not symmetric; b = J y): float64 to
  1e-10 relative, float32 to 1e-5 of the answer.
* ``make_md_step`` on port_systems.py's solute box at small size with the
  chain's 1-2 pairs as constraints (one 11-wide cluster, every water
  triangle padded to it) against the JAX package's, in single precision:
  positions to 2e-4 nm over 20 steps and the final energy to 1e-3
  relative, the bounds of
  tests/test_torch_md.py::test_md_solute_trajectory_matches_jax."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.runtime.fastpath import make_md_step as jax_md_step

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime import constraints as tcons
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from port_systems import BOND_R0, KB, SOLUTE_SITES
from tests.test_torch_md import SOLUTE_BOX, _solute_box
from tests.test_torch_md_mixed import _constrained_chain
from tests.test_torch_plan import jax_data_np, water_box

torch.set_num_threads(2)

STEPS = 20


def _methane(n_mol=6, seed=9):
    """Rigid CH4s at random orientations: (positions, masses, constraints
    as (i, j, distance))."""
    d_ch = 0.1087
    verts = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                     dtype=np.float64) * d_ch / np.sqrt(3.0)
    d_hh = float(np.linalg.norm(verts[0] - verts[1]))
    rng = np.random.default_rng(seed)
    positions = np.zeros((5 * n_mol, 3))
    cons = []
    for m in range(n_mol):
        c = 5 * m
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        positions[c] = rng.random(3) * 3.0
        positions[c + 1:c + 5] = positions[c] + verts @ q.T
        cons += [(c, c + 1 + a, d_ch) for a in range(4)]
        cons += [(c + 1 + a, c + 1 + b, d_hh)
                 for a in range(4) for b in range(a + 1, 4)]
    return positions, np.tile([12.011] + [1.008] * 4, n_mol), cons


def _two_waters():
    """The waters of a 27-water box, the first two joined by an O-O
    constraint: one 7-wide cluster, the other waters padded to it."""
    _, _, positions, masses, (pairs, dists), _ = water_box(nbt, n_mol=27)
    cons = [(i, j, d) for p, dd in zip(pairs, dists)
            for (i, j), d in zip(p, dd)]
    cons.append((0, 3, float(np.linalg.norm(positions[0] - positions[3]))))
    return positions, masses, cons


CASES = {"ch4": (_methane, 10), "two_waters": (_two_waters, 7)}


def _system(case, stage):
    """The batched (J, b) of one solve of ``case`` at ``stage``, in float64,
    as GatherConstrainer builds them (padded rows masked)."""
    build, width = CASES[case]
    positions, masses, cons = build()
    pairs, dists, mask = tcons.cluster_constraints(cons, len(masses))
    assert pairs.shape[1] == width
    solver = tcons.GatherConstrainer(pairs, dists, masses, mask=mask)
    rng = np.random.default_rng(3)
    pos = torch.as_tensor(positions)
    c = solver._consts(pos)
    i, j = c["i"], c["j"]
    r_ref = pos[i] - pos[j]
    if stage == "velocity":
        vel = torch.as_tensor(rng.normal(size=positions.shape))
        rhs = torch.sum(r_ref * (vel[i] - vel[j]), dim=-1)
        J = c["s"] * torch.einsum("mkx,mlx->mkl", r_ref, r_ref)
    else:
        moved = pos + torch.as_tensor(rng.normal(scale=2e-3,
                                                 size=positions.shape))
        r_now = moved[i] - moved[j]
        J = 4.0 * c["s"] * torch.einsum("mkx,mlx->mkl", r_now, r_ref)
        # a right-hand side in the range of J: the system is consistent
        rhs = torch.einsum("mkl,ml->mk", J,
                           torch.as_tensor(rng.normal(size=J.shape[:2])))
    J, rhs = solver._mask(c, J, rhs)
    return solver, J, rhs


@pytest.mark.parametrize("stage", ["velocity", "position"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cgls_matches_pinv(case, stage):
    """float64 to 1e-10 relative of the pseudo-inverse's answer; float32
    (the iteration count's binding case) to 1e-5 of the answer in float64
    from the float32 blocks, whose pseudo-inverse drops singular values
    below 10 C float32 epsilons of the largest, as the JAX package's
    float32 ``pinv`` does."""
    solver, J, b = _system(case, stage)
    width = J.shape[-1]
    iterations = tcons.cgls_iterations(width)
    want = torch.einsum("mkl,ml->mk", torch.linalg.pinv(J), b)
    got = tcons.cgls_solve(J, b, iterations)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-10, rel
    # the solve the constrainer runs is this one
    assert torch.equal(solver._solve(J, b), got)
    J32, b32 = J.float(), b.float()
    want32 = torch.einsum(
        "mkl,ml->mk",
        torch.linalg.pinv(J32.double(),
                          rtol=10 * width * torch.finfo(torch.float32).eps),
        b32.double())
    got32 = tcons.cgls_solve(J32, b32, iterations).double()
    rel32 = float((got32 - want32).abs().max() / want32.abs().max())
    assert rel32 <= 1e-5, rel32
    # padded rows stay inert
    if case == "two_waters":
        live = solver._host["row_mask"] != 0
        assert not live.all()
        assert torch.all(got[torch.as_tensor(~live)] == 0)


def test_wide_projection_without_pinv(monkeypatch):
    """Every width is capturable, and projecting a wide cluster's positions
    and velocities calls no pseudo-inverse (which copies from the host)."""
    positions, masses, cons = _methane()
    pairs, dists, mask = tcons.cluster_constraints(cons, len(masses))
    px, pv = tcons.make_constrainer(pairs, dists, masses, len(masses),
                                    mask=mask)
    assert px.__self__.capturable and px.__self__.width == 10

    def refused(*args, **kwargs):
        raise AssertionError("torch.linalg.pinv called")

    monkeypatch.setattr(torch.linalg, "pinv", refused)
    rng = np.random.default_rng(5)
    pos = torch.as_tensor(positions)
    moved = pos + torch.as_tensor(rng.normal(scale=2e-3, size=pos.shape))
    x = px(pos, moved)
    v = pv(x, torch.as_tensor(rng.normal(size=pos.shape)))
    i = torch.as_tensor(pairs[..., 0][mask != 0], dtype=torch.int64)
    j = torch.as_tensor(pairs[..., 1][mask != 0], dtype=torch.int64)
    d = torch.as_tensor(dists[mask != 0])
    assert float(((x[i] - x[j]).norm(dim=-1) - d).abs().max()) < 1e-12
    assert float(torch.sum((x[i] - x[j]) * (v[i] - v[j]),
                           dim=-1).abs().max()) < 1e-12


def test_md_constrained_chain_matches_jax():
    """The chain in water with its 1-2 pairs constrained (one 11-wide
    cluster) and its 1-3 pairs bonded, single precision, through both
    packages' make_md_step: positions to 2e-4 nm over 20 steps, the final
    energy to 1e-3 relative; the chain's constraints hold to 1e-5 nm."""
    system_j, force_j, positions, masses, constraints, bonds = \
        _constrained_chain(_solute_box(nbs))
    system_t, force_t, positions_t, _, _, _ = \
        _constrained_chain(_solute_box(nbt))
    np.testing.assert_array_equal(positions, positions_t)
    assert constraints[0].shape[1] == SOLUTE_SITES - 1
    plan_j = jplan.build_plan(force_j, system_j)
    plan_t = tplan.build_plan(force_t, system_t)
    rng = np.random.default_rng(11)
    vel = (rng.normal(size=positions.shape)
           * np.sqrt(KB * 300.0 / masses)[:, None])
    box = np.diag([SOLUTE_BOX] * 3)
    gvals = plan_t.global_defaults

    run_t = make_md_step(plan_t, masses, dt=0.002, dtype=torch.float32,
                         constraints=constraints, bonds=bonds, reuse_steps=2)
    assert run_t.config["graph"] is True
    p_t, _, e_t = run_t(positions, vel, box, gvals,
                        tengine.plan_data(plan_t, device="cpu",
                                          dtype=torch.float32), STEPS)

    run_j = jax_md_step(plan_j, masses, dt=0.002, dtype=jnp.float32,
                        constraints=constraints, bonds=bonds, reuse_steps=2)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in jax_data_np(plan_j).items()}
    p_j, _, e_j = run_j(jnp.asarray(positions, jnp.float32),
                        jnp.asarray(vel, jnp.float32),
                        jnp.asarray(box, jnp.float32),
                        jnp.asarray(gvals, jnp.float32), data_j, STEPS)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)
    p = p_t.double().numpy()
    d = np.linalg.norm(p[1:SOLUTE_SITES] - p[:SOLUTE_SITES - 1], axis=1)
    assert np.abs(d - BOND_R0).max() < 1e-5
