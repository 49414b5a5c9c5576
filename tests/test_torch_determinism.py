"""Bitwise-repeatable results of the atom-space PME (``ops/pme.py``).

The port spreads into int64 fixed-point grids (``pme.spread_fixed``):
integer sums do not depend on the order of the atoms, so a call repeats to
the bit, atoms given in another order give the same grids and slice
energies and their forces in that order, and the int64 grids of a split of
the atoms add up to the whole grid (the sharded sum of
``parallel/pme_shard.py``).  The JAX package's counterparts:
``tests/test_pme_paths.py::test_deterministic_forces`` and
``tests/test_two_forces.py::test_deterministic_forces``.  On the card:
``chip_smoke.py``'s determinism phase and ``tests/test_torch_gpu_context.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.ops import pme as jpme
from nonbondedslicing_tpu.utils.indexing import slice_pair_table, slice_subsets

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import pme as tpme
from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors

N, NSUB, BOX = 300, 3, 3.2
GRID = (12, 15, 20)
ALPHA = 2.8
DTYPES = [torch.float32, torch.float64]
DTYPE_IDS = ["float32", "float64"]


def _inputs(n=N, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * BOX, rng.normal(size=n),
            rng.integers(0, NSUB, n), rng.random(6))


def _kw():
    return dict(alpha=ALPHA, grid_shape=GRID,
                moduli=tuple(torch.as_tensor(m)
                             for m in tpme.bspline_moduli(GRID)),
                num_subsets=NSUB,
                slice_subset_pairs=torch.as_tensor(slice_subsets(NSUB)),
                slice_table=torch.as_tensor(slice_pair_table(NSUB)))


def _port(positions, charge, subsets, lam, dtype, **kw):
    return tpme.pme_reciprocal(
        torch.as_tensor(positions).to(dtype),
        torch.as_tensor(np.diag([BOX] * 3)).to(dtype),
        torch.as_tensor(charge).to(dtype), torch.as_tensor(subsets),
        torch.as_tensor(lam).to(dtype), **_kw(), **kw)


def _fixed_grid(positions, charge, subsets, dtype, scale=None):
    """The int64 grid of the atoms, at ``scale`` (default: theirs)."""
    pos = torch.as_tensor(positions).to(dtype)
    q = torch.as_tensor(charge).to(dtype)
    box = torch.as_tensor(np.diag([BOX] * 3)).to(dtype)
    index, frac = tpme.grid_index_and_fraction(pos, recip_box_vectors(box),
                                               GRID)
    theta, _ = tpme.bsplines(frac)
    if scale is None:
        scale = tpme.fixed_point_scale(q)
    return tpme.spread_fixed(q, torch.as_tensor(subsets), index, theta, GRID,
                             NSUB, scale), index, theta


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_pme_reciprocal_repeats_to_the_bit(dtype):
    """(a) Two calls on the same inputs: equal to the bit."""
    inputs = _inputs()
    e1, f1 = _port(*inputs, dtype)
    e2, f2 = _port(*inputs, dtype)
    assert torch.equal(e1, e2) and torch.equal(f1, f2)


def test_fixed_point_pme_matches_jax_in_float64():
    """(a) The fixed-point spread keeps the float64 parity of
    ``tests/test_torch_pme.py``: JAX's ``pme.pme_reciprocal`` within 1e-10
    (energies relative, forces of max|F|)."""
    positions, charge, subsets, lam = _inputs()
    e_t, f_t = _port(positions, charge, subsets, lam, torch.float64)
    e_o, f_o = jpme.pme_reciprocal(
        jnp.asarray(positions), jnp.asarray(np.diag([BOX] * 3)),
        jnp.asarray(charge), jnp.asarray(subsets, jnp.int32), jnp.asarray(lam),
        alpha=ALPHA, grid_shape=GRID, moduli=jpme.bspline_moduli(GRID),
        num_subsets=NSUB, slice_subset_pairs=jnp.asarray(slice_subsets(NSUB)),
        slice_table=slice_pair_table(NSUB), dense=False)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_o), rtol=1e-10)
    f_o = np.asarray(f_o)
    np.testing.assert_allclose(f_t.numpy(), f_o, rtol=0,
                               atol=1e-10 * np.abs(f_o).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_permuted_atoms_give_the_same_grid_to_the_bit(dtype):
    """(b) The atoms in another order: slice energies equal to the bit, the
    forces permuted to the bit, the int64 grids equal.  A float
    ``index_add_`` adds in the atoms' order and rounds differently."""
    positions, charge, subsets, lam = _inputs()
    perm = np.random.default_rng(3).permutation(N)
    e1, f1 = _port(positions, charge, subsets, lam, dtype)
    e2, f2 = _port(positions[perm], charge[perm], subsets[perm], lam, dtype)
    assert torch.equal(e1, e2)
    assert torch.equal(f1[torch.as_tensor(perm)], f2)
    g1 = _fixed_grid(positions, charge, subsets, dtype)[0]
    g2 = _fixed_grid(positions[perm], charge[perm], subsets[perm], dtype)[0]
    assert torch.equal(g1, g2)


def test_large_total_charge_spreads_without_overflow():
    """(c) Sum |q| of 1.2e6 e, every charge positive, in one subset, and
    every atom within 0.1 nm of one point, so that the grid's largest point
    holds a good part of the bound: no int64 point wraps, and the grid is
    the float64 spread's (``index_add_`` on the CPU, in the atoms' order)
    within the fixed point's resolution."""
    rng = np.random.default_rng(5)
    n = 400
    positions = 1.6 + 0.1 * rng.random((n, 3))
    charge = 3000.0 * (0.5 + rng.random(n))
    subsets = np.zeros(n, dtype=np.int64)
    fixed, index, theta = _fixed_grid(positions, charge, subsets,
                                      torch.float64)
    scale = float(tpme.fixed_point_scale(torch.as_tensor(charge)))
    assert 2.0 ** 59 < scale * np.abs(charge).sum() <= 2.0 ** 60
    assert int(fixed.min()) >= 0 and int(fixed.max()) < 2 ** 62
    assert int(fixed.max()) > 2 ** 56       # the densest point is near it
    grid = tpme.fixed_to_grid(fixed, torch.tensor(scale, dtype=torch.float64),
                              torch.float64)
    # the float64 spread, as the port added it before the fixed point
    q = torch.as_tensor(charge)
    ix, iy, iz = tpme._stencil_lines(index, GRID, 5)
    vals = (q[:, None, None, None] * theta[:, 0, :, None, None]
            * theta[:, 1, None, :, None] * theta[:, 2, None, None, :])
    nx, ny, nz = GRID
    lin = (((torch.as_tensor(subsets)[:, None, None, None] * nx
             + ix[:, :, None, None]) * ny + iy[:, None, :, None]) * nz
           + iz[:, None, None, :])
    ref = torch.zeros(NSUB * nx * ny * nz, dtype=torch.float64).index_add_(
        0, lin.reshape(-1), vals.reshape(-1)).reshape(NSUB, nx, ny, nz)
    # half a unit for each of the n contributions a point can take, and
    # the float64 sum's own rounding
    tol = 0.5 * n / scale + 4 * n * np.finfo(np.float64).eps * float(
        ref.max())
    assert float((grid - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_halves_add_up_to_the_whole_grid(dtype):
    """(d) The atoms split in two, each half spread at the scale of all
    atoms, the two int64 grids added: the whole grid to the bit (the
    sharded sum of ``pme_reciprocal(group=)``, without ranks)."""
    positions, charge, subsets, _ = _inputs()
    scale = tpme.fixed_point_scale(torch.as_tensor(charge).to(dtype))
    whole = _fixed_grid(positions, charge, subsets, dtype, scale)[0]
    half = N // 2 + 7
    parts = [_fixed_grid(positions[s], charge[s], subsets[s], dtype,
                         scale)[0]
             for s in (slice(0, half), slice(half, N))]
    assert torch.equal(parts[0] + parts[1], whole)


@pytest.mark.parametrize("method", ["PME", "LJPME"])
def test_context_forces_repeat_to_the_bit(method):
    """(e) The port's ``test_two_forces.py::test_deterministic_forces``:
    a Context on Reference (float64, CPU), getState twice with
    setPositions between: forces, energy and dE/dlambda equal to the bit,
    under PME and LJPME."""
    rng = np.random.default_rng(11)
    system = nbt.System()
    box = 3.2
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = nbt.SlicedNonbondedForce(2)
    force.setNonbondedMethod(getattr(nbt.SlicedNonbondedForce, method))
    force.setCutoffDistance(1.0)
    n = 120
    for i in range(n):
        system.addParticle(16.0)
        force.addParticle((-1.0) ** i * 0.35, 0.3, 0.4)
        force.setParticleSubset(i, i % 2)
    force.addGlobalParameter("lam", 0.7)
    force.addScalingParameter("lam", 0, 1, True, True)
    force.addEnergyParameterDerivative("lam")
    system.addForce(force)
    context = nbt.Context(system, nbt.VerletIntegrator(0.001),
                          nbt.Platform.getPlatformByName("Reference"),
                          {"Device": "cpu"})
    positions = rng.random((n, 3)) * box
    states = []
    for _ in range(2):
        context.setPositions(positions)
        states.append(context.getState(getForces=True, getEnergy=True,
                                       getParameterDerivatives=True))
    a, b = states
    np.testing.assert_array_equal(np.asarray(a.getForces()),
                                  np.asarray(b.getForces()))
    assert a.getPotentialEnergy() == b.getPotentialEnergy()
    assert (a.getEnergyParameterDerivatives()["lam"]
            == b.getEnergyParameterDerivatives()["lam"])
