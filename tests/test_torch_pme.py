"""PME spread (B2) + FFT + interpolation (B3) plain twins vs the JAX package.

* float32: against ``pallas_pme.pme_reciprocal_pallas`` in interpret mode on
  the configuration of tests/test_pallas_pme.py:10-54, at its 2e-5
  tolerances.
* float64: against the generic ``pme.pme_reciprocal`` at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.ops import neighbors as jneighbors
from nonbondedslicing_tpu.ops import pallas_pme
from nonbondedslicing_tpu.ops import pme as jpme
from nonbondedslicing_tpu.utils.indexing import slice_pair_table, slice_subsets

from nonbondedslicing_tpu_torch.ops import cuda_pme
from nonbondedslicing_tpu_torch.ops import neighbors as tneighbors
from nonbondedslicing_tpu_torch.ops import pme as tpme

torch.set_num_threads(2)

N, NSUB, BOX = 500, 3, 4.2
BRICKS = (2, 2, 2)
GRID = (16, 16, 16)
CAPACITY = 96
ALPHA = 2.8


def _inputs():
    rng = np.random.default_rng(12)
    positions = rng.random((N, 3)) * BOX
    charge = rng.normal(size=N)
    subsets = rng.integers(0, NSUB, N)
    lam = rng.random(6)
    return positions, charge, subsets, lam


def _port_slots(positions, charge, subsets, dtype):
    """Brick-ordered slot tensors built with the port's own slot table."""
    pos = torch.as_tensor(positions).to(dtype)
    box = torch.as_tensor(np.diag([BOX] * 3)).to(dtype)
    cell = tneighbors.cell_ids(pos, box, BRICKS)
    table, ov = tneighbors.build_occupancy(cell, N, BRICKS, CAPACITY)
    assert int(ov) == 0
    slots = table.reshape(-1).long()
    g = BRICKS[0] * BRICKS[1] * BRICKS[2]
    pos_p = torch.cat([pos, pos.new_zeros((1, 3))])
    q_p = torch.cat([torch.as_tensor(charge).to(dtype), pos.new_zeros(1)])
    sub_p = torch.cat([torch.as_tensor(subsets), torch.zeros(1, dtype=torch.int64)])
    slot_pos = pos_p[slots].reshape(g, CAPACITY, 3).transpose(1, 2).contiguous()
    slot_q = q_p[slots].reshape(g, CAPACITY)
    slot_sub = sub_p[slots].reshape(g, CAPACITY).to(torch.int32)
    return box, table, slot_pos, slot_q, slot_sub


def _port(positions, charge, subsets, lam, dtype):
    box, table, slot_pos, slot_q, slot_sub = _port_slots(positions, charge,
                                                         subsets, dtype)
    moduli = tpme.bspline_moduli(GRID)
    eterm = torch.as_tensor(tpme.coulomb_eterm_np(GRID, moduli, box.numpy(),
                                                  ALPHA)).to(dtype)
    lam_nn = torch.as_tensor(lam[slice_pair_table(NSUB)]).to(dtype)
    e, f = cuda_pme.pme_reciprocal(
        slot_pos, slot_q, slot_sub, box, lam_nn, grid_shape=GRID,
        eterm=eterm, slice_subset_pairs=slice_subsets(NSUB))
    # slot forces -> atom order
    inv = torch.zeros(N + 1, dtype=torch.int64)
    inv[table.reshape(-1).long()] = torch.arange(table.numel())
    f_atoms = f.transpose(1, 2).reshape(-1, 3)[inv[:N]]
    return e.numpy(), f_atoms.numpy(), table


def test_plain_pme_matches_pallas_f32():
    positions, charge, subsets, lam = _inputs()
    e_t, f_t, table = _port(positions, charge, subsets, lam, torch.float32)

    # the JAX kernels on the same brick slots
    box_arr = jnp.asarray(np.diag([BOX] * 3), jnp.float32)
    pos = jnp.asarray(positions, jnp.float32)
    cell = jneighbors.cell_ids(pos, box_arr, BRICKS)
    table_j, _ = jneighbors.build_occupancy(cell, N, BRICKS, CAPACITY)
    np.testing.assert_array_equal(np.asarray(table_j), table.numpy())
    slots = np.asarray(table_j).reshape(-1)
    g = BRICKS[0] * BRICKS[1] * BRICKS[2]
    pos_p = np.concatenate([positions, np.zeros((1, 3))]).astype(np.float32)
    q_p = np.concatenate([charge, [0.0]]).astype(np.float32)
    sub_p = np.concatenate([subsets, [NSUB]])
    pos_b = pos_p[slots].reshape(g, CAPACITY, 3).swapaxes(1, 2)
    q_b = q_p[slots].reshape(g, CAPACITY)
    soh_b = (sub_p[slots][:, None] == np.arange(NSUB)).astype(
        np.float32).reshape(g, CAPACITY, NSUB).swapaxes(1, 2)
    e_j, f_jb = pallas_pme.pme_reciprocal_pallas(
        jnp.asarray(pos_b), jnp.asarray(q_b), jnp.asarray(soh_b), box_arr,
        jnp.asarray(lam, jnp.float32), alpha=ALPHA, grid_shape=GRID,
        moduli=jpme.bspline_moduli(GRID), bricks=BRICKS,
        slice_subset_pairs=jnp.asarray(slice_subsets(NSUB)),
        slice_table=slice_pair_table(NSUB).astype(np.int32), interpret=True)
    f_j = np.zeros((N + 1, 3))
    f_j[slots] = np.asarray(f_jb).reshape(-1, 3)
    f_j = f_j[:N]

    np.testing.assert_allclose(e_t, np.asarray(e_j), rtol=2e-5)
    scale = np.abs(f_j).max() + 1.0
    np.testing.assert_allclose(f_t, f_j, atol=2e-5 * scale)


def test_plain_pme_f64_matches_generic_pme():
    positions, charge, subsets, lam = _inputs()
    e_t, f_t, _ = _port(positions, charge, subsets, lam, torch.float64)
    e_o, f_o = jpme.pme_reciprocal(
        jnp.asarray(positions), jnp.asarray(np.diag([BOX] * 3)),
        jnp.asarray(charge), jnp.asarray(subsets, jnp.int32), jnp.asarray(lam),
        alpha=ALPHA, grid_shape=GRID, moduli=jpme.bspline_moduli(GRID),
        num_subsets=NSUB, slice_subset_pairs=jnp.asarray(slice_subsets(NSUB)),
        slice_table=slice_pair_table(NSUB), dense=False)
    np.testing.assert_allclose(e_t, np.asarray(e_o), rtol=1e-10)
    f_o = np.asarray(f_o)
    np.testing.assert_allclose(f_t, f_o, rtol=0,
                               atol=1e-10 * np.abs(f_o).max())


@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 15, 20)])
def test_spread_grid_is_the_jax_grid(grid):
    """The plain spread equals the JAX package's scatter spread (same
    (floor(t) + k) mod n index convention), in float64."""
    positions, charge, subsets, _ = _inputs()
    box, _, slot_pos, slot_q, slot_sub = _port_slots(positions, charge,
                                                     subsets, torch.float64)
    recip = torch.linalg.inv(box).T
    grid_t = cuda_pme.pme_spread(slot_pos, slot_q, slot_sub, recip, grid,
                                 NSUB)
    pos = jnp.asarray(positions)
    index, frac = jpme.grid_index_and_fraction(
        pos, jnp.asarray(recip.numpy()), grid)
    theta, _ = jpme.bsplines(frac)
    grid_j = jpme.spread_charges(jnp.asarray(charge),
                                 jnp.asarray(subsets, jnp.int32), index,
                                 theta, grid, NSUB)
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), rtol=0,
                               atol=1e-12)
