"""Shapes for the owner-computes spread kernel (``csrc/pme_spread.cu``)
and the whole-grid interpolation (``csrc/pme_interp.cu``), and window
layouts for the fold (``csrc/pme_fold.cu``), shared by the CPU tests of
their decompositions (tests/test_torch_spread_owner.py,
tests/test_torch_interp_fold_design.py) and the tests of the CUDA kernels
on the card (tests/test_torch_gpu_kernels.py), and window widths for the
window interpolation (``csrc/pme_interp_windows.cu``;
tests/test_torch_extract_interp_windows_design.py).  A case is made from a
seed with numpy as float64 slot tensors on the CPU, grouped on a lattice of
cells or bricks as ``ops/fused.py`` groups them.  This module imports torch
and the port only.
"""

import numpy as np
import torch

from nonbondedslicing_tpu_torch.ops import neighbors as tneighbors
from nonbondedslicing_tpu_torch.ops import pme_bricks as tbricks
from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors

TRICLINIC = ((4.2, 0.0, 0.0), (0.9, 4.0, 0.0), (-1.1, 1.3, 3.9))
# (box vectors, cells, bricks or None, grid, nsub, atoms, capacity, skin nm,
# displaced by skin/2 after the slot table was built)
SPREAD_CASES = {
    "cubic": (np.diag([4.2] * 3), (6, 6, 6), None, (30, 30, 30), 2, 700,
              12, 0.12, False),
    "grid_28_on_6": (np.diag([4.2] * 3), (6, 6, 6), None, (28, 30, 28), 3,
                     700, 12, 0.12, False),
    "triclinic": (np.asarray(TRICLINIC), (6, 5, 5), None, (30, 25, 27), 2,
                  700, 16, 0.10, False),
    "drift": (np.diag([4.2] * 3), (6, 6, 6), None, (28, 30, 28), 2, 700, 12,
              0.12, True),
    "triclinic_drift": (np.asarray(TRICLINIC), (6, 5, 5), None, (30, 25, 27),
                        2, 700, 16, 0.10, True),
    "bricks": (np.diag([4.2] * 3), (8, 8, 8), (4, 4, 4), (32, 32, 32), 3,
               900, 8, 0.12, False),
}


# cases of the window interpolation (csrc/pme_interp_windows.cu), in the
# format of SPREAD_CASES, their own bricks of w = 13, 14 and 16 points along
# z (so every chunk width of the kernel: float, float2, float4), p differing
# per axis; atoms drift 1.1 to 2.1 grid points (half the skin of 0.6 nm),
# so some stencil rows reach past the window's width and some atoms leave
# their brick's window on the low side
WIDTH_CASES = {
    "w13": (np.diag([4.2] * 3), (4, 6, 4), (2, 3, 4), (16, 27, 28), 2, 700,
            20, 0.6, True),
    "w14": (np.asarray(TRICLINIC), (6, 4, 4), (3, 2, 2), (21, 20, 16), 3,
            700, 20, 0.6, True),
    "w16": (np.diag([4.2] * 3), (4, 4, 6), (2, 4, 3), (18, 28, 30), 2, 700,
            20, 0.6, True),
}

# the brick-major cases the window interpolation's tests run: the widths,
# and spread cases on their window bricks (one brick along y and z in the
# triclinic one)
WINDOW_INTERP_CASES = tuple(sorted(WIDTH_CASES)) + ("bricks", "drift",
                                                    "triclinic_drift")


def window_bricks(case):
    """Bricks of the case's cells for the window spread: the case's own, or
    a coarser lattice with at least 6 grid points a brick (w <= 2p)."""
    _, cells, bricks, grid, *_ = (SPREAD_CASES | WIDTH_CASES)[case]
    if bricks is not None:
        return bricks
    out = tuple(2 if nc % 2 == 0 and n % 2 == 0 else 1
                for nc, n in zip(cells, grid))
    assert all(n % b == 0 and n // b >= 6 for n, b in zip(grid, out))
    return out


def spread_case_slots(case, seed=21, bricks=None):
    """Float64 slot tensors of random charges (pads: charge 0), grouped on
    the case's lattice (or on ``bricks`` of its cells), with the slot table
    built at the drawn positions;
    with drift, the atoms then move by half the skin along the normal of
    a face (each of the six in turn), and a few that start a hair inside
    a cell's face leave it, one of them across the box face."""
    (box_v, cells, case_bricks, grid, nsub, n, capacity, skin,
     drift) = (SPREAD_CASES | WIDTH_CASES)[case]
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3))
    if drift:
        # a hair inside a face of a cell, on every axis and side, and one
        # atom at the box's upper x face
        for i in range(24):
            a, up = i % 3, (i // 3) % 2
            c = rng.integers(0, cells[a])
            frac[i, a] = (c + (1 - 1e-6 if up else 1e-6)) / cells[a]
        frac[24] = (1 - 1e-6, 0.5, 0.5)
    box = torch.as_tensor(box_v, dtype=torch.float64)
    pos = torch.as_tensor(frac) @ box
    cell = tneighbors.cell_ids(pos, box, cells)
    table, ov = tneighbors.build_occupancy(cell, n, cells, capacity)
    assert int(ov) == 0
    recip = recip_box_vectors(box)
    if drift:
        normals = (recip / torch.linalg.norm(recip, dim=0)).T   # (3, 3)
        face = torch.arange(n) % 6
        sign = torch.where(face % 2 == 0, 1.0, -1.0).double()
        step = sign[:, None] * normals[face // 2] * (0.5 * skin)
        # the hair-inside atoms move out of their cell
        up = torch.as_tensor([(i // 3) % 2 == 1 for i in range(24)])
        for i in range(24):
            s = 1.0 if up[i] else -1.0
            step[i] = s * normals[i % 3] * (0.5 * skin)
        step[24] = normals[0] * (0.5 * skin)
        assert torch.allclose(torch.linalg.norm(step, dim=1),
                              torch.full((n,), 0.5 * skin, dtype=step.dtype))
        pos = pos + step
    slots = table.reshape(-1).long()
    g = cells[0] * cells[1] * cells[2]
    pos_p = torch.cat([pos, pos.new_zeros((1, 3))])
    q_p = torch.cat([torch.as_tensor(rng.normal(size=n)), pos.new_zeros(1)])
    sub_p = torch.cat([torch.as_tensor(rng.integers(0, nsub, n)),
                       torch.zeros(1, dtype=torch.int64)])
    slot_pos = pos_p[slots].reshape(g, capacity, 3).transpose(1, 2)
    slot_q = q_p[slots].reshape(g, 1, capacity)
    slot_sub = sub_p[slots].reshape(g, 1, capacity).to(torch.int32)
    bricks = bricks or case_bricks
    lattice = cells
    if bricks is not None:
        lattice = bricks
        slot_pos, slot_q, slot_sub = (
            tbricks.cells_to_bricks(x, cells, bricks)
            for x in (slot_pos, slot_q, slot_sub))
    return dict(pos=slot_pos.contiguous(), q=slot_q[:, 0].contiguous(),
                sub=slot_sub[:, 0].contiguous(), recip=recip, box=box_v,
                grid=grid, nsub=nsub, lattice=lattice, skin=skin)


# (bricks, grid, nsub) of the fold: p differs per axis, w = p + 6 reaches 2p
# (p = 6) on some axes, one brick along z (its pieces come from itself)
FOLD_LAYOUTS = {
    "w2p_x": ((2, 3, 2), (12, 24, 18), 1),      # p = (6, 8, 9)
    "w2p_all": ((3, 2, 2), (18, 12, 12), 2),    # p = 6 on every axis
    "uneven": ((2, 3, 2), (16, 21, 14), 3),     # p = (8, 7, 7)
    "one_brick_z": ((2, 2, 1), (14, 12, 7), 2),  # p = (7, 6, 7)
}


def fold_windows(layout, seed=5):
    """Random float32 windows (bx, by, bz, nsub, wx, wy, wz) of a layout."""
    bricks, grid, nsub = FOLD_LAYOUTS[layout]
    w = tuple(w for _, w in tbricks.brick_window(grid, bricks))
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.normal(size=bricks + (nsub,) + w).astype(np.float32))


def potential_grids(s, seed=4):
    """Random float64 potential grids (nsub, nx, ny, nz) for a spread case's
    slot tensors ``s``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(s["nsub"],) + tuple(s["grid"])))


# layouts of extract (csrc/pme_extract.cu): the fold's, whose rows of 12, 13
# and 15 points take 16- and 4-byte stores, and one of 14 (8-byte stores)
EXTRACT_LAYOUTS = dict(FOLD_LAYOUTS, rows_of_14=((3, 2, 2), (21, 20, 16), 3))


def layout_grids(layout, seed=6):
    """Random float32 potential grids (nsub, nx, ny, nz) of an extract
    layout."""
    bricks, grid, nsub = EXTRACT_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(nsub,) + grid).astype(np.float32))


def potential_windows(s, bricks, seed=4):
    """Random float64 potential windows (bx, by, bz, nsub, wx, wy, wz) for a
    case's brick-major slot tensors ``s``."""
    w = tuple(w for _, w in tbricks.brick_window(s["grid"], bricks))
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=tuple(bricks) + (s["nsub"],) + w))
