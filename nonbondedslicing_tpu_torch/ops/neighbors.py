"""Cell grid sizing and the slot table of the fused engine.

Atoms map to cells of a static (ncx, ncy, ncz) grid whose perpendicular slab
widths are at least the cutoff; a stable sort by cell id gives a dense
(n_cells, capacity) slot table padded with the dummy index ``n``.  Atoms
beyond the static capacity are counted, never silently dropped: callers
check the overflow count (the reference's voxel hash is exact,
ReferenceNonbondedSlicingKernels.cpp:197).
"""

import math

import numpy as np
import torch

from .geometry import recip_box_vectors


def _perpendicular_widths(box):
    """Perpendicular distance between periodic images along each axis."""
    box = np.asarray(box, dtype=np.float64)
    recip = np.linalg.inv(box).T  # rows are reciprocal vectors
    return 1.0 / np.linalg.norm(recip, axis=1)


def choose_cell_grid(box, cutoff, num_particles, max_cells=262144,
                     target_skin=0.0):
    """Static cell-grid configuration (counts, capacity) or None if a cell
    list is not applicable (too few cells per axis).

    ``target_skin`` sizes cells from cutoff+skin so MD callers can reuse the
    cell assignment across steps (Verlet-list style); falls back to
    skin-less sizing when the box is too small for it.  At least 3 cells per
    axis keep the 27 neighbor cells of every cell distinct.
    """
    widths = _perpendicular_widths(box)
    counts = np.maximum(np.floor(widths / (cutoff + target_skin)).astype(int),
                        1)
    if target_skin > 0.0 and np.any(counts < 3):
        counts = np.maximum(np.floor(widths / cutoff).astype(int), 1)
    if np.any(counts < 3):
        return None
    while int(np.prod(counts)) > max_cells:
        # halve only the largest axis, so a thin axis never drops below 3
        counts[np.argmax(counts)] //= 2
    if np.any(counts < 3):
        return None
    n_cells = int(np.prod(counts))
    mean_occ = num_particles / n_cells
    capacity = int(math.ceil(mean_occ * 2.0 + 4))
    capacity = max(8, ((capacity + 3) // 4) * 4)
    return tuple(int(c) for c in counts), capacity


def cell_ids(positions, box, counts):
    """Runtime cell id per atom (int64) from fractional coordinates."""
    frac = positions @ recip_box_vectors(box)
    frac = frac - torch.floor(frac)
    ci = [(frac[:, a] * counts[a]).to(torch.int32).to(torch.int64)
          .clamp(0, counts[a] - 1) for a in range(3)]
    return (ci[0] * counts[1] + ci[1]) * counts[2] + ci[2]


def build_occupancy(cell, n, counts, capacity):
    """Dense (n_cells, capacity) int32 slot table of atom indices, padded
    with the dummy index ``n``, and the number of dropped atoms (0-d int64
    tensor).  The sort is stable, so the table is a pure function of the
    cell ids."""
    n_cells = counts[0] * counts[1] * counts[2]
    order = torch.argsort(cell, stable=True)
    sorted_cell = cell[order]
    starts = torch.searchsorted(
        sorted_cell, torch.arange(n_cells, dtype=cell.dtype,
                                  device=cell.device))
    rank = torch.arange(n, device=cell.device) - starts[sorted_cell]
    fits = rank < capacity
    dest = torch.where(fits, sorted_cell * capacity + rank,
                       torch.full_like(rank, n_cells * capacity))
    table = torch.full((n_cells * capacity + 1,), n, dtype=torch.int32,
                       device=cell.device)
    # atoms that do not fit all write the sink entry, which is dropped: no
    # boolean mask, so no host sync (the table is built inside CUDA graphs)
    table[dest] = order.to(torch.int32)
    overflow = torch.sum(~fits)
    return table[:-1].reshape(n_cells, capacity), overflow
