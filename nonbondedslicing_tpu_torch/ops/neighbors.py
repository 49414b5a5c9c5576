"""Cell grid sizing, the slot table, and the cell-list direct space of the
generic engine.

Atoms map to cells of a static (ncx, ncy, ncz) grid whose perpendicular slab
widths are at least the cutoff; a stable sort by cell id gives a dense
(n_cells, capacity) slot table padded with the dummy index ``n``.  Atoms
beyond the static capacity are counted, never silently dropped: callers
check the overflow count (the reference's voxel hash is exact,
ReferenceNonbondedSlicingKernels.cpp:197).

:func:`make_cell_direct_space` is the plain cell-list engine (the JAX
package's ``neighbors.py:121-309``): for every cell its slots against the
slots of its 27 neighbour cells, in chunks of cells, each unordered pair
visited from both sides.  It is the generic engine's float64 route and its
``neighbor="cell"`` route; with ``shard`` each rank takes a range of the
cells (``neighbors.py:155-158``, ``:279-302``).
"""

import math

import numpy as np
import torch

from ..parallel import collectives
from .direct import PLAIN, make_pair_terms, slice_tables, subset_moments
from .geometry import min_image, recip_box_vectors


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


def cell_overflow(positions, box, counts, capacity):
    """Number of atoms beyond the static capacity (validation helper)."""
    cell = cell_ids(positions, box, counts)
    return build_occupancy(cell, positions.shape[0], counts, capacity)[1]


def gather_slots(slots, par, subsets, exclusion_list, n_cells, capacity):
    """Per-slot parameters of a slot table (``slots``: the flat int64 table,
    pads = n): ``par`` (N, P) -> (n_cells, P, C) with zeros on pads, the
    subsets (n_cells, C) int32 (0 on pads) and the exclusion lists
    (n_cells, emax, C) int32 (-1 on pads)."""
    emax = exclusion_list.shape[1]
    par_p = torch.cat([par, par.new_zeros((1, par.shape[1]))])
    slot_par = par_p[slots].reshape(n_cells, capacity, -1).transpose(1, 2)
    sub_p = torch.cat([subsets, subsets.new_zeros(1)])
    slot_sub = sub_p[slots].reshape(n_cells, capacity).to(torch.int32)
    excl_p = torch.cat([exclusion_list, exclusion_list.new_full((1, emax),
                                                                -1)])
    slot_excl = (excl_p[slots].reshape(n_cells, capacity, emax)
                 .transpose(1, 2).to(torch.int32))
    return (slot_par.contiguous(), slot_sub.contiguous(),
            slot_excl.contiguous())


def exclusion_span(positions, box, pair_i, pair_j, counts):
    """Largest span of the excluded pairs (pair_i[k], pair_j[k]) in cell
    widths: the minimum-image delta in fractional coordinates times the
    cell counts, largest over pairs and axes (a 0-d float64 tensor; 0
    without pairs).  Under 1, every excluded pair lies within the 27-cell
    neighbourhood of its atoms' cells."""
    if pair_i.shape[0] == 0:
        return torch.zeros((), dtype=torch.float64, device=positions.device)
    dr = min_image(positions[pair_i] - positions[pair_j], box)
    frac = (dr @ recip_box_vectors(box)).abs()
    # no host->device copy: the fused engine builds this inside CUDA graphs
    return torch.stack([frac[:, a].max() * counts[a]
                        for a in range(3)]).max().to(torch.float64)


def _neighbor_offsets():
    return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def make_cell_direct_space(*, mode, cutoff, counts, capacity, krf=0.0,
                           crf=0.0, use_switch=False, switch_distance=0.0,
                           ewald_alpha=0.0, ljpme=False, dispersion_alpha=0.0,
                           num_slices=1, cells_per_chunk=None, shard=None):
    """Cell-list variant of ``direct.make_direct_space`` (periodic methods):

    f(positions, box, charge, sig_half, eps2, subsets, exclusion_list,
      slice_table, lam_coul, lam_vdw)
      -> (slice_energies (S, 2) float64, forces (N, 3), overflow int32)

    Atoms are sorted into the slot table, and each chunk of
    ``cells_per_chunk`` cells computes (cells, C, 27 C) tiles of its slots
    against the slots of their 27 neighbour cells (minimum image per pair).
    ``overflow`` counts the atoms beyond the static capacity: callers must
    check it.  The function carries ``returns_overflow = True``.

    ``shard`` (a ``torch.distributed`` process group) splits the cells
    among its ranks (``collectives.share``): every rank builds the whole
    slot table, computes the rows of its own cells only, sums its slice
    energies over the group in float64 and its forces, written back as a
    permutation into zeros, over the group too; every rank returns the
    same full result, equal to the unsharded one to rounding (the order of
    the sums).
    """
    assert mode != PLAIN
    pair_terms = make_pair_terms(
        mode=mode, cutoff=cutoff, krf=krf, crf=crf, use_switch=use_switch,
        switch_distance=switch_distance, ewald_alpha=ewald_alpha, ljpme=ljpme,
        dispersion_alpha=dispersion_alpha)
    ncx, ncy, ncz = counts
    n_cells = ncx * ncy * ncz
    if cells_per_chunk is None:
        cells_per_chunk = max(1, 512 // capacity)

    def direct_space(positions, box, charge, sig_half, eps2, subsets,
                     exclusion_list, slice_table, lam_coul, lam_vdw):
        n = positions.shape[0]
        dtype, dev = positions.dtype, positions.device
        sl_tab, spairs = slice_tables(slice_table, dev)
        nsub = sl_tab.shape[0]
        lam_c_nn = lam_coul[sl_tab]
        lam_v_nn = lam_vdw[sl_tab]
        table, overflow = build_occupancy(cell_ids(positions, box, counts), n,
                                          counts, capacity)
        slots = table.reshape(-1).long()
        emax = exclusion_list.shape[1]
        # the slots' features; pads carry atom index n and no exclusions
        pos_s = torch.cat([positions, positions.new_zeros((1, 3))])[slots]
        par = torch.stack([charge, sig_half, eps2], dim=1)
        par_s, sub_s, excl_s = gather_slots(slots, par, subsets.long(),
                                            exclusion_list.long(), n_cells,
                                            capacity)
        par_s = par_s.transpose(1, 2).reshape(-1, 3)
        sub_s = sub_s.long().reshape(-1)
        excl_s = excl_s.long().transpose(1, 2).reshape(n_cells, capacity,
                                                        emax)
        # candidate slots of every cell: its 27 neighbour cells' slots
        cells = torch.arange(n_cells, device=dev).reshape(ncx, ncy, ncz)
        cand_cells = torch.stack(
            [torch.roll(cells, (-dx, -dy, -dz), dims=(0, 1, 2)).reshape(-1)
             for (dx, dy, dz) in _neighbor_offsets()], dim=1)  # (cells, 27)
        cand_slots = (cand_cells[:, :, None] * capacity
                      + torch.arange(capacity, device=dev)).reshape(
                          n_cells, 27 * capacity)
        oh = torch.nn.functional.one_hot(sub_s, nsub).to(dtype)
        slice_energies = torch.zeros((num_slices, 2), dtype=torch.float64,
                                     device=dev)
        lo, hi = ((0, n_cells) if shard is None
                  else collectives.share(n_cells, shard))
        f_slots = torch.empty((n_cells * capacity, 3), dtype=dtype,
                              device=dev)
        for c0 in range(lo, hi, cells_per_chunk):
            c1 = min(c0 + cells_per_chunk, hi)
            rows = torch.arange(c0 * capacity, c1 * capacity,
                                device=dev).reshape(c1 - c0, capacity)
            cols = cand_slots[c0:c1]                   # (g, 27C)
            ri, ci = slots[rows], slots[cols]
            dr = min_image(pos_s[rows][:, :, None, :]
                           - pos_s[cols][:, None, :, :], box)
            r2 = torch.sum(dr * dr, dim=-1)            # (g, C, 27C)
            mask = (ri[:, :, None] != ci[:, None, :])
            mask &= (ri[:, :, None] < n) & (ci[:, None, :] < n)
            mask &= r2 < cutoff * cutoff
            excluded = torch.any(ci[:, None, :, None]
                                 == excl_s[c0:c1][:, :, None, :], dim=-1)
            mask &= ~excluded
            r2s = torch.where(mask, r2, torch.ones((), dtype=dtype,
                                                   device=dev))
            rinv = torch.rsqrt(r2s)
            pr, pc = par_s[rows], par_s[cols]
            e_coul, e_vdw, dedr_c, dedr_v = pair_terms(
                r2s, rinv, pr[:, :, None, 1], pc[:, None, :, 1],
                pr[:, :, None, 2], pc[:, None, :, 2],
                pr[:, :, None, 0] * pc[:, None, :, 0])
            sub_i, sub_j = sub_s[rows][:, :, None], sub_s[cols][:, None, :]
            factor = torch.where(mask, lam_v_nn[sub_i, sub_j] * dedr_v
                                 + lam_c_nn[sub_i, sub_j] * dedr_c, 0.0)
            f_slots[c0 * capacity:c1 * capacity] = torch.einsum(
                "gcj,gcjk->gck", factor, dr).reshape(-1, 3)
            ec = subset_moments(torch.where(mask, e_coul, 0.0), oh[rows],
                                oh[cols], spairs)
            ev = subset_moments(torch.where(mask, e_vdw, 0.0), oh[rows],
                                oh[cols], spairs)
            slice_energies += torch.stack([ec, ev], dim=-1).to(torch.float64)
        # slot forces back on atoms: every real atom has one slot, so the
        # write is a permutation (pads all land on the dropped row n)
        forces = torch.zeros((n + 1, 3), dtype=dtype, device=dev)
        mine = slice(lo * capacity, hi * capacity)
        forces[slots[mine]] = f_slots[mine]
        if shard is not None:
            collectives.all_reduce(slice_energies, shard)
            collectives.all_reduce(forces, shard)
        return slice_energies, forces[:n], overflow.to(torch.int32)

    direct_space.returns_overflow = True
    return direct_space
