"""The generic engine's cell-list direct space on the min-image cell kernel.

The port of ``nonbondedslicing_tpu/ops/pallas_direct.py:649-776``
(``make_pallas_direct_space``), the second caller of the kernel that
``make_pallas_cell_kernel`` builds: a slot table per evaluation
(:func:`cell_slots`) and one ``cuda_direct.pair_cell`` launch with
energies, in reaction-field or Ewald mode.
"""

import torch

from ..parallel import collectives
from . import bonded, cuda_direct, neighbors
from .direct import EWALD_DIRECT, slice_tables


def cell_slots(positions, charge, sig_half, eps2, subsets, exclusion_list,
               box, counts, capacity):
    """The slot table of one evaluation and the cell kernel's slot tensors
    over it: (slots (n_cells * C,) int64 atom per slot, pads = N;
    (slot_pos, slot_par, slot_sub, slot_ids, slot_excl), the first five
    arguments of ``pair_cell``; overflow, the atoms beyond ``capacity``).
    Positions are taken as given (the kernel takes minimum images)."""
    n = positions.shape[0]
    n_cells = counts[0] * counts[1] * counts[2]
    table, overflow = neighbors.build_occupancy(
        neighbors.cell_ids(positions, box, counts), n, counts, capacity)
    slots = table.reshape(-1).long()
    slot_pos = (torch.cat([positions, positions.new_zeros((1, 3))])[slots]
                .reshape(n_cells, capacity, 3).transpose(1, 2).contiguous())
    slot_par, slot_sub, slot_excl = neighbors.gather_slots(
        slots, torch.stack([charge, sig_half, eps2], dim=1), subsets,
        exclusion_list, n_cells, capacity)
    return slots, (slot_pos, slot_par, slot_sub, table, slot_excl), overflow


def make_kernel_direct_space(*, mode, cutoff, counts, capacity, krf=0.0,
                             crf=0.0, use_switch=False, switch_distance=0.0,
                             ewald_alpha=0.0, ljpme=False,
                             dispersion_alpha=0.0, num_slices=1,
                             exceptions_periodic=False, exclusion_pairs=None,
                             shard=None):
    """The direct space of ``pallas_direct.py:649-776`` on ``pair_cell``.
    Same signature as ``neighbors.make_cell_direct_space``:

    f(positions, box, charge, sig_half, eps2, subsets, exclusion_list,
      slice_table, lam_coul, lam_vdw)
      -> (slice_energies (S, 2) float64, forces (N, 3), overflow int32)

    On float32 tensors each call builds the slot table
    (``neighbors.cell_ids``, ``build_occupancy``), gathers the slots'
    positions, parameters, subsets, atom indices (pads = N) and exclusion
    lists, calls ``pair_cell`` with energies in reaction-field mode
    (``mode`` CUTOFF) or Ewald mode (EWALD_DIRECT, with LJPME's dispersion
    terms when ``ljpme``), sums the moment panels in float64 into slice
    energies and writes the slot forces back onto the atoms (a
    permutation: no accumulation, so the result repeats to the bit).  CPU
    tensors run the kernel's plain twin, CUDA tensors the kernel.

    In Ewald mode the kernel fuses in the exclusion corrections of the
    excluded pairs that lie within the 27-cell neighbourhood, so the
    function carries ``handles_exclusions = True`` and callers skip their
    own correction pass; they check that every excluded pair lies there
    (``neighbors.exclusion_span`` < 1), as they check ``overflow``.

    Float64 tensors take the reference's own route
    (``pallas_direct.py:673-694``): the plain cell-list engine plus
    ``bonded.exclusion_corrections`` of ``exclusion_pairs`` (E, 2).

    ``shard`` (a ``torch.distributed`` process group) splits the cells
    among its ranks (``collectives.share``): in float32 every rank builds
    the whole slot table, launches ``pair_cell`` over its own range of
    cells (whose rows' exclusion corrections it fuses in, as the whole
    grid's call does), sums its moment panels in float64 and the panels'
    sums over the group, and writes its slots' forces back into zeros and
    sums them over the group: the forces equal the unsharded call's to the
    bit, the energies to rounding.  Float64 takes the sharded cell list and
    adds the exclusion corrections once, after its sums.  Every rank
    returns the same full result.
    """
    ewald = mode == EWALD_DIRECT
    base = neighbors.make_cell_direct_space(
        mode=mode, cutoff=cutoff, counts=counts, capacity=capacity, krf=krf,
        crf=crf, use_switch=use_switch, switch_distance=switch_distance,
        ewald_alpha=ewald_alpha, ljpme=ljpme,
        dispersion_alpha=dispersion_alpha, num_slices=num_slices,
        shard=shard)
    if exclusion_pairs is None:
        exclusion_pairs = torch.zeros((0, 2), dtype=torch.int64)
    pairs_cache = {}

    def direct_space(positions, box, charge, sig_half, eps2, subsets,
                     exclusion_list, slice_table, lam_coul, lam_vdw):
        dev = positions.device
        if positions.dtype != torch.float32:
            e, f, overflow = base(positions, box, charge, sig_half, eps2,
                                  subsets, exclusion_list, slice_table,
                                  lam_coul, lam_vdw)
            if ewald:
                if dev not in pairs_cache:
                    pairs_cache[dev] = torch.as_tensor(exclusion_pairs,
                                                       device=dev)
                e_x, f_x = bonded.exclusion_corrections(
                    positions, box, pairs_cache[dev], charge, sig_half, eps2,
                    subsets, slice_table, lam_coul, lam_vdw,
                    alpha=ewald_alpha,
                    periodic_exceptions=exceptions_periodic, ljpme=ljpme,
                    dispersion_alpha=dispersion_alpha,
                    num_slices=num_slices, num_particles=positions.shape[0])
                e = e + e_x
                f = f + f_x
            return e, f, overflow
        n = positions.shape[0]
        sl_tab, spairs = slice_tables(slice_table, dev)
        cfg = cuda_direct.PairConfig(
            counts=tuple(counts), capacity=capacity, nsub=sl_tab.shape[0],
            emax=exclusion_list.shape[1],
            mode=(cuda_direct.MODE_EWALD if ewald
                  else cuda_direct.MODE_REACTION_FIELD),
            cutoff=cutoff, krf=krf, crf=crf, ewald_alpha=ewald_alpha,
            use_switch=bool(use_switch), switch_distance=switch_distance,
            exceptions_periodic=bool(exceptions_periodic), ljpme=ljpme,
            dispersion_alpha=dispersion_alpha)
        slots, tensors, overflow = cell_slots(
            positions, charge, sig_half, eps2, subsets, exclusion_list, box,
            counts, capacity)
        lo, hi = (0, cfg.n_cells) if shard is None else collectives.share(
            cfg.n_cells, shard)
        m = torch.zeros((2, cfg.nsub, cfg.nsub), dtype=torch.float64,
                        device=dev)
        forces = torch.zeros((n + 1, 3), dtype=positions.dtype, device=dev)
        if hi > lo:
            forces_s, moments = cuda_direct.pair_cell(
                *tensors, lam_coul[sl_tab].contiguous(),
                lam_vdw[sl_tab].contiguous(), box.contiguous(), cfg, True, n,
                cells=(lo, hi - lo))
            m = torch.sum(moments.to(torch.float64), dim=0)
            forces[slots[lo * capacity:hi * capacity]] = (
                forces_s.transpose(1, 2).reshape(-1, 3))
        if shard is not None:
            collectives.all_reduce(m, shard)
            collectives.all_reduce(forces, shard)
        a, b = spairs[:, 0], spairs[:, 1]
        # every pair is met from both sides with weight 1/2
        slice_energies = torch.where(a == b, m[:, a, a],
                                     m[:, a, b] + m[:, b, a]).T
        return (slice_energies.contiguous(), forces[:n],
                overflow.to(torch.int32))

    direct_space.returns_overflow = True
    direct_space.handles_exclusions = ewald
    return direct_space
