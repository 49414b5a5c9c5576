"""Fused production engine: one slot table feeding direct + reciprocal space.

``prepare`` builds the slot table (a stable sort of atoms by cell) and
everything that depends only on the assignment of atoms to cells: per-slot
charge, sigma/2, 2*sqrt(eps), subset and atom index, the slot exclusion
table, the far-away pad offsets and the rebuild positions.  MD callers
reuse it for K steps under a skin guard.

``apply`` does the per-step work: one gather of positions into slot order,
the pair kernel (``ops/cuda_direct.py``), sliced PME through the spread and
interpolation kernels of the chosen pipeline (``ops/cuda_pme.py``: whole
grids, or brick windows with ``pme_pipeline="grid"``), self/plasma
energies, the water-triangle exclusion corrections, 1-4 exceptions, the
dispersion correction and one slot->atom force unsort.  It also returns ``aux``: the
cell-capacity overflow count and the squared max displacement since
``prepare``.

The pair kernel is chosen as the JAX package's fused engine chooses it
(its ``ops/fused.py:189-241``).  Under PME, when the exclusions are not
rigid-water triangles or the exceptions are periodic, the min-image cell
kernel (``pair_cell``) takes raw positions and fuses the Ewald exclusion
corrections in.  Otherwise the column kernel (``pair_column``) takes
positions kept in the prepare-time image, with periodic shifts per
neighbour cell, and the water-triangle corrections run as rows.

Validity conditions (enforced by callers via aux + static checks):
* aux["overflow"] == 0
* aux["maxdisp2"] <= (skin/2)^2, skin = min cell width - cutoff, capped at
  two PME grid spacings
* runtime box == plan.box0: the cell grid and the PME convolution kernel
  are built once from it

Supported: CutoffPeriodic and PME.  Ewald and LJPME raise
NotImplementedError.
"""

import numpy as np
import torch

from ..models.force import NonbondedForce
from ..utils.constants import COUL, EPSILON0, ONE_4PI_EPS0, SQRT_PI, VDW
from ..utils.indexing import slice_subsets
from . import bonded, cuda_direct, cuda_pme, neighbors, params, pme, pme_bricks
from .geometry import box_volume, recip_box_vectors


def _brick_counts(counts, capacity=None, raw_grid=None):
    """PME brick counts per axis, as the JAX package chooses them: at most
    ~6 bricks per axis, one brick per cell when a brick's interpolation
    plane would exceed ~4 MB.  The bricks fix the cell-aligned PME grid
    size of both pipelines, and the window pipeline
    (``pme_pipeline="grid"``) spreads and interpolates brick by brick."""
    bricks = []
    for nc in counts:
        divs = [d for d in range(1, nc + 1) if nc % d == 0 and d <= 6]
        bricks.append(max(divs) if divs else nc)
    if capacity is not None and raw_grid is not None:
        cells_per_brick = 1
        for nc, d in zip(counts, bricks):
            cells_per_brick *= nc // d
        c_brick = capacity * cells_per_brick
        wy = raw_grid[1] // bricks[1] + 6
        wz = raw_grid[2] // bricks[2] + 6
        if c_brick * wy * wz * 4 > 4 * 1024 * 1024:
            return tuple(counts)
    return tuple(bricks)


def fused_config(plan, cell_capacity=None, target_skin=0.0):
    """Static sizing for the fused engine, or None when not applicable
    (non-periodic / too coarse a box for a cell list)."""
    if plan.box0 is None or plan.method in (NonbondedForce.NoCutoff,
                                            NonbondedForce.CutoffNonPeriodic):
        return None
    cfg = neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                     plan.num_particles,
                                     target_skin=target_skin)
    if cfg is None:
        return None
    counts, capacity = cfg
    if cell_capacity is not None:
        capacity = int(cell_capacity)
    widths = neighbors._perpendicular_widths(plan.box0) / np.asarray(counts)
    skin = float(np.min(widths)) - plan.cutoff
    is_pme = plan.method in (NonbondedForce.PME, NonbondedForce.LJPME)
    bricks = _brick_counts(counts, capacity=capacity,
                           raw_grid=plan.pme_grid if is_pme else None)
    out = dict(counts=counts, capacity=capacity, skin=skin, bricks=bricks)
    if is_pme:
        grid = pme_bricks.aligned_grid(plan.pme_grid, bricks)
        out["pme_grid"] = grid
        out["pme_moduli"] = pme.bspline_moduli(grid, order=plan.pme_order)
        box_diag = np.diag(np.asarray(plan.box0, dtype=np.float64))
        spacing = float(np.min(box_diag / np.asarray(grid)))
        out["skin"] = min(out["skin"], 2.0 * spacing)  # +-1 point drift margin
    return out


def make_fused_engine(plan, *, cell_capacity=None, target_skin=0.0,
                      energies=True, pme_pipeline="stencil"):
    """Build (prepare, apply, config) for the fused engine, or None when the
    plan has no cell list (non-periodic or too small a box).  ``config`` is
    :func:`fused_config`'s dict plus ``"pair"``, the pair kernel's
    :class:`~.cuda_direct.PairConfig`.

    prepare(positions, box, gvals, data) -> state
    apply(positions, box, gvals, data, state)
        -> (slice_energies (S, 2) float64 or None, forces (N, 3), aux)

    ``energies=False`` builds the force-only variant for MD inner steps: the
    pair kernel skips its energies and ``apply`` returns None for the slice
    energies.  The PME convolution kernel is computed once per device and
    dtype from ``plan.box0``.

    ``pme_pipeline`` chooses how the reciprocal forces are computed
    (``ops/cuda_pme.py``): ``"stencil"`` spreads into and interpolates from
    whole grids; ``"grid"`` is the brick-window pipeline (spread windows,
    fold, transforms, extract, interpolate from windows) on slots regrouped
    brick-major with ``config["bricks"]``.  It needs a PME plan and at
    least 6 PME grid points per brick and axis, and raises ValueError
    otherwise.  It is kept for parity with the JAX package's
    ``NBS_PME_PIPELINE=grid``; ``"stencil"`` is the recommended setting.
    """
    method = plan.method
    if method == NonbondedForce.Ewald:
        raise NotImplementedError(
            "fused engine: bare Ewald is not ported yet (ROADMAP A9)")
    if method == NonbondedForce.LJPME:
        raise NotImplementedError(
            "fused engine: LJPME is not ported yet (ROADMAP A10)")
    cfg = fused_config(plan, cell_capacity, target_skin=target_skin)
    if cfg is None:
        return None
    is_pme = method == NonbondedForce.PME
    if pme_pipeline not in cuda_pme.PIPELINES:
        raise ValueError(f"pme_pipeline must be one of {cuda_pme.PIPELINES}, "
                         f"got {pme_pipeline!r}")
    use_windows = pme_pipeline == "grid"
    if use_windows and not is_pme:
        raise ValueError("pme_pipeline=\"grid\" needs a PME plan: this plan "
                         "has no reciprocal part to run through it")
    bricks = cfg["bricks"]
    if use_windows:
        pme_bricks.check_two_piece_windows(cfg["pme_grid"], bricks)
    # the min-image cell kernel with fused exclusion corrections
    use_cell = is_pme and (plan.exceptions_periodic
                           or bonded.triangle_exclusions(
                               plan.exclusion_pairs,
                               plan.num_particles) is None)
    counts = cfg["counts"]
    capacity = cfg["capacity"]
    n_cells = counts[0] * counts[1] * counts[2]
    n = plan.num_particles
    nsub = plan.num_subsets
    nslices = plan.num_slices
    slice_pairs = np.asarray(slice_subsets(nsub))
    slice_table = np.asarray(plan.slice_table)
    emax = plan.exclusion_list.shape[1]
    eps_rf = plan.rf_dielectric
    pair_cfg = cuda_direct.PairConfig(
        counts=counts, capacity=capacity, nsub=nsub, emax=emax,
        mode=(cuda_direct.MODE_EWALD if is_pme
              else cuda_direct.MODE_REACTION_FIELD),
        cutoff=plan.cutoff,
        krf=plan.cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0),
        crf=(1.0 / plan.cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0),
        ewald_alpha=plan.ewald_alpha, use_switch=bool(plan.use_switch),
        switch_distance=plan.switch_distance,
        exceptions_periodic=bool(plan.exceptions_periodic))
    cfg["pair"] = pair_cfg
    disp_correction = method in (NonbondedForce.CutoffPeriodic,
                                 NonbondedForce.PME)
    # pad-slot offset base: clears the box (hence every real atom and every
    # periodic image shift) by a wide margin
    pad_base = 64.0 * (1.0 + float(np.sum(np.abs(np.asarray(plan.box0)))))
    eterm_cache = {}
    index_cache = {}

    def _indices(dev):
        """Index tables on ``dev``, copied from the host once: a pageable
        host->device copy on every step would stall the launch queue."""
        if dev not in index_cache:
            index_cache[dev] = dict(
                sl_tab=torch.as_tensor(slice_table, dtype=torch.int64,
                                       device=dev),
                lam_src=torch.as_tensor(plan.lam_source, dtype=torch.int64,
                                        device=dev))
        return index_cache[dev]

    def _eterm(box):
        key = (box.device, box.dtype)
        if key not in eterm_cache:
            eterm_cache[key] = torch.as_tensor(pme.coulomb_eterm_np(
                cfg["pme_grid"], cfg["pme_moduli"], plan.box0,
                plan.ewald_alpha), device=box.device).to(box.dtype)
        return eterm_cache[key]

    def prepare(positions, box, gvals, data):
        """Slot table + assignment-static tensors (rebuild every K steps)."""
        dtype = positions.dtype
        dev = positions.device
        subsets = data["subsets"]
        charge, sig_half, eps2 = params.particle_params(data, gvals)
        cell = neighbors.cell_ids(positions, box, counts)
        table, overflow = neighbors.build_occupancy(cell, n, counts, capacity)
        slots = table.reshape(-1).long()
        if use_cell:
            # minimum image in the kernel: positions stay as given
            pos0w = positions
        else:
            # canonical in-box wrap consistent with the cell assignment;
            # apply() keeps drifted atoms in THIS image for the whole reuse
            # window
            frac0 = positions @ recip_box_vectors(box)
            pos0w = positions - torch.floor(frac0) @ box

        par = torch.stack([charge, sig_half, eps2], dim=1)
        par_p = torch.cat([par, par.new_zeros((1, 3))])
        slot_par = par_p[slots].reshape(n_cells, capacity, 3).transpose(1, 2)
        sub_p = torch.cat([subsets, subsets.new_zeros(1)])
        slot_sub = sub_p[slots].reshape(n_cells, capacity).to(torch.int32)
        excl_p = torch.cat([data["exclusion_list"],
                            data["exclusion_list"].new_full((1, emax), -1)])
        sexcl = excl_p[slots].reshape(n_cells, capacity, emax).transpose(1, 2)
        # inverse slot map: atom -> its (unique) slot, so the per-step
        # slot->atom force unsort is a gather.  Pad slots all map to the
        # dropped entry n; an atom lost to a cell overflow reads slot 0,
        # which no caller uses (the overflow guard raises).
        inv_slots = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        inv_slots[slots] = torch.arange(slots.shape[0], device=dev)
        # unique far-away x offsets for pad slots: every pad sits > cutoff
        # from every other slot, so the column kernel needs no pad mask (the
        # cell kernel masks pads by atom index)
        padfix = torch.where(
            slots == n,
            pad_base + 64.0 * torch.arange(slots.shape[0], device=dev,
                                           dtype=torch.float32),
            0.0).to(dtype).reshape(n_cells, 1, capacity)
        state = dict(
            slots=slots, inv_slots=inv_slots[:n], table=table,
            slot_par=slot_par.contiguous(),
            slot_q=slot_par[:, 0].contiguous(),
            slot_sub=slot_sub, sexcl=sexcl.to(torch.int32).contiguous(),
            padfix3=torch.cat([padfix, padfix.new_zeros(
                (n_cells, 2, capacity))], dim=1),
            pos0=positions, pos0w=pos0w, charge=charge,
            overflow=overflow)
        if use_windows:
            # brick-major charge and subset for the window kernels
            state["slot_q_b"] = pme_bricks.cells_to_bricks(
                state["slot_q"][:, None], counts, bricks)[:, 0].contiguous()
            state["slot_sub_b"] = pme_bricks.cells_to_bricks(
                slot_sub[:, None], counts, bricks)[:, 0].contiguous()
        if is_pme and not use_cell:
            sl_tab = _indices(dev)["sl_tab"]
            sub3 = subsets.reshape(n // 3, 3)
            state["pair_slices"] = torch.stack(
                [sl_tab[sub3[:, 0], sub3[:, 1]], sl_tab[sub3[:, 0], sub3[:, 2]],
                 sl_tab[sub3[:, 1], sub3[:, 2]]], dim=1)
        return state

    def apply(positions, box, gvals, data, state):
        dev = positions.device
        idx = _indices(dev)
        lam = params.slice_lambdas(idx["lam_src"], gvals)
        lam_c = lam[:, COUL]
        lam_v = lam[:, VDW]
        lam_c_nn = lam_c[idx["sl_tab"]].contiguous()
        charge = state["charge"]

        if use_cell:
            pos_in = positions
        else:
            # keep each atom in its prepare-time image: wrapped prepare
            # position + raw drift (re-wrapping would teleport an atom that
            # crosses a box face away from its frozen cell and drop its
            # pairs)
            pos_in = state["pos0w"] + (positions - state["pos0"])
        pos_p = torch.cat([pos_in, pos_in.new_zeros((1, 3))])
        slot_pos = (pos_p[state["slots"]].reshape(n_cells, capacity, 3)
                    .transpose(1, 2) + state["padfix3"]).contiguous()
        pair_args = (slot_pos, state["slot_par"], state["slot_sub"],
                     state["table"], state["sexcl"], lam_c_nn,
                     lam_v[idx["sl_tab"]].contiguous(), box, pair_cfg,
                     energies, n)
        pair = cuda_direct.pair_cell if use_cell else cuda_direct.pair_column
        slot_f, moments = pair(*pair_args)

        slice_e = None
        if energies:
            slice_e = torch.zeros((nslices, 2), dtype=torch.float64,
                                  device=dev)
            # the moment panels (one per cell or per block) summed in f64
            m = torch.sum(moments.to(torch.float64), dim=0)  # (2, nsub, nsub)
            a = slice_pairs[:, 0]
            b = slice_pairs[:, 1]
            both = m[:, a, b] + m[:, b, a]
            slice_e += torch.where(torch.as_tensor(a == b, device=dev),
                                   m[:, a, a], both).T

        if is_pme:
            alpha = plan.ewald_alpha
            if energies:
                subsets = data["subsets"]
                onehot64 = torch.nn.functional.one_hot(
                    subsets, nsub).to(torch.float64)
                charge64 = charge.to(torch.float64)
                diag_ids = torch.as_tensor(
                    [s * (s + 3) // 2 for s in range(nsub)], device=dev)
                # self energy (ReferenceSlicedLJCoulombIxn.cpp:203-213)
                self_coul = -ONE_4PI_EPS0 * charge64 * charge64 * alpha / SQRT_PI
                slice_e[diag_ids, COUL] += self_coul @ onehot64
                # neutralizing plasma (cpp:214-221)
                volume = box_volume(box).to(torch.float64)
                q_sub = charge64 @ onehot64
                factor = (-1.0 / (4.0 * alpha * alpha)) / (2.0 * EPSILON0
                                                          * volume)
                w = torch.as_tensor(np.where(slice_pairs[:, 0]
                                             == slice_pairs[:, 1], 1.0, 2.0),
                                    device=dev)
                slice_e[:, COUL] += (w * q_sub[slice_pairs[:, 0]]
                                     * q_sub[slice_pairs[:, 1]] * factor)
            pme_args = dict(grid_shape=cfg["pme_grid"], eterm=_eterm(box),
                            slice_subset_pairs=slice_pairs, energies=energies)
            if use_windows:
                e_k, f_kb = cuda_pme.pme_reciprocal(
                    pme_bricks.cells_to_bricks(slot_pos, counts,
                                               bricks).contiguous(),
                    state["slot_q_b"], state["slot_sub_b"], box, lam_c_nn,
                    pipeline="grid", bricks=bricks, **pme_args)
                f_k = pme_bricks.bricks_to_cells(
                    f_kb.transpose(1, 2), counts, bricks).transpose(1, 2)
            else:
                e_k, f_k = cuda_pme.pme_reciprocal(
                    slot_pos, state["slot_q"], state["slot_sub"], box,
                    lam_c_nn, **pme_args)
            slot_f = slot_f + f_k
            if energies:
                slice_e[:, COUL] += e_k

        # single slot->atom unsort: gather by the inverse permutation
        forces = slot_f.transpose(1, 2).reshape(-1, 3)[state["inv_slots"]]

        if is_pme and not use_cell:
            e_x, f_x = bonded.exclusion_corrections_rows(
                positions, charge, state["pair_slices"], lam_c,
                alpha=plan.ewald_alpha, num_slices=nslices)
            forces = forces + f_x
            if energies:
                slice_e += e_x

        if data["nb14_atoms"].shape[0]:
            sigma14, four_eps14, qq14 = params.nb14_params(data, gvals)
            e_14, f_14 = bonded.nb14_interactions(
                positions, box, data["nb14_atoms"], sigma14, four_eps14, qq14,
                data["nb14_slice"], lam_c, lam_v,
                periodic=plan.exceptions_periodic, num_slices=nslices,
                num_particles=n)
            forces = forces + f_14
            if energies:
                slice_e += e_14

        if energies and disp_correction:
            # per-slice long-range dispersion correction / volume
            slice_e[:, VDW] += (data["dispersion_coefficients"].to(torch.float64)
                                / box_volume(box).to(torch.float64))

        disp = positions - state["pos0"]
        maxdisp2 = torch.max(torch.sum(disp * disp, dim=-1))
        aux = dict(overflow=state["overflow"], maxdisp2=maxdisp2)
        return slice_e, forces, aux

    return prepare, apply, cfg
