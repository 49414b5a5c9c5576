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
dispersion correction and one slot->atom force unsort.  Under LJPME the pair
kernel adds the real-space dispersion terms, the reciprocal part runs a
second time on the dispersion grid with per-slot C6 and the vdW lambdas,
the exclusion corrections back out the excluded pairs' dispersion terms,
and the diagonal slices get the dispersion self energy (the JAX package's
``ops/fused.py:439-484``); there is no volume dispersion correction.
Under bare Ewald the pair kernel runs in Ewald mode as under PME, and the
reciprocal part is the k-sum of ``ops/ewald.ewald_reciprocal`` on the
atoms over the plan's half-space k-vectors, its forces added after the
unsort (the JAX package's ``ops/fused.py:485-499``).  ``apply`` also
returns ``aux``: the cell-capacity overflow count, the squared max
displacement since ``prepare`` and, on the cell kernel's path, the span of
the excluded pairs.

The pair kernel is chosen as the JAX package's fused engine chooses it
(its ``ops/fused.py:189-241``).  Under Ewald, PME and LJPME, when the
exclusions are not rigid-water triangles or the exceptions are periodic,
the min-image cell kernel (``pair_cell``) takes raw positions and fuses
the Ewald exclusion corrections in.  Otherwise the column kernel (``pair_column``) takes
positions kept in the prepare-time image, with periodic shifts per
neighbour cell, and the water-triangle corrections run as rows.

Validity conditions (enforced by callers via aux + static checks):
* aux["overflow"] == 0
* aux["maxdisp2"] <= (skin/2)^2, skin = min cell width - cutoff, capped at
  two grid spacings of the PME grid and (LJPME) of the dispersion grid
* aux["excl_span"] < 1 on the cell kernel's path: every excluded pair lies
  within one cell width per axis (``neighbors.exclusion_span``), so that
  the kernel, which corrects the excluded pairs of the 27-cell
  neighbourhood, meets it
* runtime box == plan.box0: the cell grid and the PME convolution kernels
  are built once from it

Supported: CutoffPeriodic, Ewald, PME and LJPME.
"""

import numpy as np
import torch

from ..models.force import NonbondedForce
from ..runtime import profiling
from ..utils.constants import COUL, EPSILON0, ONE_4PI_EPS0, SQRT_PI, VDW
from ..utils.indexing import slice_subsets
from . import (bonded, cuda_direct, cuda_pme, ewald, neighbors, params, pme,
               pme_bricks)
from .geometry import box_volume, recip_box_vectors
from .plan import EWALD_METHODS


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
        if plan.method == NonbondedForce.LJPME:
            dgrid = pme_bricks.aligned_grid(plan.dispersion_grid, bricks)
            out["dispersion_grid"] = dgrid
            out["dpme_moduli"] = pme.bspline_moduli(dgrid,
                                                    order=plan.pme_order)
            dspacing = float(np.min(box_diag / np.asarray(dgrid)))
            out["skin"] = min(out["skin"], 2.0 * dspacing)
    return out


def uses_cell_kernel(plan):
    """Whether the plan's pair stage takes the min-image cell kernel
    (``pair_cell``, the Ewald exclusion corrections fused in): under Ewald,
    PME and LJPME when the exclusions are not rigid-water triangles or the
    exceptions are periodic; else the column kernel (``pair_column``)."""
    return plan.method in EWALD_METHODS and (
        plan.exceptions_periodic
        or bonded.triangle_exclusions(plan.exclusion_pairs,
                                      plan.num_particles) is None)


def pair_config(plan, counts, capacity):
    """The pair kernels' :class:`~.cuda_direct.PairConfig` of ``plan`` on
    a grid of ``counts`` cells of ``capacity`` slots."""
    eps_rf = plan.rf_dielectric
    return cuda_direct.PairConfig(
        counts=tuple(counts), capacity=int(capacity), nsub=plan.num_subsets,
        emax=plan.exclusion_list.shape[1],
        mode=(cuda_direct.MODE_EWALD if plan.method in EWALD_METHODS
              else cuda_direct.MODE_REACTION_FIELD),
        cutoff=plan.cutoff,
        krf=plan.cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0),
        crf=(1.0 / plan.cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0),
        ewald_alpha=plan.ewald_alpha, use_switch=bool(plan.use_switch),
        switch_distance=plan.switch_distance,
        exceptions_periodic=bool(plan.exceptions_periodic),
        ljpme=plan.method == NonbondedForce.LJPME,
        dispersion_alpha=plan.dispersion_alpha)


def pad_base(box0):
    """The pad slots' x offset base: clears the box (hence every real atom
    and every periodic image shift) by a wide margin."""
    return 64.0 * (1.0 + float(np.sum(np.abs(np.asarray(box0)))))


def slot_state(positions, box, gvals, data, *, counts, capacity, n,
               cell_kernel, pad_offset):
    """The slot table of ``positions`` on a grid of ``counts`` cells of
    ``capacity`` slots (a stable sort of atoms by cell) and what depends
    only on the assignment of atoms to cells: per-slot charge, sigma/2,
    2*sqrt(eps) and subset, the slot exclusion table, the inverse slot map,
    the far-away pad offsets (from ``pad_offset``, :func:`pad_base`), the
    rebuild positions (``pos0``, and ``pos0w``: the image the column kernel
    takes, where the cell kernel, ``cell_kernel``, takes them as given),
    the atoms' parameters and the overflow count."""
    n_cells = counts[0] * counts[1] * counts[2]
    dev = positions.device
    charge, sig_half, eps2 = params.particle_params(data, gvals)
    cell = neighbors.cell_ids(positions, box, counts)
    table, overflow = neighbors.build_occupancy(cell, n, counts, capacity)
    slots = table.reshape(-1).long()
    if cell_kernel:
        # minimum image in the kernel: positions stay as given
        pos0w = positions
    else:
        # canonical in-box wrap consistent with the cell assignment; the
        # steps keep drifted atoms in THIS image for the whole reuse window
        frac0 = positions @ recip_box_vectors(box)
        pos0w = positions - torch.floor(frac0) @ box

    slot_par, slot_sub, sexcl = neighbors.gather_slots(
        slots, torch.stack([charge, sig_half, eps2], dim=1), data["subsets"],
        data["exclusion_list"], n_cells, capacity)
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
        pad_offset + 64.0 * torch.arange(slots.shape[0], device=dev,
                                         dtype=torch.float32),
        0.0).to(positions.dtype).reshape(n_cells, 1, capacity)
    return dict(
        slots=slots, inv_slots=inv_slots[:n], table=table,
        slot_par=slot_par, slot_q=slot_par[:, 0].contiguous(),
        slot_sub=slot_sub, sexcl=sexcl,
        padfix3=torch.cat([padfix, padfix.new_zeros(
            (n_cells, 2, capacity))], dim=1),
        pos0=positions, pos0w=pos0w, charge=charge, sig_half=sig_half,
        eps2=eps2, overflow=overflow)


def slot_positions(positions, state, cell_kernel):
    """(n_cells, 3, C) positions in slot order for the pair kernels: as
    given for the cell kernel; for the column kernel each atom kept in its
    prepare-time image (the wrapped rebuild position plus the raw drift:
    re-wrapping would teleport an atom that crosses a box face away from
    its frozen cell and drop its pairs), pads moved far away."""
    if cell_kernel:
        pos_in = positions
    else:
        pos_in = state["pos0w"] + (positions - state["pos0"])
    n_cells, _, capacity = state["padfix3"].shape
    pos_p = torch.cat([pos_in, pos_in.new_zeros((1, 3))])
    return (pos_p[state["slots"]].reshape(n_cells, capacity, 3)
            .transpose(1, 2) + state["padfix3"]).contiguous()


def unsort(slot_f, inv_slots):
    """(N, 3) atom forces of the cell-major slot forces ``slot_f``
    (n_cells, 3, C): a gather by the inverse slot map (``slot_state``'s
    ``inv_slots``)."""
    return slot_f.transpose(1, 2).reshape(-1, 3)[inv_slots]


def water_pair_slices(subsets, sl_tab):
    """(M, 3) slice ids of the local pairs 0-1, 0-2, 1-2 of the waters
    (molecule m = atoms 3m..3m+2): the exclusion rows' ``pair_slices``
    (``bonded.exclusion_corrections_rows``); ``sl_tab`` the slice table as
    an int64 tensor."""
    sub3 = subsets.reshape(-1, 3)
    return torch.stack([sl_tab[sub3[:, 0], sub3[:, 1]],
                        sl_tab[sub3[:, 0], sub3[:, 2]],
                        sl_tab[sub3[:, 1], sub3[:, 2]]], dim=1)


def moment_slice_energies(moments, slice_pairs, nslices):
    """(S, 2) float64 slice energies [Coulomb, vdW] of a pair kernel's
    moment panels (one per cell or per block) summed in float64: m[a, a]
    on the diagonal slices, m[a, b] + m[b, a] off it (``slice_pairs``
    numpy)."""
    dev = moments.device
    slice_e = torch.zeros((nslices, 2), dtype=torch.float64, device=dev)
    m = torch.sum(moments.to(torch.float64), dim=0)  # (2, nsub, nsub)
    a = slice_pairs[:, 0]
    b = slice_pairs[:, 1]
    both = m[:, a, b] + m[:, b, a]
    slice_e += torch.where(torch.as_tensor(a == b, device=dev), m[:, a, a],
                           both).T
    return slice_e


def add_self_energies(slice_e, plan, charge, sig_half, eps2, subsets, box,
                      slice_pairs):
    """Add the Ewald family's self and neutralizing-plasma energies (and,
    under LJPME, the dispersion self energy) of the atoms to the (S, 2)
    float64 slice energies ``slice_e`` in place
    (ReferenceSlicedLJCoulombIxn.cpp:203-221; the JAX package's
    ``ops/fused.py:439-444``); ``slice_pairs`` numpy."""
    dev = slice_e.device
    nsub = plan.num_subsets
    alpha = plan.ewald_alpha
    onehot64 = torch.nn.functional.one_hot(subsets, nsub).to(torch.float64)
    charge64 = charge.to(torch.float64)
    diag_ids = torch.as_tensor([s * (s + 3) // 2 for s in range(nsub)],
                               device=dev)
    # self energy (ReferenceSlicedLJCoulombIxn.cpp:203-213)
    self_coul = -ONE_4PI_EPS0 * charge64 * charge64 * alpha / SQRT_PI
    slice_e[diag_ids, COUL] += self_coul @ onehot64
    # neutralizing plasma (cpp:214-221)
    volume = box_volume(box).to(torch.float64)
    q_sub = charge64 @ onehot64
    factor = (-1.0 / (4.0 * alpha * alpha)) / (2.0 * EPSILON0 * volume)
    w = torch.as_tensor(np.where(slice_pairs[:, 0] == slice_pairs[:, 1],
                                 1.0, 2.0), device=dev)
    slice_e[:, COUL] += (w * q_sub[slice_pairs[:, 0]]
                         * q_sub[slice_pairs[:, 1]] * factor)
    if plan.method == NonbondedForce.LJPME:
        self_vdw = (plan.dispersion_alpha ** 6 * 64.0
                    * sig_half.to(torch.float64) ** 6
                    * eps2.to(torch.float64) ** 2 / 12.0)
        slice_e[diag_ids, VDW] += self_vdw @ onehot64


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

    ``apply(..., slot_forces=True)`` (where ``config["slot_forces"]``:
    force-only PME on the column kernel, no 1-4 exceptions; it raises
    ValueError elsewhere) stops before the atom-order terms: it returns the cell-major slot forces of the pair kernel and the
    reciprocal part, summed, (n_cells, 3, C), in place of the atom forces,
    and ``aux["lam"]``, the (S, 2) slice lambdas; the unsort and the
    exclusion rows are then the caller's (``runtime/water_tail.py``).

    ``pme_pipeline`` chooses how the reciprocal forces are computed
    (``ops/cuda_pme.py``): ``"stencil"`` spreads into and interpolates from
    whole grids; ``"grid"`` is the brick-window pipeline (spread windows,
    fold, transforms, extract, interpolate from windows) on slots regrouped
    brick-major with ``config["bricks"]``.  It needs a PME plan and at
    least 6 grid points per brick and axis of the PME grid and (LJPME) of
    the dispersion grid, and raises ValueError otherwise, where the JAX
    package would fall back to its "blocked" pipeline.  It is kept for
    parity with the JAX package's ``NBS_PME_PIPELINE=grid``; ``"stencil"``
    is the recommended setting.
    """
    method = plan.method
    cfg = fused_config(plan, cell_capacity, target_skin=target_skin)
    if cfg is None:
        return None
    ljpme = method == NonbondedForce.LJPME
    is_pme = method in (NonbondedForce.PME, NonbondedForce.LJPME)
    bare_ewald = method == NonbondedForce.Ewald
    is_ewald_family = is_pme or bare_ewald
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
        if ljpme:
            pme_bricks.check_two_piece_windows(cfg["dispersion_grid"], bricks)
    # the min-image cell kernel with fused exclusion corrections
    use_cell = uses_cell_kernel(plan)
    # the plans whose atom-order terms are the water exclusion rows alone
    cfg["slot_forces"] = (not energies and not use_cell
                          and method == NonbondedForce.PME
                          and len(plan.nb14_atoms) == 0)
    counts = cfg["counts"]
    capacity = cfg["capacity"]
    n = plan.num_particles
    nsub = plan.num_subsets
    nslices = plan.num_slices
    slice_pairs = np.asarray(slice_subsets(nsub))
    slice_table = np.asarray(plan.slice_table)
    pair_cfg = pair_config(plan, counts, capacity)
    cfg["pair"] = pair_cfg
    disp_correction = method in (NonbondedForce.CutoffPeriodic,
                                 NonbondedForce.Ewald, NonbondedForce.PME)
    pad_offset = pad_base(plan.box0)
    # the cell kernel corrects the excluded pairs of the 27-cell
    # neighbourhood only: their minimum-image span is measured in cell
    # widths (the JAX Context's refusal, models/context.py:366-392)
    excl_pairs = np.asarray(plan.exclusion_pairs,
                            dtype=np.int64).reshape(-1, 2)
    # the whole-grid spread's slot groups (cells, or the window pipeline's
    # bricks) and its neighbour radius on each PME grid
    lattice = bricks if use_windows else counts
    spread_radius = {
        key: cuda_pme.spread_radius(cfg[key], lattice, cfg["skin"], plan.box0)
        for key in ("pme_grid", "dispersion_grid") if key in cfg}
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
                                        device=dev),
                excl_i=torch.as_tensor(excl_pairs[:, 0], device=dev),
                excl_j=torch.as_tensor(excl_pairs[:, 1], device=dev),
                spairs=torch.as_tensor(slice_pairs, device=dev),
                kvec=(torch.as_tensor(
                    ewald.half_space_kvectors(plan.ewald_kmax), device=dev)
                    if bare_ewald else None))
        return index_cache[dev]

    def _eterm(box, dispersion=False):
        """The convolution kernel of the PME (or the dispersion) grid."""
        key = (box.device, box.dtype, dispersion)
        if key not in eterm_cache:
            if dispersion:
                e = pme.dispersion_eterm_np(
                    cfg["dispersion_grid"], cfg["dpme_moduli"], plan.box0,
                    plan.dispersion_alpha)
            else:
                e = pme.coulomb_eterm_np(cfg["pme_grid"], cfg["pme_moduli"],
                                         plan.box0, plan.ewald_alpha)
            eterm_cache[key] = torch.as_tensor(e, device=box.device).to(
                box.dtype)
        return eterm_cache[key]

    def prepare(positions, box, gvals, data):
        """Slot table + assignment-static tensors (rebuild every K steps)."""
        with profiling.span("nbs.engine.direct"):
            return _prepare(positions, box, gvals, data)

    def _prepare(positions, box, gvals, data):
        dev = positions.device
        state = slot_state(positions, box, gvals, data, counts=counts,
                           capacity=capacity, n=n, cell_kernel=use_cell,
                           pad_offset=pad_offset)
        slot_par = state["slot_par"]
        if ljpme:
            # C6 of every slot, the dispersion grid's weight (0 on pads)
            state["slot_c6"] = (8.0 * slot_par[:, 1] ** 3
                                * slot_par[:, 2]).contiguous()
        if use_windows:
            # brick-major weights and subset for the window kernels
            for key in ("slot_q", "slot_c6", "slot_sub"):
                if key in state:
                    state[key + "_b"] = pme_bricks.cells_to_bricks(
                        state[key][:, None], counts, bricks)[:, 0].contiguous()
        if use_cell:
            idx = _indices(dev)
            state["excl_span"] = neighbors.exclusion_span(
                positions, box, idx["excl_i"], idx["excl_j"], counts)
        if is_ewald_family and not use_cell:
            state["pair_slices"] = water_pair_slices(
                data["subsets"], _indices(dev)["sl_tab"])
        return state

    def apply(positions, box, gvals, data, state, slot_forces=False):
        if slot_forces and not cfg["slot_forces"]:
            raise ValueError("apply(slot_forces=True) takes force-only PME "
                             "on the column kernel without 1-4 exceptions")
        dev = positions.device
        idx = _indices(dev)
        lam = params.slice_lambdas(idx["lam_src"], gvals)
        lam_c = lam[:, COUL]
        lam_v = lam[:, VDW]
        lam_c_nn = lam_c[idx["sl_tab"]].contiguous()
        lam_v_nn = lam_v[idx["sl_tab"]].contiguous()
        charge = state["charge"]

        with profiling.span("nbs.engine.direct"):
            slot_pos = slot_positions(positions, state, use_cell)
            pair_args = (slot_pos, state["slot_par"], state["slot_sub"],
                         state["table"], state["sexcl"], lam_c_nn, lam_v_nn,
                         box, pair_cfg, energies, n)
            pair = (cuda_direct.pair_cell if use_cell
                    else cuda_direct.pair_column)
            slot_f, moments = pair(*pair_args)

            slice_e = None
            if energies:
                # the moment panels (one per cell or per block) summed in f64
                slice_e = moment_slice_energies(moments, slice_pairs, nslices)

        if is_ewald_family and energies:
            with profiling.span("nbs.engine.self_plasma"):
                add_self_energies(slice_e, plan, charge, state["sig_half"],
                                  state["eps2"], data["subsets"], box,
                                  slice_pairs)

        if is_pme:
            if use_windows:
                slot_pos_b = pme_bricks.cells_to_bricks(
                    slot_pos, counts, bricks).contiguous()

            def reciprocal(weight, lam_nn, grid_key, dispersion):
                """Slice energies and slot forces (cell-major) of one PME
                pass: the charges' or (LJPME) the C6 weights'."""
                kw = dict(grid_shape=cfg[grid_key],
                          eterm=_eterm(box, dispersion),
                          slice_subset_pairs=idx["spairs"],
                          energies=energies,
                          dispersion=dispersion, lattice=lattice,
                          radius=spread_radius[grid_key])
                if not use_windows:
                    return cuda_pme.pme_reciprocal(
                        slot_pos, state[weight], state["slot_sub"], box,
                        lam_nn, **kw)
                e, f_b = cuda_pme.pme_reciprocal(
                    slot_pos_b, state[weight + "_b"], state["slot_sub_b"],
                    box, lam_nn, pipeline="grid", bricks=bricks, **kw)
                return e, pme_bricks.bricks_to_cells(
                    f_b.transpose(1, 2), counts, bricks).transpose(1, 2)

            with profiling.span("nbs.engine.reciprocal"):
                e_k, f_k = reciprocal("slot_q", lam_c_nn, "pme_grid", False)
                slot_f = slot_f + f_k
                if energies:
                    slice_e[:, COUL] += e_k
                if ljpme:
                    e_d, f_d = reciprocal("slot_c6", lam_v_nn,
                                          "dispersion_grid", True)
                    slot_f = slot_f + f_d
                    if energies:
                        slice_e[:, VDW] += e_d

        if slot_forces:
            return None, slot_f, dict(guards(positions, state), lam=lam)

        # single slot->atom unsort: gather by the inverse permutation
        forces = unsort(slot_f, state["inv_slots"])

        if bare_ewald:
            with profiling.span("nbs.engine.reciprocal"):
                e_k, f_k = ewald.ewald_reciprocal(
                    positions, box, charge, data["subsets"], lam_c,
                    kvec_ints=idx["kvec"], alpha=plan.ewald_alpha,
                    num_subsets=nsub, slice_table=idx["sl_tab"],
                    slice_subset_pairs=idx["spairs"], energies=energies)
                forces = forces + f_k
                if energies:
                    slice_e[:, COUL] += e_k

        if is_ewald_family and not use_cell:
            with profiling.span("nbs.engine.exclusions"):
                e_x, f_x = bonded.exclusion_corrections_rows(
                    positions, charge, state["sig_half"], state["eps2"],
                    state["pair_slices"], lam_c, lam_v,
                    alpha=plan.ewald_alpha, ljpme=ljpme,
                    dispersion_alpha=plan.dispersion_alpha,
                    num_slices=nslices)
                forces = forces + f_x
                if energies:
                    slice_e += e_x

        if data["nb14_atoms"].shape[0]:
            with profiling.span("nbs.engine.nb14"):
                sigma14, four_eps14, qq14 = params.nb14_params(data, gvals)
                e_14, f_14 = bonded.nb14_interactions(
                    positions, box, data["nb14_atoms"], sigma14, four_eps14,
                    qq14, data["nb14_slice"], lam_c, lam_v,
                    periodic=plan.exceptions_periodic, num_slices=nslices,
                    num_particles=n)
                forces = forces + f_14
                if energies:
                    slice_e += e_14

        if energies and disp_correction:
            # per-slice long-range dispersion correction / volume
            slice_e[:, VDW] += (data["dispersion_coefficients"].to(torch.float64)
                                / box_volume(box).to(torch.float64))

        return slice_e, forces, guards(positions, state)

    def guards(positions, state):
        """``apply``'s aux: the overflow count, the squared max displacement
        since ``prepare`` and, on the cell kernel's path, the span of the
        excluded pairs."""
        disp = positions - state["pos0"]
        maxdisp2 = torch.max(torch.sum(disp * disp, dim=-1))
        aux = dict(overflow=state["overflow"], maxdisp2=maxdisp2)
        if use_cell:
            aux["excl_span"] = state["excl_span"]
        return aux

    return prepare, apply, cfg
