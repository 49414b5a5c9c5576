"""The slab-decomposed MD step over a ``torch.distributed`` group (the JAX
package's ``parallel/fused_shard.py``).

The reference runs MD over several GPUs with a context per device, host
threads splitting the direct-space pair loop and a host-side energy sum
(CudaParallelNonbondedSlicingKernels.cpp:19-66).  Here every rank holds the
whole state and runs the whole K-step loop:

* **x-slabs of cells**: the cell grid is cut into slabs of ceil(ncx / size)
  x-planes, one a rank in rank order; cells are numbered x-major, so a slab
  is one range of cells (``collectives.share`` with a quantum of one plane),
  and a rank whose planes all lie past ncx owns none.  Each rank builds the
  whole slot table (replicated) and launches its pair kernel over its
  slab's home cells: ``pair_column`` on positions kept in the rebuild's
  image where the exclusions are rigid-water triangles (or under
  CutoffPeriodic), ``pair_cell`` with the Ewald exclusion corrections fused
  in otherwise, as the fused engine chooses (``ops/fused.py``).  The JAX
  package sweeps a half shell in XLA here; the kernels sweep a full shell
  with weight 1/2 in the moment panels, so the slice energies agree to
  rounding.
* **atom ranges** for the reciprocal part (``parallel/pme_shard.py``: the
  grids or structure factors summed over the group), the water-triangle
  exclusion rows (molecule ranges) and the 1-4 exceptions (exception
  ranges);
* **one force reduction a step**: every rank writes its share into a
  zero-filled (N, 3) array and one ``all_reduce`` sums them; the leapfrog
  and the constraint projections then run on every rank, so every rank
  holds the same positions and velocities to the bit.  The guards
  (overflow, displacement, excluded-pair span) are computed from those
  replicated positions and need no collective.

The energies come from one evaluation at the end of a run: the ranks'
pair, exclusion-row and 1-4 slice energies are summed over the group in
float64, and the replicated terms (the reciprocal energies, which every
rank computes from the summed grids, the self, plasma and dispersion
corrections) are added once after the sum, on every rank.

The windows of K steps are replays of CUDA graphs (``runtime/fastpath.py``'s
``_WindowGraphs``) where the group's backend is NCCL, whose collectives a
graph can hold once the communicator exists (the first window of each
length runs eagerly before its capture, all-reduces included); gloo takes
CUDA tensors through the host, so its windows run eagerly.
"""

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..models.force import NonbondedForce, OpenMMException
from ..ops import bonded, cuda_direct, engine, ewald, fused, neighbors, params
from ..ops.geometry import box_volume
from ..ops.plan import EWALD_METHODS
from ..runtime import fastpath
from ..utils.constants import COUL, VDW
from ..utils.indexing import slice_subsets
from . import collectives, pme_shard


def make_sharded_md_step(plan, masses, dt, group=None, dtype=torch.float32,
                         constraints=None, reuse_steps=None,
                         cell_capacity=None, target_skin=0.1):
    """Build run(pos, vel, box, gvals, data, n_steps) -> (pos, vel, energy)
    running the MD loop over the ranks of ``group`` (None: the world
    group), each calling it with the same inputs on its own device; every
    rank returns the same result.

    Leapfrog Verlet with optional M-SHAKE/RATTLE ``constraints``
    ((pairs, dists) or (pairs, dists, mask) clusters), in ``dtype``.  The
    slot table is rebuilt every ``reuse_steps`` (K) steps (None: from the
    skin at 8 nm/ps), on a grid of cells of at least cutoff +
    ``target_skin`` with ``cell_capacity`` slots (None: twice the mean
    occupancy + 4).  ``energy`` is the 0-d float64 energy at the positions
    reached.  Raises OpenMMException for a plan without a periodic cutoff
    or a box too small for a cell grid, and after a run whose cell
    capacity overflowed, in which an atom moved more than skin/2 between
    rebuilds, or (on ``pair_cell``'s path) in which an excluded pair
    spanned a cell width or more.

    ``run.config`` holds the JAX package's keys (``reuse_steps``, ``skin``,
    ``counts``, ``capacity``, ``slabs_per_device``, ``devices``), ``graph``
    (whether the windows replay CUDA graphs: NCCL groups on CUDA tensors)
    and ``pair`` (the pair kernel's name); ``run.eager`` is the same
    function without the graphs, ``run.stats`` counts the captures and
    replays."""
    method = plan.method
    if plan.box0 is None or method in (NonbondedForce.NoCutoff,
                                       NonbondedForce.CutoffNonPeriodic):
        raise OpenMMException(
            "make_sharded_md_step requires a periodic cutoff method")
    n = plan.num_particles
    grid = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n,
                                      target_skin=target_skin)
    if grid is None:
        raise OpenMMException(
            "make_sharded_md_step: box too small for a cell grid")
    counts, capacity = grid
    if cell_capacity is not None:
        capacity = int(cell_capacity)
    widths = neighbors._perpendicular_widths(plan.box0) / np.asarray(counts)
    skin = max(float(np.min(widths)) - plan.cutoff, 0.0)
    if reuse_steps is None:
        v_ref = 8.0                   # nm/ps, the JAX package's heuristic
        reuse_steps = int(0.5 * skin / (dt * v_ref)) if skin > 0 else 1
    K = min(25, max(1, int(reuse_steps)))
    disp_limit2 = (0.5 * skin) ** 2 if K > 1 else np.inf

    group = dist.group.WORLD if group is None else group
    _, size = collectives.rank_and_size(group)
    ncx, ncy, ncz = counts
    n_cells = ncx * ncy * ncz
    # the rank's slab: x-planes [rank * sx, rank * sx + sx) of ncx
    sx = -(-ncx // size)
    c0, c1 = collectives.share(n_cells, group, quantum=ncy * ncz)
    nsub = plan.num_subsets
    nslices = plan.num_slices
    slice_pairs = np.asarray(slice_subsets(nsub))
    is_pme = method in (NonbondedForce.PME, NonbondedForce.LJPME)
    ljpme = method == NonbondedForce.LJPME
    use_cell = fused.uses_cell_kernel(plan)
    pair_cfg = fused.pair_config(plan, counts, capacity)
    pair = cuda_direct.pair_cell if use_cell else cuda_direct.pair_column
    pad_offset = fused.pad_base(plan.box0)
    excl_pairs = np.asarray(plan.exclusion_pairs,
                            dtype=np.int64).reshape(-1, 2)
    # the rigid-water exclusion rows by molecule range (the column path)
    rows = method in EWALD_METHODS and not use_cell
    m0, m1 = collectives.share(n // 3, group) if rows else (0, 0)
    # the 1-4 exceptions by exception range
    b0, b1 = collectives.share(int(plan.nb14_atoms.shape[0]), group)
    # the reciprocal part by atom range
    tables = dict(num_subsets=nsub, slice_subset_pairs=slice_pairs,
                  slice_table=plan.slice_table)
    recip = dpme = None
    if is_pme:
        _, _, recip = pme_shard.make_pme_device_term(
            group, n, alpha=plan.ewald_alpha, grid_shape=plan.pme_grid,
            moduli=plan.pme_moduli, **tables)
        if ljpme:
            _, _, dpme = pme_shard.make_pme_device_term(
                group, n, alpha=plan.dispersion_alpha,
                grid_shape=plan.dispersion_grid, moduli=plan.dpme_moduli,
                dispersion=True, **tables)
    elif method == NonbondedForce.Ewald:
        recip = pme_shard.make_ewald_device_term(
            group, n, kvec_ints=ewald.half_space_kvectors(plan.ewald_kmax),
            alpha=plan.ewald_alpha, **tables)
    integrate = fastpath.make_integrator(masses, dt, dtype, constraints)
    graph_ok = (integrate.capturable
                and dist.get_backend(group) == dist.Backend.NCCL)
    index_cache = {}
    nb14_views = {}

    def _indices(dev):
        """Index tables on ``dev``, copied from the host once."""
        if dev not in index_cache:
            index_cache[dev] = dict(
                sl_tab=torch.as_tensor(np.asarray(plan.slice_table),
                                       dtype=torch.int64, device=dev),
                lam_src=torch.as_tensor(np.asarray(plan.lam_source),
                                        dtype=torch.int64, device=dev),
                excl_i=torch.as_tensor(excl_pairs[:, 0], device=dev),
                excl_j=torch.as_tensor(excl_pairs[:, 1], device=dev))
        return index_cache[dev]

    def nb14_range(data):
        """This rank's 1-4 pairs and slice ids: the same view objects from
        call to call (the view keeps its base alive, so the base's id
        names it), so that the pairs' incidence tables
        (``utils.indexing.pair_incidence``) are built once, outside a
        graph's capture."""
        base = data["nb14_atoms"]
        if nb14_views.get("base") is not base:
            nb14_views.update(base=base, atoms=base[b0:b1],
                              slices=data["nb14_slice"][b0:b1])
        return nb14_views["atoms"], nb14_views["slices"]

    def prepare_local(positions, box, gvals, data):
        """The whole slot table (every rank builds the same) and, for the
        rank's exclusion rows, their slice ids."""
        idx = _indices(positions.device)
        state = fused.slot_state(positions, box, gvals, data, counts=counts,
                                 capacity=capacity, n=n, cell_kernel=use_cell,
                                 pad_offset=pad_offset)
        if use_cell:
            state["excl_span"] = neighbors.exclusion_span(
                positions, box, idx["excl_i"], idx["excl_j"], counts)
        if m1 > m0:
            state["pair_slices"] = fused.water_pair_slices(
                data["subsets"][3 * m0:3 * m1], idx["sl_tab"])
        return state

    def forces_local(positions, box, gvals, data, state, energies):
        """This rank's share: (its partial slice energies, (S, 2) float64,
        or None; the replicated ones, the same on every rank, or None;
        forces (N, 3), zero outside its share)."""
        dev = positions.device
        idx = _indices(dev)
        lam = params.slice_lambdas(idx["lam_src"], gvals)
        lam_c, lam_v = lam[:, COUL], lam[:, VDW]
        charge, sig_half, eps2 = (state[key]
                                  for key in ("charge", "sig_half", "eps2"))
        subsets = data["subsets"]
        part = rep = None
        if energies:
            part = torch.zeros((nslices, 2), dtype=torch.float64, device=dev)
            rep = torch.zeros((nslices, 2), dtype=torch.float64, device=dev)
        if c1 > c0:
            slot_f, moments = pair(
                fused.slot_positions(positions, state, use_cell),
                state["slot_par"], state["slot_sub"], state["table"],
                state["sexcl"], lam_c[idx["sl_tab"]].contiguous(),
                lam_v[idx["sl_tab"]].contiguous(), box, pair_cfg, energies, n,
                cells=(c0, c1 - c0))
            # the slab's slots into the whole grid's, then the slot->atom
            # unsort: atoms outside the slab read zeros
            grid_f = slot_f.new_zeros((n_cells, 3, capacity))
            grid_f[c0:c1] = slot_f
            forces = fused.unsort(grid_f, state["inv_slots"])
            if energies:
                part += fused.moment_slice_energies(moments, slice_pairs,
                                                    nslices)
        else:
            forces = positions.new_zeros((n, 3))
        if recip is not None:
            e_k, f_k, start = recip(positions, box, charge, subsets, lam_c,
                                    energies=energies)
            forces[start:start + f_k.shape[0]] += f_k
            if energies:
                rep[:, COUL] += e_k
        if dpme is not None:
            e_d, f_d, start = dpme(positions, box, 8.0 * sig_half ** 3 * eps2,
                                   subsets, lam_v, energies=energies)
            forces[start:start + f_d.shape[0]] += f_d
            if energies:
                rep[:, VDW] += e_d
        if m1 > m0:
            a0, a1 = 3 * m0, 3 * m1
            e_x, f_x = bonded.exclusion_corrections_rows(
                positions[a0:a1], charge[a0:a1], sig_half[a0:a1],
                eps2[a0:a1], state["pair_slices"], lam_c, lam_v,
                alpha=plan.ewald_alpha, ljpme=ljpme,
                dispersion_alpha=plan.dispersion_alpha, num_slices=nslices)
            forces[a0:a1] += f_x
            if energies:
                part += e_x
        if b1 > b0:
            sigma14, four_eps14, qq14 = params.nb14_params(data, gvals)
            atoms14, slices14 = nb14_range(data)
            e_14, f_14 = bonded.nb14_interactions(
                positions, box, atoms14, sigma14[b0:b1], four_eps14[b0:b1],
                qq14[b0:b1], slices14, lam_c, lam_v,
                periodic=plan.exceptions_periodic, num_slices=nslices,
                num_particles=n)
            forces += f_14
            if energies:
                part += e_14
        return part, rep, forces

    def window(k, pos, vel, box, gvals, data, acc):
        """The slot rebuild at ``pos``, then ``k`` steps, each with one
        all_reduce of the forces; the guard maxima go into ``acc``."""
        state = prepare_local(pos, box, gvals, data)
        for _ in range(k):
            _, _, forces = forces_local(pos, box, gvals, data, state, False)
            collectives.all_reduce(forces, group)
            disp = pos - state["pos0"]
            torch.maximum(acc["dmax"], torch.max(torch.sum(disp * disp, -1)),
                          out=acc["dmax"])
            pos, vel = integrate(pos, vel, forces)
        torch.maximum(acc["ov"], state["overflow"], out=acc["ov"])
        if use_cell:
            torch.maximum(acc["span"], state["excl_span"], out=acc["span"])
        return pos, vel

    def final(pos, box, gvals, data):
        """Slice energies at ``pos`` (the ranks' shares summed in float64,
        the replicated terms added once) and the rebuild's guards."""
        state = prepare_local(pos, box, gvals, data)
        part, rep, _ = forces_local(pos, box, gvals, data, state, True)
        slice_e = collectives.all_reduce(part, group) + rep
        if method in EWALD_METHODS:
            fused.add_self_energies(slice_e, plan, state["charge"],
                                    state["sig_half"], state["eps2"],
                                    data["subsets"], box, slice_pairs)
        if method in (NonbondedForce.CutoffPeriodic, NonbondedForce.Ewald,
                      NonbondedForce.PME):
            slice_e[:, VDW] += (data["dispersion_coefficients"].to(
                torch.float64) / box_volume(box).to(torch.float64))
        return slice_e, state["overflow"], state.get("excl_span")

    graphs = fastpath._WindowGraphs(window)

    def _run(pos, vel, box, gvals, data, n_steps, graphed):
        dev = data["base_params"].device
        box, pos, vel, gvals = (torch.as_tensor(x, device=dev).to(dtype)
                                for x in (box, pos, vel, gvals))
        pos, vel, (ov, dmax, span) = fastpath.run_windows(
            window, graphs, K, n_steps, pos, vel, box, gvals, data,
            graphed and graph_ok)
        slice_e, ov_final, span_final = final(pos, box, gvals, data)
        ov = torch.maximum(ov, ov_final)
        if span_final is not None:
            span = torch.maximum(span, span_final)
        energy = engine.contract_energy(
            slice_e, params.slice_lambdas(_indices(dev)["lam_src"], gvals))
        fastpath.check_guards(ov, dmax, span, disp_limit2, skin,
                              scope=" in the sharded MD scan")
        return pos, vel, energy

    def run(pos, vel, box, gvals, data, n_steps):
        return _run(pos, vel, box, gvals, data, n_steps, graphed=True)

    run.eager = functools.partial(_run, graphed=False)
    run.stats = graphs.stats
    run.config = dict(reuse_steps=K, skin=skin, counts=counts,
                      capacity=capacity, slabs_per_device=sx, devices=size,
                      graph=graph_ok,
                      pair="pair_cell" if use_cell else "pair_column")
    return run
