"""The generic engine ``make_compute``, the parameter tensors and the
lambda contraction of slice energies.

``make_compute(plan, include_direct, include_reciprocal)`` returns
``f(positions, box, gvals, data) -> (slice_energies (S, 2), forces (N, 3))``
for every nonbonded method (the JAX package's ``ops/engine.py:61-316``).
Slice energies are *unscaled* by lambda: the total energy is
``sum(lam * slice_energies)`` and, because E is lambda-linear, the exact
dE/dlambda derivatives are sums of slice energies
(ReferenceNonbondedSlicingKernels.cpp:252-265).  ``data`` carries every
mutable parameter array, so parameter updates never rebuild an engine.

Evaluation order as the reference's execute()
(ReferenceNonbondedSlicingKernels.cpp:187-268): self energy + neutralizing
plasma -> reciprocal (Ewald k-sum or sliced PME, plus LJPME's dispersion
PME) -> direct space -> exclusion corrections -> 1-4 exceptions ->
per-slice dispersion correction / volume.
"""

import numpy as np
import torch

from ..models.force import NonbondedForce
from ..runtime import profiling
from ..utils.constants import COUL, EPSILON0, ONE_4PI_EPS0, SQRT_PI, VDW
from ..utils.indexing import slice_subsets
from . import (bonded, cuda_direct, direct, ewald, kernel_direct, neighbors,
               params, pme)
from .geometry import box_volume
from .plan import EWALD_METHODS, Plan

DATA_KEYS = ("base_params", "charge_offsets", "sigma_offsets",
             "epsilon_offsets", "subsets", "exclusion_pairs",
             "exclusion_list", "nb14_atoms", "nb14_base", "nb14_slice",
             "nb14_charge_offsets", "nb14_sigma_offsets",
             "nb14_epsilon_offsets", "dispersion_coefficients")


def data_from_numpy(data_np, *, device, dtype):
    """A dict of numpy parameter arrays (the keys of :data:`DATA_KEYS`,
    e.g. the JAX package's ``plan_data(plan)`` converted with
    ``np.asarray``) -> tensors on ``device``: floating arrays in ``dtype``,
    integer arrays as int64."""
    out = {}
    for key in DATA_KEYS:
        arr = np.asarray(data_np[key])
        if arr.dtype.kind == "f":
            out[key] = torch.tensor(arr, device=device).to(dtype)
        else:
            out[key] = torch.tensor(arr.astype(np.int64), device=device)
    return out


def plan_data(plan: Plan, *, device="cuda", dtype=torch.float64):
    """The mutable-parameter tensors of a plan, on the card unless the
    caller names another device (the MD step runs where ``data`` lies)."""
    return data_from_numpy({k: getattr(plan, k) for k in DATA_KEYS},
                           device=device, dtype=dtype)


_CELL_LIST_MIN_PARTICLES = 1024
NEIGHBOR_ROUTES = ("auto", "all_pairs", "cell", "pallas")


def make_compute(plan: Plan, include_direct: bool, include_reciprocal: bool,
                 block_size=None, neighbor="auto", cell_capacity=None,
                 hoist_eterm=False, shard=None, with_aux=False):
    """f(positions, box, gvals, data) -> (slice_energies (S, 2) float64,
    forces (N, 3)[, aux]) in the dtype and on the device of ``positions``
    (``data`` from :func:`plan_data` on the same device and dtype).

    ``include_direct`` and ``include_reciprocal`` switch the direct space
    (with the exclusion corrections, 1-4 exceptions and the dispersion
    correction) and the reciprocal part (self and plasma energies, Ewald
    or PME, LJPME's dispersion PME) separately.

    ``neighbor`` chooses the direct space, with the JAX package's names:

    * ``"all_pairs"``: the O(N^2) blocks (``direct.make_direct_space``);
    * ``"cell"``: the plain cell list (``neighbors.make_cell_direct_space``);
    * ``"pallas"``: the min-image cell kernel
      (``kernel_direct.make_kernel_direct_space``, the port of the JAX
      package's Pallas route); float64 tensors take the plain cell list
      plus the generic exclusion corrections there, as the reference does;
    * ``"auto"``: a periodic cutoff method with a cell grid (at least 3
      cells of one cutoff per axis) and at least 1024 atoms takes the
      kernel route, smaller systems all pairs.

    ``"cell"`` and ``"pallas"`` fall back to all pairs where the box has no
    cell grid, as in the JAX package.  Where the kernel route is chosen
    (``"pallas"``, or ``"auto"`` at 1024 atoms or more) and the kernel does
    not take the plan's shape (more than ``cuda_direct.MAX_SUBSETS``
    subsets, ``MAX_EXCLUSIONS`` exclusions per atom or ``MAX_CAPACITY``
    slots per cell), ValueError names ``neighbor="cell"``: the plain cell
    list runs on the card only where the caller asks for it.  ``f.route``
    names the route built.  ``cell_capacity`` overrides the cell capacity,
    ``block_size`` the all-pairs row block.  ``hoist_eterm`` builds the PME
    convolution kernels once from ``plan.box0`` (valid only while the box
    is that box).

    ``shard`` (a ``torch.distributed`` process group; the JAX package's
    ``(mesh, axis)``, ``engine.py:63``) evaluates over the group's ranks,
    each on its own device with the same inputs: the cell-list and kernel
    routes split the cells among the ranks (the JAX package shards only
    its XLA cell list, ROADMAP D9), PME, LJPME's dispersion PME and Ewald
    split the atoms (``parallel/pme_shard.py``), and their shares are
    summed over the group; the all-pairs direct space, self and plasma
    energies, exclusion corrections, 1-4s and the dispersion correction run
    on every rank (``parallel/mesh.py`` splits the all-pairs rows).  Every
    rank returns the same result; the direct-space forces and the summed
    PME grids (int64) equal the unsharded call's to the bit, the rest
    equals it to rounding (the ranks' float partial sums, ROADMAP D10).

    ``with_aux=True`` adds aux = {"overflow": int32 0-d tensor}, the atoms
    beyond the cell capacity (0 without a cell list), and on the kernel
    route "excl_span" (float64 0-d), the span of the excluded pairs in cell
    widths (``neighbors.exclusion_span``).  Callers of a cell-list route
    check ``overflow == 0``, and on the kernel route ``excl_span < 1``: the
    kernel corrects only the excluded pairs within the 27-cell
    neighbourhood, so a wider pair gives a wrong answer, which the JAX
    package's ``make_compute`` returns silently.
    """
    if neighbor not in NEIGHBOR_ROUTES:
        raise ValueError(f"neighbor must be one of {NEIGHBOR_ROUTES}, got "
                         f"{neighbor!r}")
    method = plan.method
    is_ewald_family = method in EWALD_METHODS
    ljpme = method == NonbondedForce.LJPME
    n = plan.num_particles
    nsub = plan.num_subsets
    nslices = plan.num_slices
    slice_pairs = slice_subsets(nsub)
    periodic = method in (NonbondedForce.CutoffPeriodic,) + tuple(
        EWALD_METHODS)

    if method == NonbondedForce.NoCutoff:
        mode = direct.PLAIN
    elif method in (NonbondedForce.CutoffNonPeriodic,
                    NonbondedForce.CutoffPeriodic):
        mode = direct.CUTOFF
    else:
        mode = direct.EWALD_DIRECT

    # reaction-field constants (ReferenceSlicedLJCoulombIxn.cpp:66-67)
    eps_rf = plan.rf_dielectric
    krf = plan.cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0)
    crf = (1.0 / plan.cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0)

    # the cell list for large periodic cutoff systems; all pairs otherwise
    cell_cfg = None
    if (mode != direct.PLAIN and periodic and neighbor != "all_pairs"
            and plan.box0 is not None
            and (neighbor in ("cell", "pallas")
                 or n >= _CELL_LIST_MIN_PARTICLES)):
        cell_cfg = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n)
    if cell_cfg is not None:
        counts, capacity = cell_cfg
        if cell_capacity is not None:
            capacity = int(cell_capacity)
        cell_kw = dict(
            mode=mode, cutoff=plan.cutoff, counts=counts, capacity=capacity,
            krf=krf, crf=crf, use_switch=plan.use_switch,
            switch_distance=plan.switch_distance, ewald_alpha=plan.ewald_alpha,
            ljpme=ljpme, dispersion_alpha=plan.dispersion_alpha,
            num_slices=nslices, shard=shard)
        if neighbor == "cell":
            route = "cell"
            direct_fn = neighbors.make_cell_direct_space(**cell_kw)
        else:
            emax = plan.exclusion_list.shape[1]
            if not cuda_direct.kernel_fits(nsub, emax, capacity):
                raise ValueError(
                    f"make_compute: the cell kernel takes at most "
                    f"{cuda_direct.MAX_SUBSETS} subsets, "
                    f"{cuda_direct.MAX_EXCLUSIONS} exclusions per atom and "
                    f"{cuda_direct.MAX_CAPACITY} slots per cell (this plan: "
                    f"{nsub}, {emax}, {capacity}); use neighbor=\"cell\" "
                    f"for the plain cell list")
            route = "pallas"
            direct_fn = kernel_direct.make_kernel_direct_space(
                exceptions_periodic=plan.exceptions_periodic,
                exclusion_pairs=plan.exclusion_pairs, **cell_kw)
    else:
        route = "all_pairs"
        direct_fn = direct.make_direct_space(
            mode=mode, periodic=periodic, cutoff=plan.cutoff, krf=krf,
            crf=crf, use_switch=plan.use_switch,
            switch_distance=plan.switch_distance,
            ewald_alpha=plan.ewald_alpha, ljpme=ljpme,
            dispersion_alpha=plan.dispersion_alpha, num_slices=nslices,
            block_size=block_size)
    handles_exclusions = getattr(direct_fn, "handles_exclusions", False)

    kvec_ints = (ewald.half_space_kvectors(plan.ewald_kmax)
                 if method == NonbondedForce.Ewald else None)
    # the reciprocal part sharded by atom range (parallel/pme_shard.py)
    recip_sharded = dpme_sharded = None
    if shard is not None and include_reciprocal and is_ewald_family:
        from ..parallel import pme_shard
        tables = dict(num_subsets=nsub, slice_subset_pairs=slice_pairs,
                      slice_table=plan.slice_table)
        if method == NonbondedForce.Ewald:
            recip_sharded = pme_shard.make_sharded_ewald(
                shard, n, kvec_ints=kvec_ints, alpha=plan.ewald_alpha,
                **tables)
        else:
            recip_sharded = pme_shard.make_sharded_pme(
                shard, n, alpha=plan.ewald_alpha, grid_shape=plan.pme_grid,
                moduli=plan.pme_moduli, **tables)
            if ljpme:
                dpme_sharded = pme_shard.make_sharded_pme(
                    shard, n, alpha=plan.dispersion_alpha,
                    grid_shape=plan.dispersion_grid,
                    moduli=plan.dpme_moduli, dispersion=True, **tables)
    hoisted = {}      # (device, dtype) -> (Coulomb eterm, dispersion eterm)
    consts_cache = {}

    def consts(dev):
        """Index tables and B-spline moduli on ``dev``, copied from the
        host once: a call copies nothing from the host after its first,
        so it may run inside a CUDA graph's capture."""
        if dev not in consts_cache:
            def moduli(m):
                return (None if m is None else
                        tuple(torch.as_tensor(np.asarray(x), device=dev)
                              for x in m))
            consts_cache[dev] = dict(
                sl_tab=torch.as_tensor(np.asarray(plan.slice_table),
                                       dtype=torch.int64, device=dev),
                lam_src=torch.as_tensor(np.asarray(plan.lam_source),
                                        dtype=torch.int64, device=dev),
                spairs=torch.as_tensor(slice_pairs, device=dev),
                diag_ids=torch.as_tensor(
                    [s * (s + 3) // 2 for s in range(nsub)], device=dev),
                kvec=(None if kvec_ints is None
                      else torch.as_tensor(kvec_ints, device=dev)),
                pme_moduli=moduli(plan.pme_moduli),
                dpme_moduli=moduli(plan.dpme_moduli))
        return consts_cache[dev]

    def eterms(dev, dtype):
        """The convolution kernels from ``plan.box0`` (``hoist_eterm``)."""
        if not hoist_eterm or method not in (NonbondedForce.PME,
                                             NonbondedForce.LJPME):
            return None, None
        key = (dev, dtype)
        if key not in hoisted:
            e = torch.as_tensor(pme.coulomb_eterm_np(
                plan.pme_grid, plan.pme_moduli, plan.box0, plan.ewald_alpha),
                device=dev).to(dtype)
            d = None
            if ljpme:
                d = torch.as_tensor(pme.dispersion_eterm_np(
                    plan.dispersion_grid, plan.dpme_moduli, plan.box0,
                    plan.dispersion_alpha), device=dev).to(dtype)
            hoisted[key] = (e, d)
        return hoisted[key]

    def compute(positions, box, gvals, data):
        dtype, dev = positions.dtype, positions.device
        box = box.to(dtype)
        gvals = gvals.to(dtype)
        c = consts(dev)
        subsets = data["subsets"]
        charge, sig_half, eps2 = params.particle_params(data, gvals)
        lam = params.slice_lambdas(c["lam_src"], gvals)   # (S, 2)
        lam_c = lam[:, COUL]
        lam_v = lam[:, VDW]
        # per-slice energies accumulate in f64: they carry the ~1e6 kJ/mol
        # self-energy cancellation and the exact dE/dlambda
        slice_energies = torch.zeros((nslices, 2), dtype=torch.float64,
                                     device=dev)
        forces = torch.zeros((n, 3), dtype=dtype, device=dev)

        if is_ewald_family and include_reciprocal:
            with profiling.span("nbs.engine.self_plasma"):
                alpha = plan.ewald_alpha
                onehot64 = torch.nn.functional.one_hot(
                    subsets.long(), nsub).to(torch.float64)
                charge64 = charge.to(torch.float64)
                # self energy (ReferenceSlicedLJCoulombIxn.cpp:203-213)
                self_coul = (-ONE_4PI_EPS0 * charge64 * charge64 * alpha
                             / SQRT_PI)
                slice_energies[c["diag_ids"], COUL] += self_coul @ onehot64
                if ljpme:
                    self_vdw = (plan.dispersion_alpha ** 6 * 64.0
                                * sig_half.to(torch.float64) ** 6
                                * eps2.to(torch.float64) ** 2 / 12.0)
                    slice_energies[c["diag_ids"], VDW] += self_vdw @ onehot64
                # neutralizing plasma (cpp:214-221)
                volume = box_volume(box).to(torch.float64)
                q_sub = charge64 @ onehot64
                factor = ((-1.0 / (4.0 * alpha * alpha))
                          / (2.0 * EPSILON0 * volume))
                a, b = c["spairs"][:, 0], c["spairs"][:, 1]
                w = torch.where(a == b, 1.0, 2.0).to(torch.float64)
                slice_energies[:, COUL] += w * q_sub[a] * q_sub[b] * factor
            with profiling.span("nbs.engine.reciprocal"):
                # k-space
                if method == NonbondedForce.Ewald:
                    if recip_sharded is not None:
                        e_k, f_k = recip_sharded(positions, box, charge,
                                                 subsets, lam_c)
                    else:
                        e_k, f_k = ewald.ewald_reciprocal(
                            positions, box, charge, subsets, lam_c,
                            kvec_ints=c["kvec"], alpha=alpha,
                            num_subsets=nsub,
                            slice_table=c["sl_tab"],
                            slice_subset_pairs=c["spairs"])
                    slice_energies[:, COUL] += e_k
                    forces = forces + f_k
                else:
                    eterm0, dterm0 = eterms(dev, dtype)
                    if recip_sharded is not None:
                        e_k, f_k = recip_sharded(positions, box, charge,
                                                 subsets, lam_c, eterm=eterm0)
                    else:
                        e_k, f_k = pme.pme_reciprocal(
                            positions, box, charge, subsets, lam_c,
                            alpha=alpha, grid_shape=plan.pme_grid,
                            moduli=c["pme_moduli"], num_subsets=nsub,
                            slice_subset_pairs=c["spairs"],
                            slice_table=c["sl_tab"], eterm=eterm0)
                    slice_energies[:, COUL] += e_k
                    forces = forces + f_k
                    if ljpme:
                        c6 = 8.0 * sig_half ** 3 * eps2
                        if dpme_sharded is not None:
                            e_d, f_d = dpme_sharded(positions, box, c6,
                                                    subsets, lam_v,
                                                    eterm=dterm0)
                        else:
                            e_d, f_d = pme.pme_reciprocal(
                                positions, box, c6, subsets, lam_v,
                                alpha=plan.dispersion_alpha,
                                grid_shape=plan.dispersion_grid,
                                moduli=c["dpme_moduli"], num_subsets=nsub,
                                slice_subset_pairs=c["spairs"],
                                slice_table=c["sl_tab"], dispersion=True,
                                eterm=dterm0)
                        slice_energies[:, VDW] += e_d
                        forces = forces + f_d

        aux = {"overflow": torch.zeros((), dtype=torch.int32, device=dev)}
        if include_direct:
            with profiling.span("nbs.engine.direct"):
                out = direct_fn(positions, box, charge, sig_half, eps2,
                                subsets, data["exclusion_list"], c["sl_tab"],
                                lam_c, lam_v)
                if getattr(direct_fn, "returns_overflow", False):
                    e_dir, f_dir, aux["overflow"] = out
                else:
                    e_dir, f_dir = out
                slice_energies = slice_energies + e_dir
                forces = forces + f_dir
                if route == "pallas":
                    pairs = data["exclusion_pairs"].long()
                    aux["excl_span"] = neighbors.exclusion_span(
                        positions, box, pairs[:, 0], pairs[:, 1], counts)

            if is_ewald_family and not handles_exclusions:
                with profiling.span("nbs.engine.exclusions"):
                    e_x, f_x = bonded.exclusion_corrections(
                        positions, box, data["exclusion_pairs"], charge,
                        sig_half, eps2, subsets, c["sl_tab"], lam_c, lam_v,
                        alpha=plan.ewald_alpha,
                        periodic_exceptions=plan.exceptions_periodic,
                        ljpme=ljpme, dispersion_alpha=plan.dispersion_alpha,
                        num_slices=nslices, num_particles=n)
                    slice_energies = slice_energies + e_x
                    forces = forces + f_x

            with profiling.span("nbs.engine.nb14"):
                sigma14, four_eps14, qq14 = params.nb14_params(data, gvals)
                e_14, f_14 = bonded.nb14_interactions(
                    positions, box, data["nb14_atoms"], sigma14, four_eps14,
                    qq14, data["nb14_slice"], lam_c, lam_v,
                    periodic=plan.exceptions_periodic, num_slices=nslices,
                    num_particles=n)
                slice_energies = slice_energies + e_14
                forces = forces + f_14

            # per-slice long-range dispersion correction / volume
            # (ReferenceNonbondedSlicingKernels.cpp:244-249); LJPME handles
            # dispersion exactly, so it has none
            if method in (NonbondedForce.CutoffPeriodic, NonbondedForce.Ewald,
                          NonbondedForce.PME):
                slice_energies[:, VDW] += (
                    data["dispersion_coefficients"].to(torch.float64)
                    / box_volume(box).to(torch.float64))

        if with_aux:
            return slice_energies, forces, aux
        return slice_energies, forces

    compute.route = route
    compute.direct_space = direct_fn
    return compute


def contract_energy(slice_energies, lam):
    """E = sum(lam * slice_energies) (ReferenceNonbondedSlicingKernels.cpp:252-257)."""
    return torch.sum(lam.to(slice_energies.dtype) * slice_energies)


def parameter_derivatives(slice_energies, deriv_mask):
    """dE/dlambda_p = sum of unscaled slice energies assigned to p
    (ReferenceNonbondedSlicingKernels.cpp:259-265)."""
    mask = profiling.to_device(np.asarray(deriv_mask, dtype=np.float64),
                               slice_energies.device).to(slice_energies.dtype)
    return torch.einsum("dst,st->d", mask, slice_energies)
