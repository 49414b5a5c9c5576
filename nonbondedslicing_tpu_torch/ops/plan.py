"""Static compute-plan construction.

Converts a (SlicedNonbondedForce, System) pair into immutable numpy arrays and
configuration that the torch engine closes over.  This is the analog of the
reference's kernel ``initialize`` step
(platforms/reference/src/ReferenceNonbondedSlicingKernels.cpp:59-185)
plus the validation performed by ``SlicedNonbondedForceImpl::initialize``
(openmmapi/src/SlicedNonbondedForceImpl.cpp:33-133).

Everything that the reference bakes into GPU kernel source at runtime
(lambda tables, derivative selectors, RF/switch constants) is instead kept as
*data*: scaling parameters are tensor inputs, so changing a lambda or an
offset parameter never rebuilds the engine.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..models.force import NonbondedForce, OpenMMException, SlicedNonbondedForce
from ..utils import ewald_params
from ..utils.constants import COUL, VDW
from ..utils.indexing import slice_index, slice_pair_table
from . import dispersion as disp
from . import pme as pme_ops

EWALD_METHODS = (NonbondedForce.Ewald, NonbondedForce.PME, NonbondedForce.LJPME)


@dataclass(frozen=True)
class Plan:
    # sizes
    num_particles: int
    num_subsets: int
    num_slices: int
    method: int
    # per-particle static data
    subsets: np.ndarray          # (N,) int32
    base_params: np.ndarray      # (N, 3) float64: charge, sigma, epsilon
    charge_offsets: np.ndarray   # (G, N)
    sigma_offsets: np.ndarray    # (G, N)
    epsilon_offsets: np.ndarray  # (G, N)
    # exclusions (every exception pair), padded per-atom list
    exclusion_pairs: np.ndarray  # (E, 2) int32
    exclusion_list: np.ndarray   # (N, Emax) int32, padded with -1
    # 1-4 interactions
    nb14_atoms: np.ndarray       # (M, 2) int32
    nb14_base: np.ndarray        # (M, 3) float64: chargeProd, sigma, epsilon
    nb14_slice: np.ndarray       # (M,) int32
    nb14_charge_offsets: np.ndarray   # (G, M)
    nb14_sigma_offsets: np.ndarray    # (G, M)
    nb14_epsilon_offsets: np.ndarray  # (G, M)
    # scaling parameters / lambdas
    global_names: Tuple[str, ...]
    global_defaults: np.ndarray  # (G,)
    lam_source: np.ndarray       # (S, 2) int32: global-param index or -1
    deriv_names: Tuple[str, ...]
    deriv_mask: np.ndarray       # (D, S, 2) float64 0/1 selectors
    # method configuration
    cutoff: float
    use_switch: bool
    switch_distance: float
    rf_dielectric: float
    exceptions_periodic: bool
    ewald_alpha: float = 0.0
    ewald_kmax: Tuple[int, int, int] = (0, 0, 0)
    pme_grid: Tuple[int, int, int] = (0, 0, 0)
    dispersion_alpha: float = 0.0
    dispersion_grid: Tuple[int, int, int] = (0, 0, 0)
    # per-slice long-range dispersion coefficients (divided by volume at eval)
    dispersion_coefficients: np.ndarray = None
    # PME B-spline moduli (box independent; depend only on grid sizes)
    pme_moduli: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    dpme_moduli: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    pme_order: int = 5
    # lookup tables
    slice_table: np.ndarray = None   # (nsub, nsub) -> slice id
    # default periodic box (static; used to size the cell grid)
    box0: Optional[np.ndarray] = None


def _validate(force: SlicedNonbondedForce, system) -> None:
    """Mirror SlicedNonbondedForceImpl::initialize validation (cpp:33-133)."""
    if force.getNumParticles() != system.getNumParticles():
        raise OpenMMException(
            "SlicedNonbondedForce must have exactly as many particles as the "
            "System it belongs to.")
    if force.getUseSwitchingFunction():
        if not (0 <= force.getSwitchingDistance() < force.getCutoffDistance()):
            raise OpenMMException(
                "SlicedNonbondedForce: Switching distance must satisfy "
                "0 <= r_switch < r_cutoff")
    for i in range(force.getNumParticles()):
        _, sigma, epsilon = force.getParticleParameters(i)
        if sigma < 0:
            raise OpenMMException("SlicedNonbondedForce: sigma for a particle cannot be negative")
        if epsilon < 0:
            raise OpenMMException("SlicedNonbondedForce: epsilon for a particle cannot be negative")
    seen = set()
    for i in range(force.getNumExceptions()):
        p1, p2, _, sigma, epsilon = force.getExceptionParameters(i)
        for p in (p1, p2):
            if p < 0 or p >= force.getNumParticles():
                raise OpenMMException(
                    f"SlicedNonbondedForce: Illegal particle index for an exception: {p}")
        key = (min(p1, p2), max(p1, p2))
        if key in seen:
            raise OpenMMException(
                f"SlicedNonbondedForce: Multiple exceptions are specified for "
                f"particles {p1} and {p2}")
        seen.add(key)
        if sigma < 0:
            raise OpenMMException("SlicedNonbondedForce: sigma for an exception cannot be negative")
        if epsilon < 0:
            raise OpenMMException("SlicedNonbondedForce: epsilon for an exception cannot be negative")
    for i in range(force.getNumParticleParameterOffsets()):
        _, particle, *_ = force.getParticleParameterOffset(i)
        if particle < 0 or particle >= force.getNumParticles():
            raise OpenMMException(
                f"SlicedNonbondedForce: Illegal particle index for a particle "
                f"parameter offset: {particle}")
    for i in range(force.getNumExceptionParameterOffsets()):
        _, exception, *_ = force.getExceptionParameterOffset(i)
        if exception < 0 or exception >= force.getNumExceptions():
            raise OpenMMException(
                f"SlicedNonbondedForce: Illegal exception index for an exception "
                f"parameter offset: {exception}")
    method = force.getNonbondedMethod()
    if method not in (NonbondedForce.NoCutoff, NonbondedForce.CutoffNonPeriodic):
        box = np.array(system.getDefaultPeriodicBoxVectors())
        cutoff = force.getCutoffDistance()
        if cutoff > 0.5 * box[0][0] or cutoff > 0.5 * box[1][1] or cutoff > 0.5 * box[2][2]:
            raise OpenMMException(
                "SlicedNonbondedForce: The cutoff distance cannot be greater "
                "than half the periodic box size.")
        if method == NonbondedForce.Ewald and (
                box[1][0] != 0 or box[2][0] != 0 or box[2][1] != 0):
            raise OpenMMException(
                "SlicedNonbondedForce: Ewald is not supported with "
                "non-rectangular boxes.  Use PME instead.")
    offset_params = set()
    for i in range(force.getNumParticleParameterOffsets()):
        offset_params.add(force.getParticleParameterOffset(i)[0])
    for i in range(force.getNumExceptionParameterOffsets()):
        offset_params.add(force.getExceptionParameterOffset(i)[0])
    for i in range(force.getNumScalingParameters()):
        name = force.getScalingParameter(i)[0]
        if name in offset_params:
            raise OpenMMException(
                "SlicedNonbondedForce: Cannot use a global parameter for both "
                "slice energy scaling and parameter offset.")


def build_plan(force: SlicedNonbondedForce, system) -> Plan:
    _validate(force, system)
    n = force.getNumParticles()
    nsub = force.getNumSubsets()
    nslices = force.getNumSlices()
    method = force.getNonbondedMethod()

    # vectorized reads of the force's particle storage (a per-particle
    # getter loop costs ~10 s at the 3.4M-particle testHugeSystem scale)
    subsets = np.zeros(n, dtype=np.int32)
    if force._subsets:
        sub_idx = np.fromiter(force._subsets.keys(), dtype=np.int64,
                              count=len(force._subsets))
        subsets[sub_idx] = np.fromiter(force._subsets.values(),
                                       dtype=np.int64,
                                       count=len(force._subsets))
    base_params = np.asarray(force._particles, dtype=np.float64).reshape(n, 3)

    global_names = tuple(force.getGlobalParameterName(i)
                         for i in range(force.getNumGlobalParameters()))
    global_defaults = np.array([force.getGlobalParameterDefaultValue(i)
                                for i in range(force.getNumGlobalParameters())],
                               dtype=np.float64)
    name_to_idx = {nm: i for i, nm in enumerate(global_names)}
    g = len(global_names)

    charge_off = np.zeros((g, n))
    sigma_off = np.zeros((g, n))
    epsilon_off = np.zeros((g, n))
    for i in range(force.getNumParticleParameterOffsets()):
        param, particle, cq, cs, ce = force.getParticleParameterOffset(i)
        pi = name_to_idx[param]
        charge_off[pi, particle] += cq
        sigma_off[pi, particle] += cs
        epsilon_off[pi, particle] += ce

    # classify exceptions into exclusions vs 1-4s
    # (ReferenceNonbondedSlicingKernels.cpp:88-111)
    exceptions_with_offsets = set()
    for i in range(force.getNumExceptionParameterOffsets()):
        exceptions_with_offsets.add(force.getExceptionParameterOffset(i)[1])
    exclusion_pairs = []
    nb14_indices = []
    nb14_map = {}
    for i in range(force.getNumExceptions()):
        p1, p2, chargeProd, sigma, epsilon = force.getExceptionParameters(i)
        exclusion_pairs.append((p1, p2))
        if chargeProd != 0.0 or epsilon != 0.0 or i in exceptions_with_offsets:
            nb14_map[i] = len(nb14_indices)
            nb14_indices.append(i)
    exclusion_pairs = (np.array(exclusion_pairs, dtype=np.int32).reshape(-1, 2)
                       if exclusion_pairs else np.zeros((0, 2), dtype=np.int32))

    # padded per-atom exclusion list
    per_atom = [[] for _ in range(n)]
    for p1, p2 in exclusion_pairs:
        per_atom[p1].append(p2)
        per_atom[p2].append(p1)
    emax = max((len(x) for x in per_atom), default=0)
    exclusion_list = np.full((n, max(emax, 1)), -1, dtype=np.int32)
    for i, lst in enumerate(per_atom):
        exclusion_list[i, :len(lst)] = lst

    m = len(nb14_indices)
    nb14_atoms = np.zeros((m, 2), dtype=np.int32)
    nb14_base = np.zeros((m, 3))
    nb14_slice = np.zeros((m,), dtype=np.int32)
    for k, i in enumerate(nb14_indices):
        p1, p2, chargeProd, sigma, epsilon = force.getExceptionParameters(i)
        nb14_atoms[k] = (p1, p2)
        nb14_base[k] = (chargeProd, sigma, epsilon)
        nb14_slice[k] = slice_index(int(subsets[p1]), int(subsets[p2]))
    nb14_charge_off = np.zeros((g, m))
    nb14_sigma_off = np.zeros((g, m))
    nb14_epsilon_off = np.zeros((g, m))
    for i in range(force.getNumExceptionParameterOffsets()):
        param, exception, cq, cs, ce = force.getExceptionParameterOffset(i)
        if exception in nb14_map:
            pi = name_to_idx[param]
            k = nb14_map[exception]
            nb14_charge_off[pi, k] += cq
            nb14_sigma_off[pi, k] += cs
            nb14_epsilon_off[pi, k] += ce

    # scaling-parameter tables (ReferenceNonbondedSlicingKernels.cpp:63-86)
    lam_source = np.full((nslices, 2), -1, dtype=np.int32)
    for i in range(force.getNumScalingParameters()):
        name, s1, s2, inc_coul, inc_lj = force.getScalingParameter(i)
        sl = slice_index(s1, s2)
        if inc_coul:
            lam_source[sl, COUL] = name_to_idx[name]
        if inc_lj:
            lam_source[sl, VDW] = name_to_idx[name]

    deriv_names = tuple(force.getEnergyParameterDerivativeName(i)
                        for i in range(force.getNumEnergyParameterDerivatives()))
    deriv_mask = np.zeros((len(deriv_names), nslices, 2))
    for d, dname in enumerate(deriv_names):
        pidx = name_to_idx[dname]
        deriv_mask[d] = (lam_source == pidx).astype(np.float64)

    cutoff = force.getCutoffDistance()
    use_switch = force.getUseSwitchingFunction() and method not in (
        NonbondedForce.NoCutoff, NonbondedForce.LJPME)
    box = np.array(system.getDefaultPeriodicBoxVectors())

    ewald_alpha = 0.0
    ewald_kmax = (0, 0, 0)
    pme_grid = (0, 0, 0)
    dispersion_alpha = 0.0
    dispersion_grid = (0, 0, 0)
    pme_moduli = None
    dpme_moduli = None
    tol = force.getEwaldErrorTolerance()
    if method == NonbondedForce.Ewald:
        ewald_alpha, kx, ky, kz = ewald_params.calc_ewald_parameters(box, cutoff, tol)
        ewald_kmax = (kx, ky, kz)
    elif method in (NonbondedForce.PME, NonbondedForce.LJPME):
        # legal=True rounds auto-computed sizes up to prime factors <= 13,
        # matching the reference GPU platforms (findLegalDimension at
        # CommonNonbondedSlicingKernels.cpp:440-449) — large boxes otherwise
        # land on primes (e.g. 89 at 100k atoms) that FFT libraries handle
        # badly; user-supplied grids pass through untouched
        alpha0, nx0, ny0, nz0 = force.getPMEParameters()
        ewald_alpha, nx, ny, nz = ewald_params.calc_pme_parameters(
            box, cutoff, tol, dispersion=False, alpha=alpha0,
            grid=(nx0, ny0, nz0), legal=True)
        pme_grid = (nx, ny, nz)
        pme_moduli = pme_ops.bspline_moduli(pme_grid, order=5)
        if method == NonbondedForce.LJPME:
            alpha0, nx0, ny0, nz0 = force.getLJPMEParameters()
            dispersion_alpha, dnx, dny, dnz = ewald_params.calc_pme_parameters(
                box, cutoff, tol, dispersion=True, alpha=alpha0,
                grid=(nx0, ny0, nz0), legal=True)
            dispersion_grid = (dnx, dny, dnz)
            dpme_moduli = pme_ops.bspline_moduli(dispersion_grid, order=5)

    if method in (NonbondedForce.NoCutoff, NonbondedForce.CutoffNonPeriodic):
        exceptions_periodic = False
    else:
        exceptions_periodic = force.getExceptionsUsePeriodicBoundaryConditions()

    if force.getUseDispersionCorrection():
        dispersion_coefficients = disp.calc_dispersion_corrections(force)
    else:
        dispersion_coefficients = np.zeros(nslices)

    return Plan(
        num_particles=n,
        num_subsets=nsub,
        num_slices=nslices,
        method=method,
        subsets=subsets,
        base_params=base_params,
        charge_offsets=charge_off,
        sigma_offsets=sigma_off,
        epsilon_offsets=epsilon_off,
        exclusion_pairs=exclusion_pairs,
        exclusion_list=exclusion_list,
        nb14_atoms=nb14_atoms,
        nb14_base=nb14_base,
        nb14_slice=nb14_slice,
        nb14_charge_offsets=nb14_charge_off,
        nb14_sigma_offsets=nb14_sigma_off,
        nb14_epsilon_offsets=nb14_epsilon_off,
        global_names=global_names,
        global_defaults=global_defaults,
        lam_source=lam_source,
        deriv_names=deriv_names,
        deriv_mask=deriv_mask,
        cutoff=cutoff,
        use_switch=use_switch,
        switch_distance=force.getSwitchingDistance(),
        rf_dielectric=force.getReactionFieldDielectric(),
        exceptions_periodic=exceptions_periodic,
        ewald_alpha=ewald_alpha,
        ewald_kmax=ewald_kmax,
        pme_grid=pme_grid,
        dispersion_alpha=dispersion_alpha,
        dispersion_grid=dispersion_grid,
        dispersion_coefficients=dispersion_coefficients,
        pme_moduli=pme_moduli,
        dpme_moduli=dpme_moduli,
        slice_table=slice_pair_table(nsub).astype(np.int32),
        box0=box,
    )


def refresh_plan(plan: Plan, force: SlicedNonbondedForce, system) -> Plan:
    """Rebuild parameter data after updateParametersInContext, enforcing the
    reference's constraints: same particle count, same set of non-excluded
    exceptions (ReferenceNonbondedSlicingKernels.cpp:270-319), and no
    structural changes to what the compiled functions closed over — the
    reference similarly rejects re-wiring that its compiled GPU kernels baked
    in (CommonNonbondedSlicingKernels.cpp:1404-1568).  Such changes require
    Context.reinitialize()."""
    if force.getNumParticles() != plan.num_particles:
        raise OpenMMException("updateParametersInContext: The number of particles has changed")
    new_plan = build_plan(force, system)
    if new_plan.nb14_atoms.shape[0] != plan.nb14_atoms.shape[0]:
        raise OpenMMException(
            "updateParametersInContext: The number of non-excluded exceptions has changed")
    # structural guards: the jitted functions close over these (lambda wiring,
    # global-parameter ordering, method configuration); silently swapping the
    # plan would leave stale closures in the compiled step
    if new_plan.global_names != plan.global_names:
        raise OpenMMException(
            "updateParametersInContext: The set of global parameters has "
            "changed; call reinitialize() instead")
    if not np.array_equal(new_plan.lam_source, plan.lam_source):
        raise OpenMMException(
            "updateParametersInContext: The scaling parameters have changed; "
            "call reinitialize() instead")
    if new_plan.deriv_names != plan.deriv_names:
        raise OpenMMException(
            "updateParametersInContext: The energy-parameter-derivative "
            "requests have changed; call reinitialize() instead")
    if (new_plan.method != plan.method
            or new_plan.num_subsets != plan.num_subsets
            or new_plan.cutoff != plan.cutoff
            or new_plan.use_switch != plan.use_switch
            or new_plan.switch_distance != plan.switch_distance
            or new_plan.exceptions_periodic != plan.exceptions_periodic
            or new_plan.ewald_alpha != plan.ewald_alpha
            or new_plan.pme_grid != plan.pme_grid
            or new_plan.dispersion_alpha != plan.dispersion_alpha):
        raise OpenMMException(
            "updateParametersInContext: The nonbonded method configuration "
            "has changed; call reinitialize() instead")
    return new_plan
