"""User-facing force definitions.

This module re-creates the capability surface of the reference plugin's API
layer (`SlicedNonbondedForce`, openmmapi/src/SlicedNonbondedForce.cpp)
plus the parts of OpenMM's ``NonbondedForce`` that the plugin inherits
(particle/exception storage, parameter offsets, method/cutoff/switching
configuration).  These are plain-Python objects; all computation
happens in :mod:`nonbondedslicing_tpu_torch.ops` after
:func:`~..ops.plan.build_plan` turns them into static plans.

Semantics intentionally preserved from the reference:

* subsets stored sparsely with default subset 0
  (SlicedNonbondedForce.cpp:102-112)
* ``addScalingParameter`` clash detection: at most one Coulomb and one LJ
  scaling parameter per slice (SlicedNonbondedForce.h:93-95); a scaling
  parameter must reference an existing global parameter; includeCoulomb and
  includeLJ cannot both be false (SlicedNonbondedForce.h:87-88)
* ``addEnergyParameterDerivative`` only accepts scaling parameters and rejects
  duplicates (SlicedNonbondedForce.cpp:164-172)
* copy construction from an existing (Sliced)NonbondedForce copies every field
  (SlicedNonbondedForce.cpp:34-82)
"""

import math
from ..utils.indexing import slice_index


class OpenMMException(Exception):
    """Raised on invalid force specifications, mirroring OpenMM's exception."""


class Force:
    """Base class providing force-group bookkeeping."""

    def __init__(self):
        self._force_group = 0
        self._name = type(self).__name__

    def getForceGroup(self):
        return self._force_group

    def setForceGroup(self, group):
        if group < 0 or group > 31:
            raise OpenMMException("Force group must be between 0 and 31")
        self._force_group = int(group)

    def getName(self):
        return self._name

    def setName(self, name):
        self._name = str(name)

    def usesPeriodicBoundaryConditions(self):
        return False


class HarmonicBondForce(Force):
    """Minimal harmonic bond force: E = 0.5*k*(r - r0)^2.

    Provided so that multi-force systems exercised by the reference tests
    (e.g. testLargeSystem, tests/TestSlicedNonbondedForce.h:505)
    can be reproduced.
    """

    def __init__(self):
        super().__init__()
        self._bonds = []
        self._periodic = False

    def addBond(self, particle1, particle2, length, k):
        self._bonds.append([int(particle1), int(particle2), float(length), float(k)])
        return len(self._bonds) - 1

    def getNumBonds(self):
        return len(self._bonds)

    def getBondParameters(self, index):
        return tuple(self._bonds[index])

    def setBondParameters(self, index, particle1, particle2, length, k):
        self._bonds[index] = [int(particle1), int(particle2), float(length), float(k)]

    def setUsesPeriodicBoundaryConditions(self, periodic):
        self._periodic = bool(periodic)

    def usesPeriodicBoundaryConditions(self):
        return self._periodic


class NonbondedForce(Force):
    """Storage/configuration mirror of OpenMM's NonbondedForce.

    Method constants follow OpenMM's enum order
    (openmmapi/include/NonbondedSlicingKernels.h:29-36).
    """

    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    Ewald = 3
    PME = 4
    LJPME = 5

    def __init__(self):
        super().__init__()
        self._method = self.NoCutoff
        self._cutoff = 1.0
        self._switching = False
        self._switching_distance = -1.0
        self._rf_dielectric = 78.3
        self._ewald_tolerance = 5e-4
        self._dispersion_correction = True
        self._include_direct = True
        self._recip_group = -1
        self._pme_params = [0.0, 0, 0, 0]
        self._ljpme_params = [0.0, 0, 0, 0]
        self._exceptions_use_periodic = False
        # [charge, sigma, epsilon] per particle
        self._particles = []
        # [p1, p2, chargeProd, sigma, epsilon] per exception
        self._exceptions = []
        self._exception_map = {}
        # ordered (name, default) global parameters
        self._global_params = []
        # [parameter, particle, chargeScale, sigmaScale, epsilonScale]
        self._particle_offsets = []
        # [parameter, exception, chargeProdScale, sigmaScale, epsilonScale]
        self._exception_offsets = []

    # ------------------------------------------------------------------ config

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        if method < 0 or method > 5:
            raise OpenMMException("NonbondedForce: Illegal nonbonded method")
        self._method = int(method)

    def getNonbondedMethodName(self):
        names = ["NoCutoff", "CutoffNonPeriodic", "CutoffPeriodic", "Ewald", "PME", "LJPME"]
        return names[self._method] if 0 <= self._method < 6 else "Unknown"

    def getCutoffDistance(self):
        return self._cutoff

    def setCutoffDistance(self, distance):
        self._cutoff = float(distance)

    def getUseSwitchingFunction(self):
        return self._switching

    def setUseSwitchingFunction(self, use):
        self._switching = bool(use)

    def getSwitchingDistance(self):
        return self._switching_distance

    def setSwitchingDistance(self, distance):
        self._switching_distance = float(distance)

    def getReactionFieldDielectric(self):
        return self._rf_dielectric

    def setReactionFieldDielectric(self, dielectric):
        self._rf_dielectric = float(dielectric)

    def getEwaldErrorTolerance(self):
        return self._ewald_tolerance

    def setEwaldErrorTolerance(self, tol):
        self._ewald_tolerance = float(tol)

    def getUseDispersionCorrection(self):
        return self._dispersion_correction

    def setUseDispersionCorrection(self, use):
        self._dispersion_correction = bool(use)

    def getIncludeDirectSpace(self):
        return self._include_direct

    def setIncludeDirectSpace(self, include):
        self._include_direct = bool(include)

    def getReciprocalSpaceForceGroup(self):
        return self._recip_group

    def setReciprocalSpaceForceGroup(self, group):
        if group < -1 or group > 31:
            raise OpenMMException("Reciprocal-space force group must be between -1 and 31")
        self._recip_group = int(group)

    def getPMEParameters(self):
        return tuple(self._pme_params)

    def setPMEParameters(self, alpha, nx, ny, nz):
        self._pme_params = [float(alpha), int(nx), int(ny), int(nz)]

    def getLJPMEParameters(self):
        return tuple(self._ljpme_params)

    def setLJPMEParameters(self, alpha, nx, ny, nz):
        self._ljpme_params = [float(alpha), int(nx), int(ny), int(nz)]

    def getExceptionsUsePeriodicBoundaryConditions(self):
        return self._exceptions_use_periodic

    def setExceptionsUsePeriodicBoundaryConditions(self, periodic):
        self._exceptions_use_periodic = bool(periodic)

    def usesPeriodicBoundaryConditions(self):
        return self._method in (self.CutoffPeriodic, self.Ewald, self.PME, self.LJPME)

    # --------------------------------------------------------------- particles

    def addParticle(self, charge, sigma, epsilon):
        self._particles.append([float(charge), float(sigma), float(epsilon)])
        return len(self._particles) - 1

    def addParticles(self, parameters):
        """Bulk addParticle: ``parameters`` is an (N, 3) array-like of
        [charge, sigma, epsilon] rows.  Returns the index of the first
        particle added."""
        import numpy as np
        arr = np.asarray(parameters, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise OpenMMException(
                "addParticles expects an (N, 3) array of "
                "[charge, sigma, epsilon] rows")
        first = len(self._particles)
        self._particles.extend(arr.tolist())
        return first

    def getNumParticles(self):
        return len(self._particles)

    def getParticleParameters(self, index):
        return tuple(self._particles[index])

    def setParticleParameters(self, index, charge, sigma, epsilon):
        self._particles[index] = [float(charge), float(sigma), float(epsilon)]

    # -------------------------------------------------------------- exceptions

    def addException(self, particle1, particle2, chargeProd, sigma, epsilon, replace=False):
        key = (min(particle1, particle2), max(particle1, particle2))
        if key in self._exception_map:
            if not replace:
                raise OpenMMException(
                    "NonbondedForce: There is already an exception for particles "
                    f"{particle1} and {particle2}")
            idx = self._exception_map[key]
            self._exceptions[idx] = [int(particle1), int(particle2),
                                     float(chargeProd), float(sigma), float(epsilon)]
            return idx
        self._exceptions.append([int(particle1), int(particle2),
                                 float(chargeProd), float(sigma), float(epsilon)])
        idx = len(self._exceptions) - 1
        self._exception_map[key] = idx
        return idx

    def getNumExceptions(self):
        return len(self._exceptions)

    def getExceptionParameters(self, index):
        return tuple(self._exceptions[index])

    def setExceptionParameters(self, index, particle1, particle2, chargeProd, sigma, epsilon):
        old = self._exceptions[index]
        old_key = (min(old[0], old[1]), max(old[0], old[1]))
        new_key = (min(particle1, particle2), max(particle1, particle2))
        if new_key != old_key:
            if new_key in self._exception_map:
                raise OpenMMException(
                    "NonbondedForce: There is already an exception for particles "
                    f"{particle1} and {particle2}")
            del self._exception_map[old_key]
            self._exception_map[new_key] = index
        self._exceptions[index] = [int(particle1), int(particle2),
                                   float(chargeProd), float(sigma), float(epsilon)]

    def createExceptionsFromBonds(self, bonds, coulomb14Scale, lj14Scale):
        """Create exclusions for 1-2/1-3 pairs and scaled 1-4 exceptions.

        Follows OpenMM's NonbondedForce::createExceptionsFromBonds semantics:
        1-2 and 1-3 pairs become full exclusions (chargeProd=0, sigma=1,
        epsilon=0); 1-4 pairs get chargeProd = c14*q1*q2,
        sigma = (s1+s2)/2, epsilon = lj14*sqrt(e1*e2).
        """
        n = self.getNumParticles()
        for (p1, p2) in bonds:
            if p1 < 0 or p2 < 0 or p1 >= n or p2 >= n:
                raise OpenMMException("createExceptionsFromBonds: Illegal particle index in list of bonds")
        bonded12 = [set() for _ in range(n)]
        for (p1, p2) in bonds:
            bonded12[p1].add(p2)
            bonded12[p2].add(p1)

        def neighbors_within(i, depth):
            # all atoms within `depth+1` bonds of atom i
            out = set()
            frontier = {i}
            for _ in range(depth + 1):
                nxt = set()
                for a in frontier:
                    nxt |= bonded12[a]
                out |= nxt
                frontier = nxt
            out.discard(i)
            return out

        for i in range(n):
            within3 = neighbors_within(i, 2)   # 1-2, 1-3, 1-4
            within2 = neighbors_within(i, 1)   # 1-2, 1-3
            for j in sorted(within3):
                if j < i:
                    if j in within2:
                        self.addException(j, i, 0.0, 1.0, 0.0, replace=True)
                    else:
                        q1, s1, e1 = self._particles[i][:3]
                        q2, s2, e2 = self._particles[j][:3]
                        self.addException(j, i, coulomb14Scale * q1 * q2,
                                          0.5 * (s1 + s2), lj14Scale * math.sqrt(e1 * e2),
                                          replace=True)

    # --------------------------------------------------- globals & offsets

    def addGlobalParameter(self, name, defaultValue):
        self._global_params.append([str(name), float(defaultValue)])
        return len(self._global_params) - 1

    def getNumGlobalParameters(self):
        return len(self._global_params)

    def getGlobalParameterName(self, index):
        return self._global_params[index][0]

    def setGlobalParameterName(self, index, name):
        self._global_params[index][0] = str(name)

    def getGlobalParameterDefaultValue(self, index):
        return self._global_params[index][1]

    def setGlobalParameterDefaultValue(self, index, value):
        self._global_params[index][1] = float(value)

    def _global_parameter_index(self, name):
        for i, (n, _) in enumerate(self._global_params):
            if n == name:
                return i
        raise OpenMMException(f"There is no global parameter called '{name}'")

    def addParticleParameterOffset(self, parameter, particleIndex, chargeScale,
                                   sigmaScale, epsilonScale):
        self._global_parameter_index(parameter)
        self._particle_offsets.append([str(parameter), int(particleIndex),
                                       float(chargeScale), float(sigmaScale), float(epsilonScale)])
        return len(self._particle_offsets) - 1

    def getNumParticleParameterOffsets(self):
        return len(self._particle_offsets)

    def getParticleParameterOffset(self, index):
        return tuple(self._particle_offsets[index])

    def setParticleParameterOffset(self, index, parameter, particleIndex, chargeScale,
                                   sigmaScale, epsilonScale):
        self._global_parameter_index(parameter)
        self._particle_offsets[index] = [str(parameter), int(particleIndex),
                                         float(chargeScale), float(sigmaScale), float(epsilonScale)]

    def addExceptionParameterOffset(self, parameter, exceptionIndex, chargeProdScale,
                                    sigmaScale, epsilonScale):
        self._global_parameter_index(parameter)
        self._exception_offsets.append([str(parameter), int(exceptionIndex),
                                        float(chargeProdScale), float(sigmaScale), float(epsilonScale)])
        return len(self._exception_offsets) - 1

    def getNumExceptionParameterOffsets(self):
        return len(self._exception_offsets)

    def getExceptionParameterOffset(self, index):
        return tuple(self._exception_offsets[index])

    def setExceptionParameterOffset(self, index, parameter, exceptionIndex, chargeProdScale,
                                    sigmaScale, epsilonScale):
        self._global_parameter_index(parameter)
        self._exception_offsets[index] = [str(parameter), int(exceptionIndex),
                                          float(chargeProdScale), float(sigmaScale), float(epsilonScale)]

    # ------------------------------------------------------------ in-context

    def updateParametersInContext(self, context):
        """Push parameter changes into an existing context without recompiling
        shapes (reference: SlicedNonbondedForceImpl.cpp:356-359)."""
        context._update_force_parameters(self)

    def getPMEParametersInContext(self, context):
        return context._get_pme_parameters(self, dispersion=False)

    def getLJPMEParametersInContext(self, context):
        return context._get_pme_parameters(self, dispersion=True)


class _ScalingParameterInfo:
    __slots__ = ("global_param_index", "subset1", "subset2", "include_coulomb", "include_lj")

    def __init__(self, global_param_index, subset1, subset2, include_coulomb, include_lj):
        if not (include_coulomb or include_lj):
            raise OpenMMException(
                "Keywords 'includeCoulomb' and 'includeLJ' cannot be both false")
        self.global_param_index = global_param_index
        self.subset1 = subset1
        self.subset2 = subset2
        self.include_coulomb = include_coulomb
        self.include_lj = include_lj

    @property
    def slice(self):
        return slice_index(self.subset1, self.subset2)

    def clashes_with(self, other):
        return self.slice == other.slice and (
            (self.include_coulomb and other.include_coulomb)
            or (self.include_lj and other.include_lj))


class SlicedNonbondedForce(NonbondedForce):
    """The sliced nonbonded force.

    Particles are partitioned into ``numSubsets`` disjoint subsets; the
    unordered subset pair (I, J) defines one of n(n+1)/2 slices, and the total
    energy is ``E = sum_{I<=J} lambda_vdw[I,J]*E_vdw[I,J] +
    lambda_elec[I,J]*E_elec[I,J]`` where each lambda defaults to 1 but can be
    bound to a Context global parameter via :meth:`addScalingParameter`, with
    exact dE/dlambda derivatives available through
    :meth:`addEnergyParameterDerivative` (reference: README.md:9-24).
    """

    def __init__(self, arg, numSubsets=None):
        super().__init__()
        if isinstance(arg, NonbondedForce):
            if numSubsets is None:
                raise TypeError("SlicedNonbondedForce(force, numSubsets) requires numSubsets")
            self._num_subsets = int(numSubsets)
            self._copy_from(arg)
        else:
            if numSubsets is not None:
                raise TypeError("SlicedNonbondedForce(numSubsets) takes one argument")
            self._num_subsets = int(arg)
        self._subsets = {}
        self._scaling_params = []
        self._energy_param_derivs = []
        # analog of the reference's useCuFFT backend toggle
        # (SlicedNonbondedForce.h:53-58); the FFTs here always go through
        # torch.fft, so this only records user preference.
        self._use_cufft = True

    def _copy_from(self, force):
        # mirrors the deep-copy ctor (SlicedNonbondedForce.cpp:34-82)
        self.setForceGroup(force.getForceGroup())
        self.setName(force.getName())
        self.setNonbondedMethod(force.getNonbondedMethod())
        self.setCutoffDistance(force.getCutoffDistance())
        self.setUseSwitchingFunction(force.getUseSwitchingFunction())
        self.setSwitchingDistance(force.getSwitchingDistance())
        self.setEwaldErrorTolerance(force.getEwaldErrorTolerance())
        self.setReactionFieldDielectric(force.getReactionFieldDielectric())
        self.setUseDispersionCorrection(force.getUseDispersionCorrection())
        self.setIncludeDirectSpace(force.getIncludeDirectSpace())
        self.setPMEParameters(*force.getPMEParameters())
        self.setLJPMEParameters(*force.getLJPMEParameters())
        self.setReciprocalSpaceForceGroup(force.getReciprocalSpaceForceGroup())
        for i in range(force.getNumParticles()):
            self.addParticle(*force.getParticleParameters(i))
        for i in range(force.getNumExceptions()):
            self.addException(*force.getExceptionParameters(i))
        self.setExceptionsUsePeriodicBoundaryConditions(
            force.getExceptionsUsePeriodicBoundaryConditions())
        for i in range(force.getNumGlobalParameters()):
            self.addGlobalParameter(force.getGlobalParameterName(i),
                                    force.getGlobalParameterDefaultValue(i))
        for i in range(force.getNumParticleParameterOffsets()):
            self.addParticleParameterOffset(*force.getParticleParameterOffset(i))
        for i in range(force.getNumExceptionParameterOffsets()):
            self.addExceptionParameterOffset(*force.getExceptionParameterOffset(i))

    # ----------------------------------------------------------------- subsets

    def getNumSubsets(self):
        return self._num_subsets

    def getNumSlices(self):
        return self._num_subsets * (self._num_subsets + 1) // 2

    def setParticleSubset(self, index, subset):
        if index < 0 or index >= self.getNumParticles():
            raise OpenMMException("setParticleSubset: index out of range")
        if subset < 0 or subset >= self._num_subsets:
            raise OpenMMException("setParticleSubset: subset out of range")
        self._subsets[int(index)] = int(subset)

    def getParticleSubset(self, index):
        if index < 0 or index >= self.getNumParticles():
            raise OpenMMException("getParticleSubset: index out of range")
        return self._subsets.get(int(index), 0)

    def setParticleSubsets(self, indices, subsets):
        """Bulk setParticleSubset: ``indices`` is an array-like of particle
        indices, ``subsets`` a matching array-like (or one scalar broadcast
        to all)."""
        import numpy as np
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        sub = np.broadcast_to(np.asarray(subsets, dtype=np.int64),
                              idx.shape).reshape(-1)
        n = self.getNumParticles()
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise OpenMMException("setParticleSubsets: index out of range")
        if sub.size and (sub.min() < 0 or sub.max() >= self._num_subsets):
            raise OpenMMException("setParticleSubsets: subset out of range")
        self._subsets.update(zip(idx.tolist(), sub.tolist()))

    # ------------------------------------------------------- scaling params

    def getNumScalingParameters(self):
        return len(self._scaling_params)

    def addScalingParameter(self, parameter, subset1, subset2, includeCoulomb, includeLJ):
        if not (0 <= subset1 < self._num_subsets and 0 <= subset2 < self._num_subsets):
            raise OpenMMException("addScalingParameter: subset out of range")
        info = _ScalingParameterInfo(self._global_parameter_index(parameter),
                                     subset1, subset2, bool(includeCoulomb), bool(includeLJ))
        for param in self._scaling_params:
            if param.clashes_with(info):
                raise OpenMMException("Clash detected between scaling parameters")
        self._scaling_params.append(info)
        return len(self._scaling_params) - 1

    def getScalingParameter(self, index):
        if index < 0 or index >= len(self._scaling_params):
            raise OpenMMException("getScalingParameter: index out of range")
        info = self._scaling_params[index]
        return (self.getGlobalParameterName(info.global_param_index),
                info.subset1, info.subset2, info.include_coulomb, info.include_lj)

    def setScalingParameter(self, index, parameter, subset1, subset2, includeCoulomb, includeLJ):
        if index < 0 or index >= len(self._scaling_params):
            raise OpenMMException("setScalingParameter: index out of range")
        if not (0 <= subset1 < self._num_subsets and 0 <= subset2 < self._num_subsets):
            raise OpenMMException("setScalingParameter: subset out of range")
        info = _ScalingParameterInfo(self._global_parameter_index(parameter),
                                     subset1, subset2, bool(includeCoulomb), bool(includeLJ))
        old = self._scaling_params[index]
        if not old.clashes_with(info):
            for param in self._scaling_params:
                if param.clashes_with(info):
                    raise OpenMMException(
                        "A scaling parameter has already been defined for this "
                        "slice & contribution(s)")
        self._scaling_params[index] = info

    def _scaling_parameter_index(self, parameter):
        for i, info in enumerate(self._scaling_params):
            if self.getGlobalParameterName(info.global_param_index) == parameter:
                return i
        raise OpenMMException(f"There is no scaling parameter called '{parameter}'")

    # --------------------------------------------------- energy derivatives

    def getNumEnergyParameterDerivatives(self):
        return len(self._energy_param_derivs)

    def addEnergyParameterDerivative(self, parameter):
        idx = self._scaling_parameter_index(parameter)
        if idx in self._energy_param_derivs:
            raise OpenMMException("This scaling parameter derivative has already been requested")
        self._energy_param_derivs.append(idx)
        return len(self._energy_param_derivs) - 1

    def getEnergyParameterDerivativeName(self, index):
        if index < 0 or index >= len(self._energy_param_derivs):
            raise OpenMMException("getEnergyParameterDerivativeName: index out of range")
        info = self._scaling_params[self._energy_param_derivs[index]]
        return self.getGlobalParameterName(info.global_param_index)

    # --------------------------------------------------------------- backend

    def getUseCuFFT(self):
        return self._use_cufft

    def setUseCuFFT(self, use):
        self._use_cufft = bool(use)

    @staticmethod
    def cast(force):
        """Mirror of the SWIG cast helper (python/nonbondedslicing.i:404-412)."""
        if not isinstance(force, SlicedNonbondedForce):
            raise OpenMMException("Force is not a SlicedNonbondedForce")
        return force

    @staticmethod
    def isinstance(force):
        return isinstance(force, SlicedNonbondedForce)
