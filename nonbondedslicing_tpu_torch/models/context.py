"""Context / State / Integrator / Platform: the user API over the engines.

The port of the JAX package's ``models/context.py``, the analog of OpenMM's
Context plus the reference's force-impl dispatch
(SlicedNonbondedForceImpl::calcForcesAndEnergy,
openmmapi/src/SlicedNonbondedForceImpl.cpp:135-142):

* ``includeDirect = includeDirectSpace and (groups >> forceGroup) & 1``
* reciprocal group defaults to the force group; reciprocal space contributes
  when its group bit is set

Each SlicedNonbondedForce gets one plan and one set of parameter tensors
(``ops.engine.plan_data``) on the Context's device, and one
``ops.engine.make_compute`` per (includeDirect, includeReciprocal); global
parameters (lambdas and offsets) are tensor inputs, so ``setParameter``
never rebuilds anything, and ``updateParametersInContext`` writes the new
values into the same tensors, so that the MD step's CUDA graphs stay
valid.  ``integrator.step`` runs ``runtime.fastpath.make_md_step`` where
the system allows it (one SlicedNonbondedForce plus harmonic bonds, float32
or mixed precision, the default box), else a per-step loop on the host.

The Context runs on ``torch.device("cuda")`` unless the platform property
``"Device"`` is ``"cpu"``; without a CUDA device it raises.
"""

import numpy as np
import torch

from ..ops import engine as engine_mod
from ..ops import plan as plan_mod
from ..ops.geometry import min_image
from ..ops.params import slice_lambdas
from ..ops.plan import EWALD_METHODS
from ..runtime import profiling
from .force import (HarmonicBondForce, NonbondedForce, OpenMMException,
                    SlicedNonbondedForce)

KB = 8.31446261815324e-3      # kJ/mol/K
ALL_GROUPS = (1 << 32) - 1


class Platform:
    """Named execution platform.

    * ``CUDA``: the default, single precision unless its ``Precision``
      property says ``mixed`` or ``double``.
    * ``Reference``: double precision, the parity oracle, mirroring the
      reference's Reference platform.

    Both run on the device named by the ``Device`` property: ``"cuda"``
    (the default) or ``"cpu"``.
    """

    _names = ("CUDA", "Reference")

    def __init__(self, name, properties=None):
        self.name = name
        self.properties = dict(properties or {})

    @classmethod
    def getPlatformByName(cls, name):
        if name == "Reference":
            return cls("Reference", {"Precision": "double", "Device": "cuda"})
        if name == "CUDA":
            return cls("CUDA", {"Precision": "single", "Device": "cuda"})
        raise OpenMMException(f"There is no platform called '{name}'")

    @classmethod
    def getNumPlatforms(cls):
        return len(cls._names)

    @classmethod
    def getPlatform(cls, index):
        try:
            return cls.getPlatformByName(cls._names[index])
        except IndexError:
            raise OpenMMException(
                f"There is no platform with index {index}")

    @classmethod
    def findPlatform(cls, kernelNames=()):
        """Fastest platform (OpenMM Platform::findPlatform analog); every
        kernel is implemented by both platforms here."""
        return cls.getPlatformByName("CUDA")

    def getName(self):
        return self.name

    def getSpeed(self):
        """Relative speed estimate (OpenMM Platform::getSpeed semantics:
        larger = faster; Reference is the 1.0 anchor)."""
        return 1.0 if self.name == "Reference" else 100.0

    def supportsDoublePrecision(self):
        return True

    def getPropertyNames(self):
        return sorted(self.properties)

    def getPropertyDefaultValue(self, prop):
        return self.properties.get(prop, "")

    def getPropertyValue(self, context, prop):
        plat = context.getPlatform()
        if prop not in plat.properties:
            raise OpenMMException(
                f"Platform '{plat.name}' has no property '{prop}'")
        return plat.properties[prop]

    def setPropertyValue(self, context, prop, value):
        plat = context.getPlatform()
        if prop not in plat.properties:
            raise OpenMMException(
                f"Platform '{plat.name}' has no property '{prop}'")
        raise OpenMMException(
            f"{prop} is fixed at Context creation; build a new Context "
            "with Platform properties instead.")


class State:
    def __init__(self, positions=None, velocities=None, forces=None,
                 energy=None, derivatives=None, box=None):
        self._positions = positions
        self._velocities = velocities
        self._forces = forces
        self._energy = energy
        self._derivatives = derivatives or {}
        self._box = box

    def getPotentialEnergy(self):
        return self._energy

    def getForces(self):
        return self._forces

    def getPositions(self):
        return self._positions

    def getVelocities(self):
        return self._velocities

    def getEnergyParameterDerivatives(self):
        return dict(self._derivatives)

    def getPeriodicBoxVectors(self):
        return self._box


class VerletIntegrator:
    """Leapfrog Verlet integrator.  ``step()`` applies the system's distance
    constraints (M-SHAKE/RATTLE, SETTLE for rigid water) around each leapfrog
    update, on both the fused fast path and the per-step fallback (see
    Context._integrate)."""

    def __init__(self, step_size):
        self._dt = float(step_size)
        self._context = None

    def getStepSize(self):
        return self._dt

    def setStepSize(self, dt):
        self._dt = float(dt)

    def step(self, steps):
        if self._context is None:
            raise OpenMMException("Integrator is not bound to a context")
        self._context._integrate(int(steps), self._dt)


class _CompiledSliced:
    """One SlicedNonbondedForce: its plan, its parameter tensors on the
    Context's device and dtype, the cell-capacity growth, one
    ``make_compute`` per (direct, reciprocal, capacity) and the MD runs of
    the fast path."""

    def __init__(self, force, system, dtype, device):
        self.force = force
        self.plan = plan_mod.build_plan(force, system)
        self.dtype = dtype
        self.device = device
        self.data = engine_mod.plan_data(self.plan, device=device,
                                         dtype=dtype)
        self.neighbor = "auto"
        self.capacity_scale = 1
        self._fns = {}
        self.md = {}          # dt -> dict(reuse, cap, runs)

    def refresh(self, force, system):
        """New parameter values (``plan.refresh_plan``) written into the
        existing tensors with ``copy_``: the MD step's CUDA graphs read
        them where they lie, so new tensors would drop every graph."""
        self.plan = plan_mod.refresh_plan(self.plan, force, system)
        new = engine_mod.plan_data(self.plan, device=self.device,
                                   dtype=self.dtype)
        for key, value in new.items():
            old = self.data[key]
            if old.shape != value.shape:
                raise OpenMMException(
                    f"updateParametersInContext: the shape of '{key}' has "
                    "changed; call reinitialize() instead")
            if not torch.equal(old, value):
                old.copy_(value)

    def cell_capacity(self):
        """Static cell capacity after overflow-driven growth (None = the
        engine default)."""
        if self.capacity_scale == 1 or self.plan.box0 is None:
            return None
        from ..ops.neighbors import choose_cell_grid
        cfg = choose_cell_grid(self.plan.box0, self.plan.cutoff,
                               self.plan.num_particles)
        if cfg is None:
            return None
        return min(cfg[1] * self.capacity_scale, self.plan.num_particles)

    def grow_capacity(self):
        """Double the cell capacity after an overflow (a system denser than
        the uniform-density sizing).  Returns False once the capacity
        already holds every particle (overflow impossible)."""
        cap = self.cell_capacity()
        if cap is not None and cap >= self.plan.num_particles:
            return False
        self.capacity_scale *= 2
        self._fns = {k: v for k, v in self._fns.items()
                     if k[2] == self.capacity_scale}
        return True

    def fn(self, include_direct, include_reciprocal):
        """The generic engine for this (direct, reciprocal) pair.  Where
        the plan is past the cell kernel's limits, ``neighbor="auto"``
        raises ValueError (ROADMAP D7); the Context then builds the plain
        cell list, ``neighbor="cell"``, for this force."""
        key = (include_direct, include_reciprocal, self.capacity_scale)
        if key not in self._fns:
            kw = dict(cell_capacity=self.cell_capacity(), with_aux=True)
            try:
                compute = engine_mod.make_compute(
                    self.plan, include_direct, include_reciprocal,
                    neighbor=self.neighbor, **kw)
            except ValueError:
                if self.neighbor != "auto":
                    raise
                self.neighbor = "cell"
                compute = engine_mod.make_compute(
                    self.plan, include_direct, include_reciprocal,
                    neighbor="cell", **kw)
            self._fns[key] = compute
        return self._fns[key]


def _device_of(platform):
    """The torch device a platform's ``Device`` property names; raises
    OpenMMException for a CUDA device on a machine without one."""
    name = platform.properties.get("Device", "cuda")
    try:
        device = torch.device(name)
    except (RuntimeError, TypeError) as exc:
        raise OpenMMException(f"Unknown Device '{name}' (cuda|cpu)") from exc
    if device.type not in ("cuda", "cpu"):
        raise OpenMMException(f"Unsupported Device '{name}' (cuda|cpu)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise OpenMMException(
            "No CUDA device is available; set the platform property "
            "'Device' to 'cpu' to run on the CPU.")
    return device


class Context:
    def __init__(self, system, integrator, platform=None, properties=None):
        self._system = system
        self._integrator = integrator
        integrator._context = self
        plat = platform or Platform.getPlatformByName("CUDA")
        self._platform = Platform(plat.name, {**plat.properties,
                                              **(properties or {})})
        precision = self._platform.properties.get("Precision", "single")
        if precision not in ("single", "mixed", "double"):
            raise OpenMMException(
                f"Unsupported Precision '{precision}' (single|mixed|double)")
        self._precision = precision
        # as in the JAX package, "mixed" changes only integrator.step
        # (float64 positions); evaluations run in float32
        self._dtype = torch.float64 if precision == "double" else torch.float32
        self._device = _device_of(self._platform)
        n = system.getNumParticles()
        self._positions = np.zeros((n, 3))
        self._velocities = np.zeros((n, 3))
        self._box = np.array(system.getDefaultPeriodicBoxVectors(),
                             dtype=np.float64)
        self._parameters = {}
        self._compiled = {}
        self._initialize()

    # ------------------------------------------------------------ lifecycle

    def _initialize(self):
        self._compiled = {}
        self._constraint_clusters = "unset"
        self._mol_ids = None
        params = {}
        for force in self._system.getForces():
            if isinstance(force, SlicedNonbondedForce):
                self._compiled[id(force)] = _CompiledSliced(
                    force, self._system, self._dtype, self._device)
            if isinstance(force, NonbondedForce):
                for i in range(force.getNumGlobalParameters()):
                    params.setdefault(force.getGlobalParameterName(i),
                                      force.getGlobalParameterDefaultValue(i))
        old = self._parameters
        self._parameters = {k: old.get(k, v) for k, v in params.items()}

    def reinitialize(self, preserveState=False):
        positions = self._positions.copy()
        velocities = self._velocities.copy()
        box = self._box.copy()
        parameters = dict(self._parameters)
        self._parameters = {}
        self._box = np.array(self._system.getDefaultPeriodicBoxVectors(),
                             dtype=np.float64)
        self._initialize()
        if preserveState:
            self._positions = positions
            self._velocities = velocities
            self._box = box
            for k in list(self._parameters):
                if k in parameters:
                    self._parameters[k] = parameters[k]

    def getSystem(self):
        return self._system

    def getIntegrator(self):
        return self._integrator

    def getPlatform(self):
        return self._platform

    # ----------------------------------------------------------- positions

    def setPositions(self, positions):
        arr = np.asarray([[p[0], p[1], p[2]] for p in positions],
                         dtype=np.float64)
        if arr.shape != (self._system.getNumParticles(), 3):
            raise OpenMMException("setPositions: wrong number of positions")
        self._positions = arr

    def setVelocities(self, velocities):
        self._velocities = np.asarray(velocities,
                                      dtype=np.float64).reshape(-1, 3)

    def setVelocitiesToTemperature(self, temperature, seed=0):
        """Maxwell-Boltzmann velocities from ``np.random.default_rng(seed)``
        (the JAX package's draw, so both packages draw the same)."""
        rng = np.random.default_rng(seed)
        masses = self._masses()
        sigma = np.sqrt(KB * temperature / np.maximum(masses, 1e-12))
        self._velocities = rng.normal(size=(len(masses), 3)) * sigma[:, None]

    def setPeriodicBoxVectors(self, a, b, c):
        self._box = np.array([a, b, c], dtype=np.float64)

    def getPeriodicBoxVectors(self):
        return [tuple(v) for v in self._box]

    def _masses(self):
        return np.array([self._system.getParticleMass(i)
                         for i in range(self._system.getNumParticles())])

    # ---------------------------------------------------------- parameters

    def setParameter(self, name, value):
        if name not in self._parameters:
            raise OpenMMException(f"There is no parameter called '{name}'")
        self._parameters[name] = float(value)

    def getParameter(self, name):
        if name not in self._parameters:
            raise OpenMMException(f"There is no parameter called '{name}'")
        return self._parameters[name]

    def getParameters(self):
        return dict(self._parameters)

    # -------------------------------------------------------------- compute

    def _group_mask(self, groups):
        if groups is None:
            return ALL_GROUPS
        if isinstance(groups, (set, frozenset, list, tuple)):
            mask = 0
            for g in groups:
                mask |= 1 << g
            return mask
        return int(groups) & ALL_GROUPS

    def _check_box(self, force, comp):
        method = force.getNonbondedMethod()
        if method not in (NonbondedForce.CutoffPeriodic,) + tuple(
                EWALD_METHODS):
            return
        min_size = 1.999999 * force.getCutoffDistance()
        if (self._box[0][0] < min_size or self._box[1][1] < min_size
                or self._box[2][2] < min_size):
            raise OpenMMException(
                "The periodic box size has decreased to less than twice "
                "the nonbonded cutoff.")
        # the cell grid is sized from the plan's default box; if the
        # runtime box shrank so far that a cell's perpendicular width falls
        # below the cutoff, in-range pairs would be missed (the reference
        # rebuilds its neighbor list from the current box each evaluation)
        plan = comp.plan
        if (plan.box0 is None or plan.num_particles
                < engine_mod._CELL_LIST_MIN_PARTICLES):
            return
        from ..ops.neighbors import _perpendicular_widths, choose_cell_grid
        cfg = choose_cell_grid(plan.box0, plan.cutoff, plan.num_particles)
        if cfg is not None and np.any(
                _perpendicular_widths(self._box) / np.asarray(cfg[0])
                < plan.cutoff):
            raise OpenMMException(
                "The periodic box has shrunk below the neighbor-cell grid "
                "sized from the default box; call reinitialize() after "
                "changing the box vectors.")

    def _tensor(self, array, dtype):
        return profiling.to_device(np.asarray(array, dtype=np.float64),
                                   self._device).to(dtype)

    def _gvals_np(self, comp):
        return np.array([self._parameters[name]
                         for name in comp.plan.global_names],
                        dtype=np.float64)

    def _gvals(self, comp):
        return self._tensor(self._gvals_np(comp), comp.dtype)

    def _evaluate(self, groups_mask):
        """Energy, forces (numpy float64) and dE/dlambda summed over every
        force of the groups in ``groups_mask``."""
        n = self._system.getNumParticles()
        total_energy = 0.0
        total_forces = np.zeros((n, 3))
        # every requested derivative appears in the map, zero when its force
        # group was not evaluated (OpenMM map semantics)
        derivs = {}
        for comp in self._compiled.values():
            for name in comp.plan.deriv_names:
                derivs.setdefault(name, 0.0)
        for force in self._system.getForces():
            if isinstance(force, SlicedNonbondedForce):
                comp = self._compiled[id(force)]
                include_direct = (force.getIncludeDirectSpace() and bool(
                    groups_mask >> force.getForceGroup() & 1))
                recip_group = force.getReciprocalSpaceForceGroup()
                if recip_group < 0:
                    recip_group = force.getForceGroup()
                include_reciprocal = (
                    force.getNonbondedMethod() in EWALD_METHODS
                    and bool(groups_mask >> recip_group & 1))
                if not (include_direct or include_reciprocal):
                    continue
                with profiling.span("nbs.eval"):
                    self._check_box(force, comp)
                    e, f, d = self._evaluate_sliced(comp, include_direct,
                                                    include_reciprocal)
                total_energy += e
                total_forces += f
                for name, val in zip(comp.plan.deriv_names, d):
                    derivs[name] += val
            elif isinstance(force, HarmonicBondForce):
                if not (groups_mask >> force.getForceGroup() & 1):
                    continue
                with profiling.span("nbs.bonds"):
                    e, f = self._harmonic_bonds(force)
                total_energy += e
                total_forces += f
        return total_energy, total_forces, derivs

    def _evaluate_sliced(self, comp, include_direct, include_reciprocal):
        """One force's (energy, forces, dE/dlambda list).  A cell-capacity
        overflow grows the capacity and evaluates again (atoms are never
        dropped: the reference's voxel hash is exact every call,
        ReferenceNonbondedSlicingKernels.cpp:197).  On the cell kernel's
        route in float32, an excluded pair a cell width or more apart
        raises: the kernel corrects only the excluded pairs it meets among
        the 27 neighbour cells."""
        with profiling.span("nbs.eval.copy_in"):
            positions = self._tensor(self._positions, comp.dtype)
            box = self._tensor(self._box, comp.dtype)
            gvals = self._gvals(comp)
        while True:
            fn = comp.fn(include_direct, include_reciprocal)
            with profiling.span("nbs.eval.engine"):
                slice_e, forces, aux = fn(positions, box, gvals, comp.data)
            with profiling.span("nbs.eval.guard"):
                span = aux.get("excl_span")
                guards = profiling.to_list(torch.stack(
                    [aux["overflow"].to(torch.float64),
                     torch.zeros((), dtype=torch.float64, device=self._device)
                     if span is None else span]))
            if guards[0] == 0:
                break
            if not comp.grow_capacity():
                raise OpenMMException(
                    "Internal error: cell capacity covers all particles yet "
                    "the occupancy table overflowed")
            profiling.count("eval.capacity_grows")
        if guards[1] >= 1.0 and comp.dtype == torch.float32:
            raise OpenMMException(
                "SlicedNonbondedForce: an excluded pair spans more than one "
                f"neighbor-list cell ({guards[1]:.3f} cell widths); the cell "
                "kernel corrects only the excluded pairs of neighbouring "
                "cells, so excluded pairs must be bonded-range. Use the "
                "Reference platform.")
        with profiling.span("nbs.eval.reduce"):
            lam = slice_lambdas(profiling.to_device(
                comp.plan.lam_source.astype(np.int64), self._device), gvals)
            energy = profiling.to_list(
                engine_mod.contract_energy(slice_e, lam))
            derivs = []
            if comp.plan.deriv_names:
                derivs = profiling.to_list(engine_mod.parameter_derivatives(
                    slice_e, comp.plan.deriv_mask))
        with profiling.span("nbs.eval.copy_out"):
            forces = profiling.to_host(forces)
        return energy, forces, derivs

    def _harmonic_bonds(self, force):
        if force.getNumBonds() == 0:
            return 0.0, 0.0
        bonds = np.array([force.getBondParameters(i)
                          for i in range(force.getNumBonds())])
        i = bonds[:, 0].astype(int)
        j = bonds[:, 1].astype(int)
        r0 = bonds[:, 2]
        k = bonds[:, 3]
        dr = self._positions[i] - self._positions[j]
        if force.usesPeriodicBoundaryConditions():
            dr = min_image(torch.as_tensor(dr),
                           torch.as_tensor(self._box)).numpy()
        r = np.sqrt(np.sum(dr * dr, axis=-1))
        e = float(np.sum(0.5 * k * (r - r0) ** 2))
        dedr = k * (r - r0) / np.maximum(r, 1e-12)
        f = np.zeros_like(self._positions)
        np.add.at(f, i, -dedr[:, None] * dr)
        np.add.at(f, j, dedr[:, None] * dr)
        return e, f

    def _molecule_ids(self):
        """Connected components over constraints, harmonic bonds and
        nonbonded exceptions (OpenMM's molecule definition for
        enforcePeriodicBox).  Cached (structural)."""
        if self._mol_ids is not None:
            return self._mol_ids
        n = self._system.getNumParticles()
        parent = np.arange(n)

        def find(x):
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        for i in range(self._system.getNumConstraints()):
            a, b, _ = self._system.getConstraintParameters(i)
            union(a, b)
        for force in self._system.getForces():
            if isinstance(force, HarmonicBondForce):
                for i in range(force.getNumBonds()):
                    a, b = force.getBondParameters(i)[:2]
                    union(int(a), int(b))
            elif isinstance(force, NonbondedForce):
                for i in range(force.getNumExceptions()):
                    a, b = force.getExceptionParameters(i)[:2]
                    union(int(a), int(b))
        roots = np.array([find(i) for i in range(n)])
        _, self._mol_ids = np.unique(roots, return_inverse=True)
        return self._mol_ids

    def _wrap_molecules(self, positions):
        """Translate each molecule by whole box vectors so its geometric
        center lies in the primary box (OpenMM enforcePeriodicBox
        semantics: molecules stay whole)."""
        mol = self._molecule_ids()
        n_mol = int(mol.max()) + 1
        counts = np.bincount(mol, minlength=n_mol)[:, None]
        centers = np.zeros((n_mol, 3))
        np.add.at(centers, mol, positions)
        centers /= counts
        frac = centers @ np.linalg.inv(self._box)
        shift = np.floor(frac) @ self._box
        return positions - shift[mol]

    def getState(self, getPositions=False, getVelocities=False,
                 getForces=False, getEnergy=False,
                 getParameterDerivatives=False, enforcePeriodicBox=False,
                 groups=None):
        with profiling.span("nbs.getState"):
            return self._get_state(getPositions, getVelocities, getForces,
                                   getEnergy, getParameterDerivatives,
                                   enforcePeriodicBox, groups)

    def _get_state(self, getPositions, getVelocities, getForces, getEnergy,
                   getParameterDerivatives, enforcePeriodicBox, groups):
        energy = forces = None
        derivs = {}
        if getForces or getEnergy or getParameterDerivatives:
            energy, forces, derivs = self._evaluate(self._group_mask(groups))
        out_pos = None
        if getPositions:
            out_pos = self._positions
            if enforcePeriodicBox:
                out_pos = self._wrap_molecules(out_pos)
        return State(
            positions=[tuple(p) for p in out_pos] if getPositions else None,
            velocities=([tuple(v) for v in self._velocities]
                        if getVelocities else None),
            forces=[tuple(f) for f in forces] if getForces else None,
            energy=energy if getEnergy else None,
            derivatives=derivs,
            box=[tuple(v) for v in self._box],
        )

    # -------------------------------------------------- checkpoint / resume

    def createCheckpoint(self):
        """Dynamic state (positions, velocities, box, parameters) as bytes."""
        from ..runtime.checkpoint import create_checkpoint
        with profiling.span("nbs.checkpoint"):
            return create_checkpoint(self)

    def loadCheckpoint(self, blob):
        from ..runtime.checkpoint import load_checkpoint
        load_checkpoint(self, blob)

    # ---------------------------------------------- force-facing internals

    def _update_force_parameters(self, force):
        if isinstance(force, SlicedNonbondedForce):
            comp = self._compiled.get(id(force))
            if comp is None:
                raise OpenMMException(
                    "updateParametersInContext: force is not in this context")
            comp.refresh(force, self._system)
        # HarmonicBondForce reads its parameters at evaluation time

    def _get_pme_parameters(self, force, dispersion=False):
        comp = self._compiled.get(id(force))
        if comp is None:
            raise OpenMMException(
                "getPMEParametersInContext: force is not in this context")
        plan = comp.plan
        if dispersion:
            if plan.method != NonbondedForce.LJPME:
                raise OpenMMException(
                    "getPMEParametersInContext: This Context is not using "
                    "LJPME")
            return (plan.dispersion_alpha,) + tuple(plan.dispersion_grid)
        if plan.method not in (NonbondedForce.PME, NonbondedForce.LJPME):
            raise OpenMMException(
                "getPMEParametersInContext: This Context is not using PME or "
                "LJPME")
        return (plan.ewald_alpha,) + tuple(plan.pme_grid)

    # ----------------------------------------------------------- dynamics

    def _md_comp(self):
        """The one SlicedNonbondedForce's compiled state when the system
        takes the MD step of ``runtime/fastpath.py``: exactly one
        SlicedNonbondedForce with its direct space (the step always
        evaluates it) and optional HarmonicBondForces, float32 (single or
        mixed), and the runtime box equal to the plan's default box.  None
        otherwise: the per-step host loop runs."""
        forces = self._system.getForces()
        sliced = [f for f in forces if isinstance(f, SlicedNonbondedForce)]
        if len(sliced) != 1 or any(
                not isinstance(f, (SlicedNonbondedForce, HarmonicBondForce))
                for f in forces):
            return None
        if not sliced[0].getIncludeDirectSpace():
            return None
        comp = self._compiled[id(sliced[0])]
        box0 = comp.plan.box0
        if comp.dtype != torch.float32 or box0 is None or not np.allclose(
                self._box, np.asarray(box0), rtol=0.0,
                atol=1e-6 * float(np.max(np.abs(self._box)))):
            return None
        return comp

    def _md_run(self, comp, dt, reuse, cap):
        """``make_md_step`` for (dt, K, capacity), cached: K None is the
        mass-aware choice of ``make_md_step``, capacity None its default."""
        md = comp.md.setdefault(dt, dict(reuse=None, cap=None, runs={}))
        key = (reuse, cap)
        if key not in md["runs"]:
            from ..runtime.fastpath import make_md_step
            bonds, periodic = [], False
            for f in self._system.getForces():
                if isinstance(f, HarmonicBondForce):
                    bonds.extend(f.getBondParameters(i)
                                 for i in range(f.getNumBonds()))
                    periodic |= f.usesPeriodicBoundaryConditions()
            md["runs"][key] = make_md_step(
                comp.plan, self._masses(), dt, dtype=torch.float32,
                bonds=bonds or None, bonds_periodic=periodic,
                constraints=self._clustered_constraints(), reuse_steps=reuse,
                cell_capacity=cap,
                mixed_precision=self._precision == "mixed")
        return md["runs"][key]

    def _fast_md(self, comp, steps, dt):
        """``steps`` steps through ``make_md_step``.  A skin violation halves
        K (from the run's ``config``), a capacity overflow doubles the
        capacity; each retry is a new ``make_md_step`` (a new CUDA graph)
        from the positions before the attempt, which a tripped attempt
        never advances."""
        md = comp.md.setdefault(dt, dict(reuse=None, cap=None, runs={}))
        n = comp.plan.num_particles
        gvals = self._gvals_np(comp)
        while True:
            run = self._md_run(comp, dt, md["reuse"], md["cap"])
            try:
                pos, vel, _ = run(self._positions, self._velocities,
                                  self._box, gvals, comp.data, steps)
                break
            except OpenMMException as exc:
                md["runs"].pop((md["reuse"], md["cap"]), None)
                msg = str(exc)
                cap = run.config.get("capacity")
                if "skin violation" in msg and run.config["reuse_steps"] > 1:
                    md["reuse"] = max(1, run.config["reuse_steps"] // 2)
                elif "capacity overflow" in msg and cap is not None \
                        and cap < n:
                    md["cap"] = min(2 * cap, n)
                else:
                    raise
                profiling.count("md.retries")
        # float64 on the host between calls: under mixed precision the
        # positions keep their low bits from one step() to the next
        with profiling.span("nbs.step.copy_out"):
            self._positions = profiling.to_host(pos)
            self._velocities = profiling.to_host(vel)

    def _clustered_constraints(self):
        """System constraints as (pairs, dists, mask) M-SHAKE clusters, or
        None.  Cached per Context (constraints are structural)."""
        if self._constraint_clusters == "unset":
            from ..runtime.constraints import cluster_constraints
            cons = [self._system.getConstraintParameters(i)
                    for i in range(self._system.getNumConstraints())]
            self._constraint_clusters = cluster_constraints(
                cons, self._system.getNumParticles())
        return self._constraint_clusters

    def _integrate(self, steps, dt):
        with profiling.span("nbs.step"):
            self._step(steps, dt)

    def _step(self, steps, dt):
        comp = self._md_comp()
        if comp is not None:
            self._fast_md(comp, steps, dt)
            return
        masses = self._masses()
        inv_m = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-300), 0.0)
        constraints = self._clustered_constraints()
        proj_x = proj_v = None
        if constraints is not None:
            from ..runtime.constraints import make_constrainer
            # float64 whatever the evaluation's dtype, as in the JAX package
            proj_x, proj_v = make_constrainer(
                constraints[0], constraints[1], masses,
                self._system.getNumParticles(), mask=constraints[2])
        for _ in range(steps):
            _, forces, _ = self._evaluate(ALL_GROUPS)
            self._velocities += dt * forces * inv_m[:, None]
            if proj_x is None:
                self._positions += dt * self._velocities
                continue
            # SHAKE/RATTLE around the leapfrog update (the staging of
            # runtime/fastpath.py's integrate)
            pos = self._tensor(self._positions, torch.float64)
            vel = self._tensor(self._velocities, torch.float64)
            pos_new = proj_x(pos, pos + dt * vel)
            vel = proj_v(pos_new, (pos_new - pos) / dt)
            self._positions = profiling.to_host(pos_new)
            self._velocities = profiling.to_host(vel)
