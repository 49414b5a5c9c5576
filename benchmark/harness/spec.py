"""The inputs of a cell, made once and handed to both sides.

:func:`build` runs a configuration's builder (``builders/<name>.py``, over
the frozen builders of :mod:`harness.systems`) through an API of the
port's shape and returns the System and the positions.  Run through
:class:`RecordingAPI`, a plain recorder of the same calls, the builder
gives the :class:`Spec` that the reference reads: the
same particles, exceptions, subsets, scaling parameters, constraints and
bonds that the port's System holds, as numpy arrays, with nothing of the
port in them.

A configuration (``configs/<name>.json``) holds:

* ``name``, ``source``; ``guarantees``, ``deployment``, ``reduced`` and
  ``assumed``, in words;
* ``builder``, ``state``, ``state_box_nm``, ``method``: what :func:`build`
  reads (the builder, the waters' state file under ``benchmark/`` and its
  box edge, the nonbonded method, which also names the plain reference,
  ``reference/<method in lower case>.py``: :func:`harness.catalog.reference`);
  an optional ``cube_edge_nm`` cuts a cube of that edge from the state;
* ``stated``: the numbers that :func:`check_stated` holds the built
  system to;
* ``platform``, ``precision``, ``dt_ps``, ``temperature_k``: the
  Context's platform and precision, the time step and the temperature
  the velocities are drawn at (``run.py``);
* ``tiny_cube_edge_nm``: the ``cube_edge_nm`` at which the tests run it on
  the CPU, below three neighbour cells a side so that the port's MD step
  takes its per-step path.
"""

import importlib.util
import os
from dataclasses import dataclass, field

import numpy as np

from . import systems

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


class _RecSystem:
    def __init__(self):
        self.masses = []
        self.constraints = []
        self.forces = []
        self.box = None

    def setDefaultPeriodicBoxVectors(self, a, b, c):
        self.box = np.array([a, b, c], dtype=np.float64)

    def addParticle(self, mass):
        self.masses.append(float(mass))
        return len(self.masses) - 1

    def addConstraint(self, i, j, d):
        self.constraints.append((int(i), int(j), float(d)))

    def addForce(self, force):
        self.forces.append(force)


class _RecSliced:
    NoCutoff, CutoffNonPeriodic, CutoffPeriodic = ("NoCutoff",
                                                   "CutoffNonPeriodic",
                                                   "CutoffPeriodic")
    Ewald, PME, LJPME = "Ewald", "PME", "LJPME"

    def __init__(self, n_subsets):
        self.n_subsets = int(n_subsets)
        self.params = []
        self.subsets = {}
        self.exceptions = []
        self.globals = {}
        self.scaling = []
        self.derivatives = []
        self.method = None
        self.cutoff = None
        self.tolerance = None

    def setNonbondedMethod(self, method):
        self.method = method

    def setCutoffDistance(self, cutoff):
        self.cutoff = float(cutoff)

    def setEwaldErrorTolerance(self, tol):
        self.tolerance = float(tol)

    def addParticle(self, q, sigma, epsilon):
        self.params.append((float(q), float(sigma), float(epsilon)))
        return len(self.params) - 1

    def setParticleSubset(self, index, subset):
        self.subsets[int(index)] = int(subset)

    def addException(self, i, j, qq, sigma, epsilon):
        self.exceptions.append((int(i), int(j), float(qq), float(sigma),
                                float(epsilon)))

    def addGlobalParameter(self, name, value):
        self.globals[name] = float(value)

    def addScalingParameter(self, name, s1, s2, coulomb, lj):
        self.scaling.append((name, int(s1), int(s2), bool(coulomb),
                             bool(lj)))

    def addEnergyParameterDerivative(self, name):
        self.derivatives.append(name)


class _RecBonds:
    def __init__(self):
        self.bonds = []

    def addBond(self, i, j, r0, k):
        self.bonds.append((int(i), int(j), float(r0), float(k)))


class RecordingAPI:
    """The calls of :mod:`harness.systems`, recorded."""
    System = _RecSystem
    SlicedNonbondedForce = _RecSliced
    HarmonicBondForce = _RecBonds


@dataclass
class Spec:
    """A system as plain arrays (nm, ps, kJ/mol, e)."""
    box: np.ndarray                 # (3,) edges of the rectangular box
    masses: np.ndarray
    charges: np.ndarray
    sigmas: np.ndarray
    epsilons: np.ndarray
    subsets: np.ndarray             # int64
    n_subsets: int
    exceptions: np.ndarray          # (M, 2) int64
    exception_params: np.ndarray    # (M, 3) chargeProd, sigma, epsilon
    method: str
    cutoff: float
    tolerance: float
    globals: dict
    scaling: list                   # (name, s1, s2, coulomb, lj)
    derivatives: list
    constraints: np.ndarray         # (C, 2) int64
    constraint_dists: np.ndarray
    bonds: np.ndarray               # (B, 4) i, j, r0, k
    positions: np.ndarray = field(default=None)

    @property
    def n_atoms(self):
        return len(self.masses)


def build(config, api):
    """(system, positions) of ``config`` through ``api``, by the builder
    ``builders/<config["builder"]>.py`` that the file names, from the
    waters of its state file (or a smaller cube of them); the constraints
    and bonds are in the System, as a Context reads them."""
    with np.load(os.path.join(BENCH_DIR, config["state"])) as blob:
        water = np.asarray(blob["positions"], dtype=np.float64)
    box = float(config["state_box_nm"])
    if "cube_edge_nm" in config:      # a smaller cube of the same water
        water, box = systems.water_cube(water, box,
                                        float(config["cube_edge_nm"]))
    path = os.path.join(BENCH_DIR, "builders", f"{config['builder']}.py")
    module_spec = importlib.util.spec_from_file_location(
        f"benchmark_builder_{config['builder']}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.build(api, water, box, config["method"])


def spec_of(config):
    """The :class:`Spec` of ``config``, through the recording API, checked
    against the numbers the configuration file states."""
    system, positions = build(config, RecordingAPI)
    (force,) = [f for f in system.forces if isinstance(f, _RecSliced)]
    bonds = [b for f in system.forces if isinstance(f, _RecBonds)
             for b in f.bonds]
    n = len(system.masses)
    params = np.asarray(force.params, dtype=np.float64)
    exc = np.asarray(force.exceptions, dtype=np.float64).reshape(-1, 5)
    cons = np.asarray(system.constraints, dtype=np.float64).reshape(-1, 3)
    spec = Spec(
        box=np.diag(system.box).copy(), masses=np.asarray(system.masses),
        charges=params[:, 0].copy(), sigmas=params[:, 1].copy(),
        epsilons=params[:, 2].copy(),
        subsets=np.array([force.subsets.get(i, 0) for i in range(n)],
                         dtype=np.int64),
        n_subsets=force.n_subsets, exceptions=exc[:, :2].astype(np.int64),
        exception_params=exc[:, 2:].copy(), method=force.method,
        cutoff=force.cutoff, tolerance=force.tolerance,
        globals=dict(force.globals), scaling=list(force.scaling),
        derivatives=list(force.derivatives),
        constraints=cons[:, :2].astype(np.int64),
        constraint_dists=cons[:, 2].copy(),
        bonds=np.asarray(bonds, dtype=np.float64).reshape(-1, 4),
        positions=np.asarray(positions, dtype=np.float64))
    check_stated(config, spec)
    return spec


def check_stated(config, spec):
    """Raise ValueError where the built system differs from what the
    configuration file states."""
    stated = config.get("stated", {})
    found = dict(
        atoms=spec.n_atoms, subsets=spec.n_subsets, method=spec.method,
        cutoff_nm=spec.cutoff, ewald_tolerance=spec.tolerance,
        box_nm=float(spec.box[0]),
        scaling=[list(s) for s in spec.scaling],
        globals=spec.globals, derivatives=spec.derivatives,
        constraints=len(spec.constraints), harmonic_bonds=len(spec.bonds))
    for key, value in stated.items():
        have = found[key]
        if isinstance(value, float):
            ok = abs(have - value) <= 1e-4 * abs(value)
        else:
            ok = have == value
        if not ok:
            raise ValueError(f"configuration {config['name']}: {key} is "
                             f"{have!r}, the file states {value!r}")
