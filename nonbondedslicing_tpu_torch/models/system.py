"""System container: particles, masses, box vectors, constraints, forces.

Minimal analog of OpenMM's System, carrying exactly what the reference
plugin's capability surface needs.
"""

import numpy as np

from .force import OpenMMException


class System:
    def __init__(self):
        self._masses = []
        self._forces = []
        self._constraints = []
        # default box: 2 nm cube, row vectors
        self._box = np.diag([2.0, 2.0, 2.0]).astype(np.float64)

    # ------------------------------------------------------------- particles

    def addParticle(self, mass):
        self._masses.append(float(mass))
        return len(self._masses) - 1

    def addParticles(self, masses):
        """Bulk addParticle: append every mass in ``masses`` (array-like).
        Returns the index of the first particle added.  Equivalent to (but
        far faster than) a per-particle addParticle loop — the multi-million
        particle regime of the reference's testHugeSystem
        (tests/TestSlicedNonbondedForce.h:557-612)."""
        arr = np.asarray(masses, dtype=np.float64).reshape(-1)
        first = len(self._masses)
        self._masses.extend(arr.tolist())
        return first

    def getNumParticles(self):
        return len(self._masses)

    def getParticleMass(self, index):
        return self._masses[index]

    def setParticleMass(self, index, mass):
        self._masses[index] = float(mass)

    # ------------------------------------------------------------------- box

    def setDefaultPeriodicBoxVectors(self, a, b, c):
        box = np.array([a, b, c], dtype=np.float64)
        if box[0][1] != 0 or box[0][2] != 0 or box[1][2] != 0:
            raise OpenMMException(
                "Periodic box vectors must be in reduced form "
                "(a along x; b in xy-plane; components above diagonal zero)")
        self._box = box

    def getDefaultPeriodicBoxVectors(self):
        return [tuple(v) for v in self._box]

    def getDefaultPeriodicBoxVolume(self):
        return float(self._box[0][0] * self._box[1][1] * self._box[2][2])

    # ------------------------------------------------------------ constraints

    def addConstraint(self, particle1, particle2, distance):
        self._constraints.append([int(particle1), int(particle2), float(distance)])
        return len(self._constraints) - 1

    def getNumConstraints(self):
        return len(self._constraints)

    def getConstraintParameters(self, index):
        return tuple(self._constraints[index])

    # ----------------------------------------------------------------- forces

    def addForce(self, force):
        self._forces.append(force)
        return len(self._forces) - 1

    def getNumForces(self):
        return len(self._forces)

    def getForce(self, index):
        return self._forces[index]

    def getForces(self):
        return list(self._forces)

    def removeForce(self, index):
        del self._forces[index]

    def usesPeriodicBoundaryConditions(self):
        return any(f.usesPeriodicBoundaryConditions() for f in self._forces)
