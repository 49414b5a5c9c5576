"""Physical constants in OpenMM's internal unit system (nm, ps, kJ/mol, e).

The Coulomb constant matches OpenMM's ``ONE_4PI_EPS0`` literal so that energies
and forces are numerically identical to the reference plugin
(see tests/TestSlicedNonbondedForce.h usage and
python/tests/TestSlicedNonbondedForce.py:9).
"""

import math

# Coulomb constant 1/(4*pi*eps0) in kJ mol^-1 nm e^-2.
ONE_4PI_EPS0 = 138.935456

# Vacuum permittivity in e^2 mol kJ^-1 nm^-1, defined from the Coulomb constant
# exactly as OpenMM does, so the neutralizing-plasma energy matches
# (reference: ReferenceSlicedLJCoulombIxn.cpp:215).
EPSILON0 = 1.0 / (ONE_4PI_EPS0 * 4.0 * math.pi)

SQRT_PI = math.sqrt(math.pi)
TWO_OVER_SQRT_PI = 2.0 / SQRT_PI

# Term indices of the per-slice energy table, matching the reference's
# {Coul, vdW} convention (ReferencePME.cpp:30-31).
COUL = 0
VDW = 1
