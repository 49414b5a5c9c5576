"""Ewald / PME parameter-selection heuristics (OpenMM-compatible).

The reference plugin delegates these to OpenMM core
(``NonbondedForceImpl::calcEwaldParameters`` / ``calcPMEParameters``, called at
platforms/reference/src/ReferenceNonbondedSlicingKernels.cpp:160-172
but defined outside the plugin repo).  We reimplement OpenMM's published
algorithms exactly so that ``getPMEParametersInContext`` /
``getLJPMEParametersInContext`` report the same (alpha, grid) as the
reference for the same (box, cutoff, tolerance):

* ``alpha = sqrt(-log(2*tol)) / cutoff`` (both Coulomb and LJPME dispersion)
* Ewald kmax: ``findZero`` over the error estimate
  ``error(k) = k*sqrt(d*alpha)/20 * exp(-(pi*k/(d*alpha))**2) - tol``
  starting from an initial guess of 10, then bumped to an odd number.
* PME grid: ``ceil(2*alpha*d / (3*tol**0.2))`` per axis (the LJPME dispersion
  grid drops the factor 2), floored at 6.  OpenMM core returns these *raw*
  sizes (the Reference platform uses them as-is via pocketfft); GPU platforms
  round up to FFT-legal sizes with prime factors <= 13
  (platforms/common/include/FFT3DFactory.h:31-47) — callers
  that need that behavior pass ``legal=True``.

These choices only affect accuracy, not correctness: all parity tests in this
repo compare the sliced force against an unsliced force evaluated with the
*same* parameters, mirroring the reference test strategy
(tests/TestSlicedNonbondedForce.h:1031-1318).
"""

import math


def ewald_alpha(cutoff: float, tol: float) -> float:
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def _ewald_error(k: int, width: float, alpha: float) -> float:
    temp = k * math.pi / (width * alpha)
    return 0.05 * math.sqrt(width * alpha) * k * math.exp(-temp * temp)


def _find_zero(f, initial_guess: int) -> int:
    """OpenMM NonbondedForceImpl::findZero: the smallest positive integer arg
    with f(arg) <= 0, located by walking from ``initial_guess``."""
    arg = initial_guess
    if f(arg) > 0.0:
        while f(arg) > 0.0 and arg < 100000:
            arg += 1
        return arg
    while f(arg - 1) <= 0.0:
        arg -= 1
        if arg <= 1:
            return 1
    return arg


def _find_kmax(width: float, alpha: float, tol: float) -> int:
    k = _find_zero(lambda k: _ewald_error(k, width, alpha) - tol, 10)
    if k % 2 == 0:
        k += 1
    return k


def calc_ewald_parameters(box, cutoff: float, tol: float):
    """Return (alpha, kmaxx, kmaxy, kmaxz) for bare Ewald summation.

    ``box`` is a (3, 3) array of row box vectors (must be rectangular).
    """
    alpha = ewald_alpha(cutoff, tol)
    kmax = tuple(_find_kmax(float(box[d][d]), alpha, tol) for d in range(3))
    return (alpha,) + kmax


def find_legal_dimension(minimum: int, max_factor: int = 13) -> int:
    """Smallest integer >= minimum whose prime factors are all <= max_factor.

    Mirrors the reference's FFT3DFactory::findLegalDimension
    (platforms/common/include/FFT3DFactory.h:31-47),
    max_factor 13.
    """
    n = max(int(minimum), 1)
    while True:
        m = n
        for f in (2, 3, 5, 7, 11, 13):
            if f > max_factor:
                break
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def calc_pme_parameters(box, cutoff: float, tol: float, dispersion: bool = False,
                        alpha: float = 0.0, grid=(0, 0, 0), legal: bool = False):
    """Return (alpha, nx, ny, nz) for (LJ)PME, matching OpenMM's
    NonbondedForceImpl::calcPMEParameters.

    User-supplied nonzero ``alpha``/``grid`` take precedence, matching
    NonbondedForce.setPMEParameters semantics.  ``legal=True`` additionally
    rounds up to prime factors <= 13 (the reference GPU platforms' behavior);
    the default raw sizes match the reference's Reference platform.
    """
    if alpha != 0.0:
        return alpha, int(grid[0]), int(grid[1]), int(grid[2])
    alpha = ewald_alpha(cutoff, tol)
    scale = 1.0 if dispersion else 2.0
    sizes = []
    for d in range(3):
        n = int(math.ceil(scale * alpha * float(box[d][d]) / (3.0 * tol ** 0.2)))
        n = max(n, 6)
        if legal:
            n = find_legal_dimension(n)
        sizes.append(n)
    return (alpha, sizes[0], sizes[1], sizes[2])
