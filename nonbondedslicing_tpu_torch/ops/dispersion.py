"""Per-slice long-range Lennard-Jones dispersion correction.

Host-side (numpy) math mirroring
``SlicedNonbondedForceImpl::calcDispersionCorrections``
(openmmapi/src/SlicedNonbondedForceImpl.cpp:263-354): particles
are grouped into classes keyed by (sigma, epsilon, subset); same-class pairs
contribute to the diagonal slice of their subset, cross-class pairs to
sliceIndex(s1, s2).  The result is a per-slice coefficient; the engine divides
by the box volume at evaluation time
(ReferenceNonbondedSlicingKernels.cpp:244-249) so NPT box rescaling is handled
correctly.
"""

import math

import numpy as np

from ..models.force import NonbondedForce
from ..utils.indexing import slice_index


def eval_integral(r, rs, rc, sigma):
    """Indefinite integral of r^2 * (LJ energy) * (quintic switching function).

    Closed form from SlicedNonbondedForceImpl::evalIntegral
    (SlicedNonbondedForceImpl.cpp:150-185).
    """
    A = 1 / (rc - rs)
    A2 = A * A
    A3 = A2 * A
    sig2 = sigma * sigma
    sig6 = sig2 * sig2 * sig2
    rs2 = rs * rs
    rs3 = rs * rs2
    r2 = r * r
    r3 = r * r2
    r4 = r * r3
    r5 = r * r4
    r6 = r * r5
    r9 = r3 * r6
    return sig6 * A3 * ((
        sig6 * (
            + rs3 * 28 * (6 * rs2 * A2 + 15 * rs * A + 10)
            - r * rs2 * 945 * (rs2 * A2 + 2 * rs * A + 1)
            + r2 * rs * 1080 * (2 * rs2 * A2 + 3 * rs * A + 1)
            - r3 * 420 * (6 * rs2 * A2 + 6 * rs * A + 1)
            + r4 * 756 * (2 * rs * A2 + A)
            - r5 * 378 * A2)
        - r6 * (
            + rs3 * 84 * (6 * rs2 * A2 + 15 * rs * A + 10)
            - r * rs2 * 3780 * (rs2 * A2 + 2 * rs * A + 1)
            + r2 * rs * 7560 * (2 * rs2 * A2 + 3 * rs * A + 1))
        ) / (252 * r9)
        - math.log(r) * 10 * (6 * rs2 * A2 + 6 * rs * A + 1)
        + r * 15 * (2 * rs * A2 + A)
        - r2 * 3 * A2
    )


def calc_dispersion_corrections(force) -> np.ndarray:
    """Per-slice long-range correction coefficients (kJ/mol * nm^3)."""
    num_slices = force.getNumSlices()
    out = np.zeros(num_slices)
    method = force.getNonbondedMethod()
    if method in (NonbondedForce.NoCutoff, NonbondedForce.CutoffNonPeriodic):
        return out

    n = force.getNumParticles()
    sigma = np.zeros(n)
    epsilon = np.zeros(n)
    subset = np.zeros(n, dtype=int)
    for i in range(n):
        _, sigma[i], epsilon[i] = force.getParticleParameters(i)
        subset[i] = force.getParticleSubset(i)
    # offsets evaluated at default global parameter values
    # (SlicedNonbondedForceImpl.cpp:281-291)
    defaults = {force.getGlobalParameterName(i): force.getGlobalParameterDefaultValue(i)
                for i in range(force.getNumGlobalParameters())}
    for i in range(force.getNumParticleParameterOffsets()):
        param, index, _, sig_scale, eps_scale = force.getParticleParameterOffset(i)
        sigma[index] += defaults[param] * sig_scale
        epsilon[index] += defaults[param] * eps_scale

    use_switch = force.getUseSwitchingFunction()
    cutoff = force.getCutoffDistance()
    switch = force.getSwitchingDistance()

    class_counts = {}
    for i in range(n):
        key = (sigma[i], epsilon[i], subset[i])
        class_counts[key] = class_counts.get(key, 0) + 1

    sum1 = np.zeros(num_slices)
    sum2 = np.zeros(num_slices)
    sum3 = np.zeros(num_slices)

    def accumulate(sl, count, sig, eps):
        sig6 = sig ** 6
        sum1[sl] += count * eps * sig6 * sig6
        sum2[sl] += count * eps * sig6
        if use_switch:
            sum3[sl] += count * eps * (eval_integral(cutoff, switch, cutoff, sig)
                                       - eval_integral(switch, switch, cutoff, sig))

    classes = list(class_counts.items())
    for (sig, eps, sub), count in classes:
        accumulate(sub * (sub + 3) // 2, count * (count + 1) // 2, sig, eps)
    for a in range(len(classes)):
        (sig1, eps1, s1), c1 = classes[a]
        for b in range(a):
            (sig2, eps2, s2), c2 = classes[b]
            accumulate(slice_index(s1, s2), c1 * c2,
                       0.5 * (sig1 + sig2), math.sqrt(eps1 * eps2))

    num_interactions = n * (n + 1) / 2
    sum1 /= num_interactions
    sum2 /= num_interactions
    sum3 /= num_interactions
    return 8 * n * n * math.pi * (sum1 / (9 * cutoff ** 9) - sum2 / (3 * cutoff ** 3) + sum3)
