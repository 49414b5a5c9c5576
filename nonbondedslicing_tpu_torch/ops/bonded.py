"""Bond-style nonbonded terms: 1-4 exceptions and Ewald exclusion corrections.

* 1-4 exceptions: E = lam_c*k*qq/r + lam_v*4*eps*((sigma/r)^12 - (sigma/r)^6)
  with parameters packed (sigma, 4*eps, qq); forces lambda-scaled, slice
  energies unscaled (ReferenceSlicedLJCoulomb14.cpp:61-95).
* Exclusion corrections subtract the reciprocal-space part of excluded pairs:
  -erf(alpha*r)*k*qq/r with a Taylor-safe branch when erf(alpha*r) <= 1e-6
  (ReferenceSlicedLJCoulombIxn.cpp:447-507).  The port covers the
  rigid-water layout (contiguous exclusion triangles) of the fused engine.

Slice energies accumulate in float64; forces stay in the working dtype.
"""

import numpy as np
import torch

from ..utils.constants import ONE_4PI_EPS0, SQRT_PI, TWO_OVER_SQRT_PI
from .geometry import min_image


def nb14_interactions(positions, box, atoms, sigma, four_eps, qq, slice_ids,
                      lam_coul_s, lam_vdw_s, *, periodic, num_slices,
                      num_particles):
    """1-4 exception terms -> (slice_energies (S, 2) f64, forces (N, 3))."""
    dtype = positions.dtype
    dev = positions.device
    slice_energies = torch.zeros((num_slices, 2), dtype=torch.float64,
                                 device=dev)
    forces = torch.zeros((num_particles, 3), dtype=dtype, device=dev)
    if atoms.shape[0] == 0:
        return slice_energies, forces
    i = atoms[:, 0]
    j = atoms[:, 1]
    dr = positions[i] - positions[j]
    if periodic:
        dr = min_image(dr, box)
    r2 = torch.sum(dr * dr, dim=-1)
    pos_r2 = r2 > 0
    rinv = torch.where(pos_r2, 1.0 / torch.sqrt(torch.where(pos_r2, r2, 1.0)),
                       0.0)
    sig2 = (sigma * rinv) ** 2
    sig6 = sig2 * sig2 * sig2
    lam_c = lam_coul_s[slice_ids]
    lam_v = lam_vdw_s[slice_ids]
    dedr = (lam_v * four_eps * (12.0 * sig6 - 6.0) * sig6
            + lam_c * ONE_4PI_EPS0 * qq * rinv) * rinv * rinv
    f = dedr[:, None] * dr
    e_vdw = four_eps * (sig6 - 1.0) * sig6
    e_coul = ONE_4PI_EPS0 * qq * rinv
    slice_energies[:, 0].index_add_(0, slice_ids, e_coul.to(torch.float64))
    slice_energies[:, 1].index_add_(0, slice_ids, e_vdw.to(torch.float64))
    forces.index_add_(0, i, f)
    forces.index_add_(0, j, -f)
    return slice_energies, forces


def triangle_exclusions(pairs, num_particles):
    """(E, 2) exclusion pairs -> (M, 3, 2) contiguous-triple clusters, or
    None if the exclusions are not exactly the rigid-water pattern
    ((3m, 3m+1), (3m, 3m+2), (3m+1, 3m+2) for every molecule m covering all
    particles)."""
    pairs = np.asarray(pairs)
    e = pairs.shape[0]
    if e == 0 or e % 3 != 0 or num_particles != e:
        return None
    m = e // 3
    tri = np.sort(pairs.reshape(m, 3, 2), axis=2)
    order = np.lexsort((tri[:, 0, 1], tri[:, 0, 0]))
    tri = tri[order]
    base = 3 * np.arange(m, dtype=tri.dtype)[:, None, None]
    expect = base + np.array([[[0, 1], [0, 2], [1, 2]]], dtype=tri.dtype)
    return tri if np.array_equal(tri, expect) else None


def exclusion_corrections_rows(positions, charge, pair_slices, lam_coul_s, *,
                               alpha, num_slices):
    """Ewald exclusion corrections for contiguous-triple clusters (local
    pairs 0-1, 0-2, 1-2 of molecule m = atoms 3m..3m+2), with unwrapped
    deltas (molecules kept whole, OpenMM's non-periodic exceptions).

    pair_slices: (M, 3) int64 slice id per local pair.
    Returns (slice_energies (S, 2) f64, forces (N, 3)).
    """
    n = positions.shape[0]
    m = n // 3
    p = positions.reshape(m, 3, 3)               # (M, atom, xyz)
    q = charge.reshape(m, 3)
    li = (0, 0, 1)
    lj = (1, 2, 2)
    dr = p[:, li] - p[:, lj]                     # (M, 3 pairs, xyz)
    r2 = torch.sum(dr * dr, dim=-1)
    r = torch.where(r2 > 0, torch.sqrt(torch.where(r2 > 0, r2, 1.0)), 0.0)
    ar = alpha * r
    erf_ar = torch.erf(ar)
    big = erf_ar > 1e-6
    rinv = 1.0 / torch.where(big, r, 1.0)
    qq = q[:, li] * q[:, lj]
    e_c = torch.where(big, -ONE_4PI_EPS0 * qq * rinv * erf_ar,
                      -alpha * TWO_OVER_SQRT_PI * ONE_4PI_EPS0 * qq)
    dedr = torch.where(
        big, ONE_4PI_EPS0 * qq * rinv ** 3
        * (erf_ar - 2.0 * ar * torch.exp(-ar * ar) / SQRT_PI), 0.0)
    f = -(lam_coul_s[pair_slices] * dedr)[..., None] * dr   # (M, 3, xyz)
    fa = f[:, 0] + f[:, 1]
    fb = -f[:, 0] + f[:, 2]
    fc = -f[:, 1] - f[:, 2]
    forces = torch.stack([fa, fb, fc], dim=1).reshape(n, 3)
    slice_e = torch.zeros((num_slices, 2), dtype=torch.float64,
                          device=positions.device)
    slice_e[:, 0].index_add_(0, pair_slices.reshape(-1),
                             e_c.reshape(-1).to(torch.float64))
    return slice_e, forces
