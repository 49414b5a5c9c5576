"""Bond-style nonbonded terms: 1-4 exceptions and Ewald exclusion corrections.

* 1-4 exceptions: E = lam_c*k*qq/r + lam_v*4*eps*((sigma/r)^12 - (sigma/r)^6)
  with parameters packed (sigma, 4*eps, qq); forces lambda-scaled, slice
  energies unscaled (ReferenceSlicedLJCoulomb14.cpp:61-95).
* Exclusion corrections subtract the reciprocal-space part of excluded pairs:
  -erf(alpha*r)*k*qq/r with a Taylor-safe branch when erf(alpha*r) <= 1e-6
  (ReferenceSlicedLJCoulombIxn.cpp:447-507) and, under LJPME, add back the
  pair's reciprocal dispersion term where erf(alpha*r) > 1e-6: for any
  list of excluded pairs (``exclusion_corrections``, the generic engine's)
  and for the rigid-water layout of the fused engine (contiguous exclusion
  triangles, ``exclusion_corrections_rows``).

Slice energies accumulate in float64; forces stay in the working dtype.
"""

import functools

import numpy as np
import torch

from ..utils.constants import ONE_4PI_EPS0, SQRT_PI, TWO_OVER_SQRT_PI
from ..utils.indexing import incidence_sums, pair_incidence
from .cuda_direct import dispersion_terms
from .geometry import min_image


def nb14_interactions(positions, box, atoms, sigma, four_eps, qq, slice_ids,
                      lam_coul_s, lam_vdw_s, *, periodic, num_slices,
                      num_particles):
    """1-4 exception terms -> (slice_energies (S, 2) f64, forces (N, 3))."""
    dtype = positions.dtype
    dev = positions.device
    if atoms.shape[0] == 0:
        return (torch.zeros((num_slices, 2), dtype=torch.float64, device=dev),
                torch.zeros((num_particles, 3), dtype=dtype, device=dev))
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
    return (_slice_sums(slice_ids, e_coul, e_vdw, num_slices),
            _pair_sums(atoms, f, num_particles))


def _pair_sums(pairs, f, n):
    """(n, 3) sums of +f on the first atom of every pair (P, 2) and -f on
    the second, each atom's terms added in a fixed order through the
    pairs' incidence table (``utils.indexing.pair_incidence``), so the
    result repeats to the bit (``index_add_`` adds with float atomics on
    CUDA)."""
    targets, table = pair_incidence(pairs, n)
    out = torch.zeros((n, 3), dtype=f.dtype, device=f.device)
    return out.index_copy_(0, targets,
                           incidence_sums(torch.cat([f, -f]), table))


def _slice_sums(slice_ids, e_coul, e_vdw, num_slices):
    """(S, 2) float64 per-slice sums of Coulomb and vdW energies (``e_vdw``
    None: zeros), contracted with the slices' one-hot matrix as the self
    energy is (a fixed order, no atomics)."""
    terms = torch.stack([e_coul, torch.zeros_like(e_coul) if e_vdw is None
                         else e_vdw], dim=1).to(torch.float64)
    onehot = torch.nn.functional.one_hot(slice_ids.long(), num_slices)
    return onehot.to(torch.float64).T @ terms


def exclusion_corrections(positions, box, pairs, charge, sig_half, eps2,
                          subsets, slice_table, lam_coul_s, lam_vdw_s, *,
                          alpha, periodic_exceptions, ljpme, dispersion_alpha,
                          num_slices, num_particles):
    """Subtract the reciprocal-space part of every excluded pair ``pairs``
    (E, 2) (the JAX package's ``bonded.py:61-131``): -erf(alpha r) k qq / r,
    or its limit -2 alpha k qq / sqrt(pi) where erf(alpha r) <= 1e-6; under
    LJPME add back the pair's reciprocal dispersion term.  Deltas are
    minimum images when ``periodic_exceptions``.
    Returns (slice_energies (S, 2) f64, forces (N, 3))."""
    dtype, dev = positions.dtype, positions.device
    if pairs.shape[0] == 0:
        return (torch.zeros((num_slices, 2), dtype=torch.float64, device=dev),
                torch.zeros((num_particles, 3), dtype=dtype, device=dev))
    i = pairs[:, 0].long()
    j = pairs[:, 1].long()
    dr = positions[i] - positions[j]
    if periodic_exceptions:
        dr = min_image(dr, box)
    r2 = torch.sum(dr * dr, dim=-1)
    r = torch.where(r2 > 0, torch.sqrt(torch.where(r2 > 0, r2, 1.0)), 0.0)
    alpha_r = alpha * r
    erf_ar = torch.erf(alpha_r)
    big = erf_ar > 1e-6   # Taylor-safe branch (ReferenceSlicedLJCoulombIxn.cpp:468)
    rinv = 1.0 / torch.where(big, r, 1.0)
    qq = charge[i] * charge[j]
    sl_tab = torch.as_tensor(slice_table, dtype=torch.int64, device=dev)
    sl = sl_tab[subsets[i].long(), subsets[j].long()]
    e_coul = torch.where(big, -ONE_4PI_EPS0 * qq * rinv * erf_ar,
                         -alpha * TWO_OVER_SQRT_PI * ONE_4PI_EPS0 * qq)
    dedr = torch.where(
        big, ONE_4PI_EPS0 * qq * rinv ** 3
        * (erf_ar - 2.0 * alpha_r * torch.exp(-alpha_r * alpha_r) / SQRT_PI),
        0.0)
    # the reference subtracts: forces[i] -= lam*dedr*dr (cpp:473-478)
    f = -(lam_coul_s[sl] * dedr)[:, None] * dr
    e_vdw = None
    if ljpme:
        # back out the reciprocal dispersion of excluded pairs (cpp:487-504)
        c6ij = (8.0 * sig_half[i] ** 3 * eps2[i]) * (8.0 * sig_half[j] ** 3
                                                     * eps2[j])
        e_vdw, dedr_v = dispersion_terms(c6ij, r, rinv, dispersion_alpha)
        e_vdw = torch.where(big, e_vdw, 0.0)
        f = f + (lam_vdw_s[sl] * torch.where(big, dedr_v, 0.0))[:, None] * dr
    return (_slice_sums(sl, e_coul, e_vdw, num_slices),
            _pair_sums(pairs, f, num_particles))


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


@functools.lru_cache(maxsize=None)
def _pair_atoms(device):
    """The local atoms (0, 0, 1) and (1, 2, 2) of a molecule's pairs 0-1,
    0-2, 1-2, as index tensors on ``device``, copied from the host once: a
    host->device copy cannot be captured in a CUDA graph.  Callers take
    them with ``index_select``: ``x[:, index]`` with a CUDA index, captured
    in a CUDA graph, replayed results that depended on the state at capture
    (torch 2.11, CUDA 12.8, H100)."""
    return (torch.tensor((0, 0, 1), device=device),
            torch.tensor((1, 2, 2), device=device))


def exclusion_corrections_rows(positions, charge, sig_half, eps2,
                               pair_slices, lam_coul_s, lam_vdw_s, *, alpha,
                               ljpme, dispersion_alpha, num_slices):
    """Ewald exclusion corrections for contiguous-triple clusters (local
    pairs 0-1, 0-2, 1-2 of molecule m = atoms 3m..3m+2), with unwrapped
    deltas (molecules kept whole, OpenMM's non-periodic exceptions); with
    ``ljpme`` also the back-out of each pair's reciprocal dispersion term
    (C6 from sigma/2 and 2 sqrt(eps), scaled by the slice's lambda_vdW;
    the JAX package's ``bonded.py:154-242``).

    pair_slices: (M, 3) int64 slice id per local pair.
    Returns (slice_energies (S, 2) f64, summed in a fixed order as the
    1-4s' are, forces (N, 3)).
    """
    n = positions.shape[0]
    m = n // 3
    p = positions.reshape(m, 3, 3)               # (M, atom, xyz)
    q = charge.reshape(m, 3)
    li, lj = _pair_atoms(positions.device)
    dr = p.index_select(1, li) - p.index_select(1, lj)  # (M, 3 pairs, xyz)
    r2 = torch.sum(dr * dr, dim=-1)
    r = torch.where(r2 > 0, torch.sqrt(torch.where(r2 > 0, r2, 1.0)), 0.0)
    ar = alpha * r
    erf_ar = torch.erf(ar)
    big = erf_ar > 1e-6
    rinv = 1.0 / torch.where(big, r, 1.0)
    qq = q.index_select(1, li) * q.index_select(1, lj)
    e_c = torch.where(big, -ONE_4PI_EPS0 * qq * rinv * erf_ar,
                      -alpha * TWO_OVER_SQRT_PI * ONE_4PI_EPS0 * qq)
    dedr = torch.where(
        big, ONE_4PI_EPS0 * qq * rinv ** 3
        * (erf_ar - 2.0 * ar * torch.exp(-ar * ar) / SQRT_PI), 0.0)
    f = -(lam_coul_s[pair_slices] * dedr)[..., None] * dr   # (M, 3, xyz)
    if ljpme:
        c6 = (8.0 * sig_half ** 3 * eps2).reshape(m, 3)
        e_v, dedr_v = dispersion_terms(
            c6.index_select(1, li) * c6.index_select(1, lj), r, rinv,
            dispersion_alpha)
        e_v = torch.where(big, e_v, 0.0)
        f = f + (lam_vdw_s[pair_slices] * torch.where(big, dedr_v, 0.0)
                 )[..., None] * dr
    fa = f[:, 0] + f[:, 1]
    fb = -f[:, 0] + f[:, 2]
    fc = -f[:, 1] - f[:, 2]
    forces = torch.stack([fa, fb, fc], dim=1).reshape(n, 3)
    return (_slice_sums(pair_slices.reshape(-1), e_c.reshape(-1),
                        e_v.reshape(-1) if ljpme else None, num_slices),
            forces)
