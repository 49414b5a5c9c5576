"""Direct-space pair interactions (Coulomb + Lennard-Jones), sliced: the
all-pairs engine of the generic ``make_compute`` and the pair physics it
shares with the cell-list engine (``ops/neighbors.py``); the JAX package's
``ops/direct.py``.

The N^2 pair space is processed in row blocks of B atoms, so a block holds
(B, N) tensors.  Physics as ``ReferenceSlicedLJCoulombIxn``:

* packed parameters (sigma/2, 2*sqrt(eps)): sig_ij = si + sj (Lorentz),
  eps_ij = ei*ej = 4*sqrt(eps_i*eps_j) (Berthelot)
* reaction field: E = k*q1*q2*(1/r + krf*r^2 - crf)
* quintic switch S(t) = 1 + t^3*(-10 + t*(15 - 6t))
* Ewald-family real space: the exact erfc (``torch.special.erfc``), and
  under LJPME the real-space dispersion term and the potential shift
* forces scaled by lambda, slice energies stored unscaled
"""

import math

import torch

from ..utils.constants import ONE_4PI_EPS0, SQRT_PI
from ..utils.indexing import slice_subsets
from .geometry import min_image

# method families
PLAIN = "plain"            # NoCutoff
CUTOFF = "cutoff"          # CutoffNonPeriodic / CutoffPeriodic (reaction field)
EWALD_DIRECT = "ewald"     # Ewald / PME / LJPME real space


def _switch_terms(r, r_switch, r_cutoff):
    t = torch.clamp((r - r_switch) / (r_cutoff - r_switch), 0.0, 1.0)
    value = 1 + t * t * t * (-10 + t * (15 - t * 6))
    deriv = t * t * (-30 + t * (60 - t * 30)) / (r_cutoff - r_switch)
    return value, deriv


def _pick_block(n):
    for b in (1024, 512, 256, 128, 64, 32, 16, 8):
        if n >= b:
            return b
    return 8


def subset_moments(e_masked, oh_i, oh_j, slice_subset_pairs):
    """Per-slice sums (S,) of pair energies e (..., R, M) between row atoms
    with subset one-hots oh_i (..., R, nsub) and columns oh_j (..., M,
    nsub), every leading index summed.  M[a, b] counts each visited ordered
    pair once and every unordered pair is visited from both rows, so the
    slice (a, b) sums 0.5 * (M[a, b] + M[b, a]) off the diagonal and
    0.5 * M[a, a] on it."""
    m = torch.einsum("...ra,...rm,...mb->ab", oh_i, e_masked, oh_j)
    a = slice_subset_pairs[:, 0]
    b = slice_subset_pairs[:, 1]
    return torch.where(a == b, 0.5 * m[a, a], 0.5 * (m[a, b] + m[b, a]))


_SLICE_PAIRS = {}


def slice_tables(slice_table, device):
    """(slice table (nsub, nsub), slice -> subset pair (S, 2)) as int64
    tensors on ``device``.  The pairs are copied to the device once for
    each subset count and device, so that a call with ``slice_table``
    already there copies nothing from the host (and may run inside a CUDA
    graph's capture)."""
    sl_tab = torch.as_tensor(slice_table, dtype=torch.int64, device=device)
    key = (sl_tab.shape[0], sl_tab.device)
    if key not in _SLICE_PAIRS:
        _SLICE_PAIRS[key] = torch.as_tensor(slice_subsets(key[0]),
                                            device=sl_tab.device)
    return sl_tab, _SLICE_PAIRS[key]


def make_pair_terms(*, mode, cutoff=None, krf=0.0, crf=0.0, use_switch=False,
                    switch_distance=0.0, ewald_alpha=0.0, ljpme=False,
                    dispersion_alpha=0.0):
    """The per-pair physics of the all-pairs and the cell-list engines
    (ReferenceSlicedLJCoulombIxn.cpp:578-630; the JAX package's
    ``direct.py:94-163``)."""

    def pair_terms(r2, rinv, sh_i, sh_j, e2_i, e2_j, qq):
        """Per-pair energies and dE/dR*(1/r) factors (before lambda)."""
        r = r2 * rinv
        sig = sh_i + sh_j
        sig2 = (sig * rinv) ** 2
        sig6 = sig2 * sig2 * sig2
        eps = e2_i * e2_j

        if use_switch:
            sw_val, sw_der = _switch_terms(r, switch_distance, cutoff)
        else:
            sw_val, sw_der = 1.0, 0.0

        dedr_vdw = sw_val * eps * (12.0 * sig6 - 6.0) * sig6 * rinv * rinv
        e_vdw = eps * (sig6 - 1.0) * sig6

        if mode == PLAIN:
            e_coul = ONE_4PI_EPS0 * qq * rinv
            dedr_coul = ONE_4PI_EPS0 * qq * rinv * rinv * rinv
        elif mode == CUTOFF:
            e_coul = ONE_4PI_EPS0 * qq * (rinv + krf * r2 - crf)
            dedr_coul = (ONE_4PI_EPS0 * qq * (rinv - 2.0 * krf * r2)
                         * rinv * rinv)
        else:  # EWALD_DIRECT
            alpha_r = ewald_alpha * r
            erfc_ar = torch.special.erfc(alpha_r)
            gauss = torch.exp(-alpha_r * alpha_r)
            e_coul = ONE_4PI_EPS0 * qq * rinv * erfc_ar
            dedr_coul = (ONE_4PI_EPS0 * qq * rinv * rinv * rinv
                         * (erfc_ar + 2.0 * alpha_r * gauss / SQRT_PI))
            if ljpme:
                # multiplicative-C6 real-space term + potential shift
                # (ReferenceSlicedLJCoulombIxn.cpp:398-426)
                dar = dispersion_alpha * r
                dar2 = dar * dar
                dar4 = dar2 * dar2
                dar6 = dar4 * dar2
                rinv2 = rinv * rinv
                rinv6 = rinv2 * rinv2 * rinv2
                c6ij = (8.0 * sh_i ** 3 * e2_i) * (8.0 * sh_j ** 3 * e2_j)
                expd = torch.exp(-dar2)
                emult = c6ij * rinv6 * (1.0 - expd * (1.0 + dar2 + 0.5 * dar4))
                dedr_vdw = dedr_vdw + 6.0 * c6ij * rinv6 * rinv2 * (
                    1.0 - expd * (1.0 + dar2 + 0.5 * dar4 + dar6 / 6.0))
                inv_cut2 = 1.0 / (cutoff * cutoff)
                inv_cut6 = inv_cut2 * inv_cut2 * inv_cut2
                sigc6 = sig ** 6
                shift = eps * (1.0 - sigc6 * inv_cut6) * sigc6 * inv_cut6
                darc2 = (dispersion_alpha * cutoff) ** 2
                darc4 = darc2 * darc2
                shift = shift - c6ij * inv_cut6 * (
                    1.0 - math.exp(-darc2) * (1.0 + darc2 + 0.5 * darc4))
                e_vdw = e_vdw + emult + shift

        if use_switch:
            dedr_vdw = dedr_vdw - e_vdw * sw_der * rinv
            e_vdw = e_vdw * sw_val

        return e_coul, e_vdw, dedr_coul, dedr_vdw

    return pair_terms


def make_direct_space(*, mode, periodic, cutoff=None, krf=0.0, crf=0.0,
                      use_switch=False, switch_distance=0.0,
                      ewald_alpha=0.0, ljpme=False, dispersion_alpha=0.0,
                      num_slices=1, block_size=None):
    """The all-pairs direct space (the JAX package's ``direct.py:165-283``):

    f(positions, box, charge, sig_half, eps2, subsets, exclusion_list,
      slice_table, lam_coul, lam_vdw) -> (slice_energies (S, 2) float64,
      forces (N, 3))

    Row blocks of ``block_size`` atoms (1024 or the largest power of two
    <= N) against all N columns; excluded pairs (``exclusion_list``, -1
    padded) are masked, and with a cutoff the pairs beyond it.  Slice
    energies sum over the blocks in float64.  ``rows=(begin, end)`` takes
    the rows [begin, end) only, in blocks from ``begin`` (a rank's share of
    the sharded evaluation, ``parallel/mesh.py``): their pairs' slice
    energies (each pair still weighted 1/2 from either side) and their
    forces (end - begin, 3).
    """
    pair_terms = make_pair_terms(
        mode=mode, cutoff=cutoff, krf=krf, crf=crf, use_switch=use_switch,
        switch_distance=switch_distance, ewald_alpha=ewald_alpha, ljpme=ljpme,
        dispersion_alpha=dispersion_alpha)

    def direct_space(positions, box, charge, sig_half, eps2, subsets,
                     exclusion_list, slice_table, lam_coul, lam_vdw,
                     rows=None):
        n = positions.shape[0]
        dtype, dev = positions.dtype, positions.device
        block = block_size or _pick_block(n)
        begin, end = (0, n) if rows is None else rows
        sl_tab, spairs = slice_tables(slice_table, dev)
        nsub = sl_tab.shape[0]
        lam_c_nn = lam_coul[sl_tab]
        lam_v_nn = lam_vdw[sl_tab]
        sub = subsets.long()
        oh = torch.nn.functional.one_hot(sub, nsub).to(dtype)
        excl = exclusion_list.long()
        excl = torch.where(excl < 0, n, excl)   # pads -> a dropped column
        idx_all = torch.arange(n, device=dev)
        slice_energies = torch.zeros((num_slices, 2), dtype=torch.float64,
                                     device=dev)
        forces = torch.empty((end - begin, 3), dtype=dtype, device=dev)
        for i0 in range(begin, end, block):
            i1 = min(i0 + block, end)
            rows_i = idx_all[i0:i1]
            dr = positions[i0:i1, None, :] - positions[None, :, :]
            if periodic:
                dr = min_image(dr, box)
            r2 = torch.sum(dr * dr, dim=-1)
            excluded = torch.zeros((i1 - i0, n + 1), dtype=torch.bool,
                                   device=dev)
            excluded.scatter_(1, excl[i0:i1], True)
            mask = (rows_i[:, None] != idx_all[None, :]) & ~excluded[:, :n]
            if mode != PLAIN:
                mask &= r2 < cutoff * cutoff
            r2s = torch.where(mask, r2, torch.ones((), dtype=dtype,
                                                   device=dev))
            rinv = torch.rsqrt(r2s)
            qq = charge[i0:i1, None] * charge[None, :]
            e_coul, e_vdw, dedr_c, dedr_v = pair_terms(
                r2s, rinv, sig_half[i0:i1, None], sig_half[None, :],
                eps2[i0:i1, None], eps2[None, :], qq)
            sub_i, sub_j = sub[i0:i1, None], sub[None, :]
            factor = torch.where(mask, lam_v_nn[sub_i, sub_j] * dedr_v
                                 + lam_c_nn[sub_i, sub_j] * dedr_c, 0.0)
            forces[i0 - begin:i1 - begin] = torch.einsum("ij,ijk->ik",
                                                         factor, dr)
            ec = subset_moments(torch.where(mask, e_coul, 0.0), oh[i0:i1],
                                oh, spairs)
            ev = subset_moments(torch.where(mask, e_vdw, 0.0), oh[i0:i1],
                                oh, spairs)
            slice_energies += torch.stack([ec, ev], dim=-1).to(torch.float64)
        return slice_energies, forces

    return direct_space
