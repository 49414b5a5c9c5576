"""Bare Ewald reciprocal-space sum, sliced over particle subsets (the JAX
package's ``ops/ewald.py``; ReferenceSlicedLJCoulombIxn.cpp:256-357).

The half-space k-vectors are enumerated on the host.  Per-subset structure
factors S_j(k) = sum_{n in j} q_n exp(i k.r_n) give the slice energies as
cross products; the force on atom n uses its lambda-combined weight
Im(t_n(k) conj(sum_j lam(s_n, j) S_j(k))).  The k-vectors are taken in
chunks, so that the (N, K) phase tensors of a chunk stay small at any K
(25,326 half-space vectors at the 23,289-atom box); only the order of the
sums over k differs from the JAX package.
"""

import math

import numpy as np
import torch

from ..parallel import collectives
from ..utils.constants import ONE_4PI_EPS0

# phase-tensor elements (atoms x k-vectors) per chunk
CHUNK_ELEMENTS = 1 << 22


def half_space_kvectors(kmax):
    """Integer k-triples in the reference's loop order: rx in [0, numRx);
    ry in [0 or 1-numRy, numRy); rz likewise, from (0, 0, 1), without the
    origin and the conjugate duplicates."""
    num_rx, num_ry, num_rz = kmax
    ks = []
    low_ry, low_rz = 0, 1
    for rx in range(num_rx):
        for ry in range(low_ry, num_ry):
            for rz in range(low_rz, num_rz):
                ks.append((rx, ry, rz))
                low_rz = 1 - num_rz
            low_ry = 1 - num_ry
    return np.array(ks, dtype=np.int64).reshape(-1, 3)


def ewald_reciprocal(positions, box, charge, subsets, lam_coul_s, *,
                     kvec_ints, alpha, num_subsets, slice_table,
                     slice_subset_pairs, energies=True, group=None):
    """Returns (slice Coulomb energies (S,) float64, forces (N, 3)).
    ``kvec_ints`` is an int64 tensor of :func:`half_space_kvectors` on the
    device of ``positions``; ``slice_table`` and ``slice_subset_pairs``
    int64 tensors there too.  ``energies=False`` skips the structure-factor
    products of the energies and returns None for them (the fused engine's
    force-only steps).

    With ``group`` (a ``torch.distributed`` process group) the particle
    arrays hold one rank's atoms, as many on every rank (the JAX package's
    ``psum_axis``, ``ewald.py:64-66``): each chunk's per-subset structure
    factors are summed over the group before they are used, so the slice
    energies are every rank's and the forces those of the rank's atoms."""
    dtype, dev = positions.dtype, positions.device
    n = positions.shape[0]
    recip_size = 2.0 * math.pi / torch.diagonal(box)
    kvecs = kvec_ints.to(dtype) * recip_size[None, :]          # (K, 3)
    k2 = torch.sum(kvecs * kvecs, dim=-1)
    volume = box[0, 0] * box[1, 1] * box[2, 2]
    recip_coeff = ONE_4PI_EPS0 * 4.0 * math.pi / volume
    ak = torch.exp(k2 * (-1.0 / (4.0 * alpha * alpha))) / k2  # (K,)
    onehot = torch.nn.functional.one_hot(subsets.long(), num_subsets).to(dtype)
    lam_rows = lam_coul_s[slice_table][subsets.long()]         # (N, nsub)
    emat = torch.zeros((num_subsets, num_subsets), dtype=torch.float64,
                       device=dev)
    forces = torch.zeros((n, 3), dtype=dtype, device=dev)
    chunk = max(1, CHUNK_ELEMENTS // max(n, 1))
    for k0 in range(0, kvecs.shape[0], chunk):
        kv = kvecs[k0:k0 + chunk]
        a = ak[k0:k0 + chunk]
        phase = positions @ kv.T                               # (N, Kc)
        t_re = charge[:, None] * torch.cos(phase)
        t_im = charge[:, None] * torch.sin(phase)
        s_re = onehot.T @ t_re                                 # (nsub, Kc)
        s_im = onehot.T @ t_im
        if group is not None:
            collectives.all_reduce(s_re, group)
            collectives.all_reduce(s_im, group)
        if energies:
            s_re64, s_im64 = s_re.to(torch.float64), s_im.to(torch.float64)
            a64 = a.to(torch.float64)
            emat += (s_re64 * a64) @ s_re64.T + (s_im64 * a64) @ s_im64.T
        # f_n += 2 rc ak Im(t_n conj(L_n)) k (cpp:336-345)
        w = t_im * (lam_rows @ s_re) - t_re * (lam_rows @ s_im)
        forces += (w * a) @ kv
    if not energies:
        return None, 2.0 * recip_coeff * forces
    pair_i = slice_subset_pairs[:, 0]
    pair_j = slice_subset_pairs[:, 1]
    # the diagonal slices once, the others twice (cpp:347-351)
    weights = torch.where(pair_i == pair_j, 1.0, 2.0).to(torch.float64)
    slice_coul = recip_coeff.to(torch.float64) * weights * emat[pair_i, pair_j]
    return slice_coul, 2.0 * recip_coeff * forces
