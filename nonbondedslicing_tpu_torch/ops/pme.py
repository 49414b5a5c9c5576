"""Sliced smooth Particle-Mesh Ewald: host tables and spectrum arithmetic.

One charge grid per subset, shaped (nsub, nx, ny, nz); slice energies come
from cross products of the subset spectra (diagonal slice
0.5*eterm*|S_j|^2, off-diagonal eterm*Re(S_i conj(S_j)),
ReferencePME.cpp:473-492).  The fused engine's spread and interpolation
kernels and the FFTs around them live in :mod:`.cuda_pme`.

The generic engine's PME (:func:`pme_reciprocal`, the JAX package's
``pme.py:874-935``) works on atoms: B-spline stencils spread into 64-bit
fixed-point grids (:func:`spread_fixed`), ``torch.fft`` transforms, the
convolution kernel built from the runtime box, and forces gathered from
the lambda-combined potential grids.  It is plain array code in the JAX
package too.

The spread is repeatable to the bit on every device, as the reference's
CUDA platform's is (its fixed-point charge spreading): each stencil
contribution is rounded once to an integer multiple of 2^-k, the integers
are added with ``index_add_`` (integer addition is associative, so the
order in which atoms land, CUDA's atomics, a CUDA graph's replay or the
ranks of a sharded sum change nothing), and the grid is converted once to
the working dtype.  One code path serves the CPU and the card.
"""

import math

import numpy as np
import torch

from ..parallel import collectives
from ..utils.constants import ONE_4PI_EPS0
from .geometry import recip_box_vectors


# --------------------------------------------------------------------- host

def _bspline_coeffs(order):
    """Values of the order-`order` cardinal B-spline at integer nodes 1..order
    evaluated at fraction 0 (ReferencePME.cpp:115-144)."""
    data = np.zeros(order)
    data[0] = 1.0
    for k in range(3, order):
        div = 1.0 / (k - 1)
        data[k - 1] = 0.0
        for l in range(1, k - 1):
            data[k - l - 1] = div * (l * data[k - l - 2] + (k - l) * data[k - l - 1])
        data[0] = div * data[0]
    div = 1.0 / (order - 1)
    data[order - 1] = 0.0
    for l in range(1, order - 1):
        data[order - l - 1] = div * (l * data[order - l - 2] + (order - l) * data[order - l - 1])
    data[0] = div * data[0]
    return data


def bspline_moduli(grid_shape, order=5):
    """|DFT of the B-spline stencil|^2 per axis (ReferencePME.cpp:146-177)."""
    data = _bspline_coeffs(order)
    out = []
    for ndata in grid_shape:
        bsp = np.zeros(max(ndata, order + 1))
        bsp[1:order + 1] = data
        j = np.arange(ndata)
        angles = 2.0 * np.pi * np.outer(j, j) / ndata
        sc = bsp[:ndata] @ np.cos(angles)
        ss = bsp[:ndata] @ np.sin(angles)
        mod = sc * sc + ss * ss
        small = mod < 1e-7
        if small.any():
            fixed = mod.copy()
            for i in np.nonzero(small)[0]:
                fixed[i] = (mod[(i - 1) % ndata] + mod[(i + 1) % ndata]) / 2
            mod = fixed
        out.append(mod)
    return tuple(out)


def coulomb_eterm_np(grid_shape, moduli, box, alpha, half=True):
    """Reciprocal-space convolution kernel for a static (host) box
    (ReferencePME.cpp:400-496), over the z-half spectrum when ``half``."""
    box = np.asarray(box, dtype=np.float64)
    recip = np.linalg.inv(box).T
    nx, ny, nz = grid_shape

    def freqs(n):
        k = np.arange(n)
        return np.where(k < (n + 1) // 2, k, k - n)

    mx = freqs(nx)[:, None, None]
    my = freqs(ny)[None, :, None]
    mz = (np.arange(nz // 2 + 1) if half else freqs(nz))[None, None, :]
    mhx = mx * recip[0, 0]
    mhy = mx * recip[1, 0] + my * recip[1, 1]
    mhz = mx * recip[2, 0] + my * recip[2, 1] + mz * recip[2, 2]
    m2 = mhx * mhx + mhy * mhy + mhz * mhz
    volume = box[0, 0] * box[1, 1] * box[2, 2]
    bx = math.pi * volume * np.asarray(moduli[0])[:, None, None]
    by = np.asarray(moduli[1])[None, :, None]
    bz = np.asarray(moduli[2][:nz // 2 + 1] if half else moduli[2])[None, None, :]
    factor = math.pi * math.pi / (alpha * alpha)
    denom = m2 * bx * by * bz
    safe = denom != 0
    eterm = np.where(safe,
                     ONE_4PI_EPS0 * np.exp(-factor * np.where(safe, m2, 1.0))
                     / np.where(safe, denom, 1.0), 0.0)
    # zero frequency excluded (handled by the plasma correction)
    eterm[0, 0, 0] = 0.0
    return eterm


def dispersion_eterm_np(grid_shape, moduli, box, alpha, half=True):
    """LJPME's reciprocal-space convolution kernel of the C6 grids for a
    static (host) box (the JAX package's ``pme.dispersion_eterm_np``), over
    the z-half spectrum when ``half``.
    Unlike the Coulomb kernel it keeps the zero frequency: the dispersion
    sum has no neutralizing background."""
    box = np.asarray(box, dtype=np.float64)
    recip = np.linalg.inv(box).T
    nx, ny, nz = grid_shape

    def freqs(n):
        k = np.arange(n)
        return np.where(k < (n + 1) // 2, k, k - n)

    mx = freqs(nx)[:, None, None]
    my = freqs(ny)[None, :, None]
    mz = (np.arange(nz // 2 + 1) if half else freqs(nz))[None, None, :]
    mhx = mx * recip[0, 0]
    mhy = mx * recip[1, 0] + my * recip[1, 1]
    mhz = mx * recip[2, 0] + my * recip[2, 1] + mz * recip[2, 2]
    m2 = mhx * mhx + mhy * mhy + mhz * mhz
    volume = box[0, 0] * box[1, 1] * box[2, 2]
    boxfactor = -2.0 * math.pi * math.sqrt(math.pi) / (6.0 * volume)
    bx = np.asarray(moduli[0])[:, None, None]
    by = np.asarray(moduli[1])[None, :, None]
    bz = np.asarray(moduli[2][:nz // 2 + 1] if half else moduli[2])[None, None, :]
    m = np.sqrt(m2)
    b = (math.pi / alpha) * m
    erfc_b = np.vectorize(math.erfc)(b)
    return ((2.0 * math.pi ** 3 * math.sqrt(math.pi) * erfc_b * m * m2
             + np.exp(-b * b) * (alpha ** 3 - 2.0 * alpha * math.pi ** 2 * m2))
            * boxfactor / (bx * by * bz))


def rfft_energy_weights(nz, device):
    """Full-spectrum equivalence weights for the z-half-space layout: modes
    0 and (even) nz/2 are self-conjugate (weight 1), the rest represent a
    +/-k pair (weight 2), as in the reference's R2C kernels
    (kernels/pme.cc:138-189).  A float64 tensor filled on ``device`` (no
    host->device copy, so that it may be captured in a CUDA graph)."""
    w = torch.full((nz // 2 + 1,), 2.0, dtype=torch.float64, device=device)
    w[0].fill_(1.0)
    if nz % 2 == 0:
        w[-1].fill_(1.0)
    return w


# ------------------------------------------------------------------- torch

def bsplines(frac, order=5):
    """Order-`order` B-spline values and derivatives at fractional offsets.

    frac: (...,) tensor in [0, 1).  Returns (theta, dtheta), each
    (..., order).  Recursions follow ReferencePME.cpp:264-317.
    """
    zero = torch.zeros_like(frac)
    data = [zero] * order
    data[1] = frac
    data[0] = 1.0 - frac
    for k in range(3, order):
        div = 1.0 / (k - 1)
        data[k - 1] = div * frac * data[k - 2]
        for l in range(1, k - 1):
            data[k - l - 1] = div * ((frac + l) * data[k - l - 2]
                                     + (k - l - frac) * data[k - l - 1])
        data[0] = div * (1.0 - frac) * data[0]
    ddata = [zero] * order
    ddata[0] = -data[0]
    for k in range(1, order):
        ddata[k] = data[k - 1] - data[k]
    div = 1.0 / (order - 1)
    data[order - 1] = div * frac * data[order - 2]
    for l in range(1, order - 1):
        data[order - l - 1] = div * ((frac + l) * data[order - l - 2]
                                     + (order - l - frac) * data[order - l - 1])
    data[0] = div * (1.0 - frac) * data[0]
    return torch.stack(data, dim=-1), torch.stack(ddata, dim=-1)


def pme_slice_energies_ri(re, im, eterm_weighted, slice_subset_pairs):
    """Per-slice reciprocal energies (S,) float64 from z-half spectra given
    as real/imaginary parts (nsub, nx, ny, nzr), accumulated in float64;
    ``slice_subset_pairs`` (S, 2) int64 on their device."""
    nsub = re.shape[0]
    fr = re.reshape(nsub, -1).to(torch.float64)
    fi = im.reshape(nsub, -1).to(torch.float64)
    ew = eterm_weighted.reshape(-1).to(torch.float64)[None, :]
    emat = (fr * ew) @ fr.T + (fi * ew) @ fi.T
    pair_i, pair_j = slice_subset_pairs[:, 0], slice_subset_pairs[:, 1]
    scale = torch.where(pair_i == pair_j, 0.5, 1.0).to(torch.float64)
    return scale * emat[pair_i, pair_j]


def grid_index_and_fraction(positions, recip, grid_shape):
    """Grid indices (int64) and fractional offsets of every atom
    (ReferencePME.cpp:196-256).  The grid sizes enter as scalars, axis by
    axis: no host->device copy."""
    t = positions @ recip
    t = t - torch.floor(t)
    t = torch.stack([t[:, a] * grid_shape[a] for a in range(3)], dim=1)
    ti = t.to(torch.int32)
    frac = t - ti
    index = torch.stack([ti[:, a].long() % grid_shape[a] for a in range(3)],
                        dim=1)
    return index, frac


def _stencil_lines(index, grid_shape, order):
    """The ``order`` grid lines per axis of every atom's stencil."""
    offs = torch.arange(order, device=index.device)
    return [(index[:, a:a + 1] + offs) % grid_shape[a] for a in range(3)]


# 2^k sum|w| stays at or below 2^FIXED_POINT_BITS: 2^3 below int64's range,
# more than the rounding of N * 125 contributions by half a unit each adds
FIXED_POINT_BITS = 60
FIXED_POINT_MAX_K = 100   # all-zero weights: a finite scale, and 2^k and
                          # 2^-k stay normal floats


def fixed_point_scale(weights):
    """The fixed-point scale 2^k of a spread of ``weights`` (charges, or
    LJPME's C6): the largest integer k with 2^k sum_i |w_i| <=
    2^FIXED_POINT_BITS, as a 0-d float64 tensor on their device, built
    there without a host sync (it may run in a CUDA graph's capture).
    B-spline weights lie in [0, 1] and an atom's 125 stencil weights add up
    to 1, so no grid point exceeds sum |w| and no int64 point overflows.
    A sharded spread takes the scale of all atoms on every rank, so that
    the ranks' grids add up to the single device's."""
    total = weights.detach().abs().to(torch.float64).sum()
    k = torch.floor(FIXED_POINT_BITS - torch.log2(total)).clamp(
        -FIXED_POINT_MAX_K, FIXED_POINT_MAX_K)
    # 2^k exactly: k + 1023 in the exponent field of a double
    return torch.bitwise_left_shift(k.long() + 1023, 52).view(torch.float64)


def spread_fixed(charges, subsets, index, theta, grid_shape, num_subsets,
                 scale, order=5):
    """B-spline stencils of every atom added into per-subset int64 grids
    (nsub, nx, ny, nz): each contribution computed in the dtype of
    ``charges``, rounded once to an integer number of units 2^-k (``scale``
    = 2^k, :func:`fixed_point_scale`) and added with ``index_add_``, so the
    sums are exact and the grid does not depend on the order of the
    atoms."""
    nx, ny, nz = grid_shape
    ix, iy, iz = _stencil_lines(index, grid_shape, order)
    vals = (charges[:, None, None, None] * theta[:, 0, :, None, None]
            * theta[:, 1, None, :, None] * theta[:, 2, None, None, :])
    lin = (((subsets.long()[:, None, None, None] * nx + ix[:, :, None, None])
            * ny + iy[:, None, :, None]) * nz + iz[:, None, None, :])
    grid = torch.zeros(num_subsets * nx * ny * nz, dtype=torch.int64,
                       device=charges.device)
    grid.index_add_(0, lin.reshape(-1),
                    torch.round(vals * scale).to(torch.int64).reshape(-1))
    return grid.reshape(num_subsets, nx, ny, nz)


def fixed_to_grid(fixed, scale, dtype):
    """An int64 grid of :func:`spread_fixed` as a ``dtype`` grid: each
    point rounded once to ``dtype``, then times 2^-k (exact)."""
    return fixed.to(dtype) * (1.0 / scale).to(dtype)


def _freq_m2(grid_shape, recip, half):
    """|m|^2 of the scaled frequency vectors over the full (or z-half)
    grid, from the runtime reciprocal box."""
    nx, ny, nz = grid_shape
    dtype, dev = recip.dtype, recip.device

    def freqs(n):
        k = torch.arange(n, device=dev)
        return torch.where(k < (n + 1) // 2, k, k - n).to(dtype)

    mx = freqs(nx)[:, None, None]
    my = freqs(ny)[None, :, None]
    mz = (torch.arange(nz // 2 + 1, device=dev).to(dtype) if half
          else freqs(nz))[None, None, :]
    mhx = mx * recip[0, 0]
    mhy = mx * recip[1, 0] + my * recip[1, 1]
    mhz = mx * recip[2, 0] + my * recip[2, 1] + mz * recip[2, 2]
    return mhx * mhx + mhy * mhy + mhz * mhz


def _moduli(moduli, nz, half, like):
    """The three B-spline moduli (tensors on the device of ``like``) as
    broadcastable tensors like ``like``."""
    bz = moduli[2][:nz // 2 + 1] if half else moduli[2]
    return [m.to(like.dtype).reshape(shape)
            for m, shape in ((moduli[0], (-1, 1, 1)), (moduli[1], (1, -1, 1)),
                             (bz, (1, 1, -1)))]


def coulomb_eterm(grid_shape, moduli, box, recip, alpha, half=False):
    """The Coulomb convolution kernel from the runtime box
    (ReferencePME.cpp:400-496), zero at the zero frequency (the plasma term
    carries it)."""
    m2 = _freq_m2(grid_shape, recip, half)
    bx, by, bz = _moduli(moduli, grid_shape[2], half, m2)
    volume = box[0, 0] * box[1, 1] * box[2, 2]
    denom = m2 * (math.pi * volume * bx) * by * bz
    safe = denom != 0
    factor = math.pi * math.pi / (alpha * alpha)
    eterm = torch.where(
        safe, ONE_4PI_EPS0 * torch.exp(-factor * torch.where(safe, m2, 1.0))
        / torch.where(safe, denom, 1.0), 0.0)
    # a fill, not a copy of a host scalar: this may run in a graph capture
    eterm[0, 0, 0].fill_(0.0)
    return eterm


def dispersion_eterm(grid_shape, moduli, box, recip, alpha, half=False):
    """LJPME's convolution kernel of the C6 grids from the runtime box,
    the zero frequency included (ReferencePME.cpp:499-595)."""
    m2 = _freq_m2(grid_shape, recip, half)
    bx, by, bz = _moduli(moduli, grid_shape[2], half, m2)
    volume = box[0, 0] * box[1, 1] * box[2, 2]
    boxfactor = -2.0 * math.pi * math.sqrt(math.pi) / (6.0 * volume)
    m = torch.sqrt(m2)
    b = (math.pi / alpha) * m
    return ((2.0 * math.pi ** 3 * math.sqrt(math.pi)
             * torch.special.erfc(b) * m * m2
             + torch.exp(-b * b) * (alpha ** 3
                                    - 2.0 * alpha * math.pi ** 2 * m2))
            * boxfactor / (bx * by * bz))


def interpolate_forces(phi, charges, subsets, index, theta, dtheta, recip,
                       lam_nn, grid_shape, order=5):
    """Forces gathered from the lambda-combined potential grids
    C[s] = sum_t lam(s, t) phi[t] (ReferencePME.cpp:598-702)."""
    nx, ny, nz = grid_shape
    combined = torch.einsum("st,txyz->sxyz", lam_nn, phi)
    ix, iy, iz = _stencil_lines(index, grid_shape, order)
    vals = combined[subsets.long()[:, None, None, None],
                    ix[:, :, None, None], iy[:, None, :, None],
                    iz[:, None, None, :]]
    tx, ty, tz = theta[:, 0], theta[:, 1], theta[:, 2]
    dtx, dty, dtz = dtheta[:, 0], dtheta[:, 1], dtheta[:, 2]
    fx = torch.einsum("nijk,ni,nj,nk->n", vals, dtx, ty, tz)
    fy = torch.einsum("nijk,ni,nj,nk->n", vals, tx, dty, tz)
    fz = torch.einsum("nijk,ni,nj,nk->n", vals, tx, ty, dtz)
    f0 = -charges * (fx * nx * recip[0, 0])
    f1 = -charges * (fx * nx * recip[1, 0] + fy * ny * recip[1, 1])
    f2 = -charges * (fx * nx * recip[2, 0] + fy * ny * recip[2, 1]
                     + fz * nz * recip[2, 2])
    return torch.stack([f0, f1, f2], dim=-1)


def pme_reciprocal(positions, box, charges, subsets, lam_s, *, alpha,
                   grid_shape, moduli, num_subsets, slice_subset_pairs,
                   slice_table, dispersion=False, order=5, eterm=None,
                   group=None, energies=True, scale=None):
    """Sliced PME of one term (Coulomb charges, or LJPME's C6 with
    ``dispersion``) on atoms: (slice energies (S,) float64, forces (N, 3));
    ``energies=False`` skips the energies (and their float64 spread) and
    returns None for them.
    ``eterm`` optionally supplies the z-half convolution kernel, valid
    while the box is the one it was built from; else it is built from
    ``box``.  ``moduli`` (the three B-spline moduli), ``slice_subset_pairs``
    and ``slice_table`` are tensors on the device of ``positions`` (int64
    for the tables): a call copies nothing from the host, so it may run
    inside a CUDA graph's capture.  The spread is the fixed-point one
    (:func:`spread_fixed`, at ``scale``, by default
    ``fixed_point_scale(charges)``), so a call repeats to the bit and
    atoms given in another order give the same grids, the same slice
    energies and their forces in that order.  In float32 the energies come
    from a second, float64 spread of the same atoms (splines from a float64
    reciprocal box, a float64 grid and transform), as the fused engine's do
    (ROADMAP D1): a float32 grid's rounding reaches a weak slice's
    dE/dlambda.

    With ``group`` (a ``torch.distributed`` process group) the particle
    arrays hold one rank's atoms (``parallel/pme_shard.py``) and ``scale``
    is that of all atoms, the same on every rank: its int64 grids (the
    float64 energies' one too) are summed over the group before they are
    converted, so they equal the single device's to the bit, the slice
    energies are every rank's and the forces those of the rank's atoms."""
    if scale is None:
        scale = fixed_point_scale(charges)
    recip = recip_box_vectors(box)
    index, frac = grid_index_and_fraction(positions, recip, grid_shape)
    theta, dtheta = bsplines(frac, order)
    fixed = spread_fixed(charges, subsets, index, theta, grid_shape,
                         num_subsets, scale, order)
    if group is not None:
        collectives.all_reduce(fixed, group)
    grid = fixed_to_grid(fixed, scale, positions.dtype)
    nx, ny, nz = grid_shape
    if eterm is None:
        make = dispersion_eterm if dispersion else coulomb_eterm
        eterm = make(grid_shape, moduli, box, recip, alpha, half=True)
    spectra = torch.fft.rfftn(grid, dim=(1, 2, 3))
    if not energies:
        slice_energies = None
    elif positions.dtype == torch.float64:
        spectra64 = spectra
    else:
        f64 = torch.float64
        index64, frac64 = grid_index_and_fraction(
            positions.to(f64), recip_box_vectors(box.to(f64)), grid_shape)
        fixed64 = spread_fixed(charges.to(f64), subsets, index64,
                               bsplines(frac64, order)[0], grid_shape,
                               num_subsets, scale, order)
        if group is not None:
            collectives.all_reduce(fixed64, group)
        spectra64 = torch.fft.rfftn(fixed_to_grid(fixed64, scale, f64),
                                    dim=(1, 2, 3))
    if energies:
        slice_energies = pme_slice_energies_ri(
            spectra64.real, spectra64.imag,
            eterm.to(torch.float64) * rfft_energy_weights(nz,
                                                          positions.device),
            slice_subset_pairs)
    # the unnormalized inverse: phi(r) = sum_k eterm S(k) e^{+ik.r}
    phi = torch.fft.irfftn(spectra * eterm[None], s=grid_shape,
                           dim=(1, 2, 3)) * (nx * ny * nz)
    forces = interpolate_forces(phi, charges, subsets, index, theta, dtheta,
                                recip, lam_s[slice_table], grid_shape, order)
    return slice_energies, forces
