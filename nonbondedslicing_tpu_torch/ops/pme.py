"""Sliced smooth Particle-Mesh Ewald: host tables and spectrum arithmetic.

One charge grid per subset, shaped (nsub, nx, ny, nz); slice energies come
from cross products of the subset spectra (diagonal slice
0.5*eterm*|S_j|^2, off-diagonal eterm*Re(S_i conj(S_j)),
ReferencePME.cpp:473-492).  The spread and interpolation kernels and the
FFTs around them live in :mod:`.cuda_pme`.
"""

import math

import numpy as np
import torch

from ..utils.constants import ONE_4PI_EPS0


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


def rfft_energy_weights(nz):
    """Full-spectrum equivalence weights for the z-half-space layout: modes
    0 and (even) nz/2 are self-conjugate (weight 1), the rest represent a
    +/-k pair (weight 2), as in the reference's R2C kernels
    (kernels/pme.cc:138-189)."""
    w = np.full(nz // 2 + 1, 2.0)
    w[0] = 1.0
    if nz % 2 == 0:
        w[-1] = 1.0
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
    as real/imaginary parts (nsub, nx, ny, nzr), accumulated in float64."""
    nsub = re.shape[0]
    fr = re.reshape(nsub, -1).to(torch.float64)
    fi = im.reshape(nsub, -1).to(torch.float64)
    ew = eterm_weighted.reshape(-1).to(torch.float64)[None, :]
    emat = (fr * ew) @ fr.T + (fi * ew) @ fi.T
    pairs = torch.as_tensor(np.asarray(slice_subset_pairs), dtype=torch.int64,
                            device=re.device)
    pair_i, pair_j = pairs[:, 0], pairs[:, 1]
    scale = torch.where(pair_i == pair_j, 0.5, 1.0).to(torch.float64)
    return scale * emat[pair_i, pair_j]
