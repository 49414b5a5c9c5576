"""Sliced PME reciprocal space: spread and interpolation kernels (CUDA),
their plain twins, and the FFT pipeline around them.

Port of ``nonbondedslicing_tpu/ops/pallas_pme.py``: ``make_spread_kernel``
becomes ``pme_spread`` (``csrc/pme_spread.cu``) and ``make_interp_kernel``
becomes ``pme_interp`` (``csrc/pme_interp.cu``).  The TPU kernels work on
per-brick windows whose overlap-add is folded into matmul DFTs; here the
kernels spread into and read from whole (nsub, nx, ny, nz) grids, and the
transforms are ``torch.fft.rfftn`` / ``irfftn`` (cuFFT on the card).  Grid
point k of an atom along an axis is (floor(t) + k) mod n, t the scaled
fractional coordinate, as in the JAX package.

Slot tensors: ``slot_pos`` (n_cells, 3, C) float, ``slot_q`` (n_cells, C)
float (0 on pad slots), ``slot_sub`` (n_cells, C) int32.  The wrappers launch
the kernels for CUDA tensors and run the plain twins only for CPU tensors.

Evaluations with energies spread the charges a second time, in double
(``double=True``: splines and weights in float64, a float64 grid), and take
the slice energies from its float64 spectra; their forces come from the
float grid, as on every other step.  A weakly coupled slice's reciprocal
energy is a small cross term of two large grids, which float spline
weights blur by about as much as its dE/dlambda may err.
"""

import numpy as np
import torch

from ..runtime.kernels import LIBRARY
from .cuda_direct import _check
from .geometry import recip_box_vectors
from .pme import bsplines, pme_slice_energies_ri, rfft_energy_weights

PME_ORDER = 5

# launches of the CUDA kernels
LAUNCHES = {"pme_spread": 0, "pme_spread_energies": 0, "pme_interp": 0}


def _splines(slot_pos, recip, grid_shape, derivatives):
    """Per-slot grid base (M, 3) int64, theta and dtheta (M, 3, order)."""
    pos = slot_pos.transpose(1, 2).reshape(-1, 3)
    f = pos @ recip
    n = torch.as_tensor(grid_shape, dtype=pos.dtype, device=pos.device)
    t = (f - torch.floor(f)) * n
    ti = torch.floor(t)
    theta, dtheta = bsplines(t - ti, PME_ORDER)
    base = ti.long() % torch.as_tensor(grid_shape, device=pos.device)
    return base, theta, (dtheta if derivatives else None)


def _stencil_index(base, grid_shape, sub):
    """(M, order, order, order) flat indices into (nsub, nx, ny, nz)."""
    nx, ny, nz = grid_shape
    k = torch.arange(PME_ORDER, device=base.device)
    ix = (base[:, 0:1] + k) % nx
    iy = (base[:, 1:2] + k) % ny
    iz = (base[:, 2:3] + k) % nz
    return (((sub[:, None, None, None] * nx + ix[:, :, None, None]) * ny
             + iy[:, None, :, None]) * nz + iz[:, None, None, :])


def pme_spread_plain(slot_pos, slot_q, slot_sub, recip, grid_shape, nsub,
                     double=False):
    """Plain torch twin of the spread kernel: (nsub, nx, ny, nz) grids, in
    float64 with ``double``."""
    if double:
        slot_pos, slot_q = slot_pos.double(), slot_q.double()
        recip = recip.double()
    base, th, _ = _splines(slot_pos, recip, grid_shape, False)
    q = slot_q.reshape(-1)
    vals = (q[:, None, None, None] * th[:, 0, :, None, None]
            * th[:, 1, None, :, None] * th[:, 2, None, None, :])
    idx = _stencil_index(base, grid_shape, slot_sub.reshape(-1).long())
    grid = torch.zeros(nsub * int(np.prod(grid_shape)), dtype=slot_pos.dtype,
                       device=slot_pos.device)
    grid.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return grid.reshape((nsub,) + tuple(grid_shape))


def pme_interp_plain(phi, slot_pos, slot_q, slot_sub, recip):
    """Plain torch twin of the interpolation kernel: forces (n_cells, 3, C)
    from the combined potential grids ``phi`` (nsub, nx, ny, nz)."""
    grid_shape = tuple(phi.shape[1:])
    nx, ny, nz = grid_shape
    base, th, dth = _splines(slot_pos, recip, grid_shape, True)
    idx = _stencil_index(base, grid_shape, slot_sub.reshape(-1).long())
    vals = phi.reshape(-1)[idx]                          # (M, 5, 5, 5)
    tx, ty, tz = th[:, 0], th[:, 1], th[:, 2]
    dtx, dty, dtz = dth[:, 0], dth[:, 1], dth[:, 2]
    fx = torch.einsum("mijk,mi,mj,mk->m", vals, dtx, ty, tz) * nx
    fy = torch.einsum("mijk,mi,mj,mk->m", vals, tx, dty, tz) * ny
    fz = torch.einsum("mijk,mi,mj,mk->m", vals, tx, ty, dtz) * nz
    q = slot_q.reshape(-1)
    f = torch.stack([
        -q * (fx * recip[0, 0]),
        -q * (fx * recip[1, 0] + fy * recip[1, 1]),
        -q * (fx * recip[2, 0] + fy * recip[2, 1] + fz * recip[2, 2])],
        dim=-1)
    g, _, C = slot_pos.shape
    return f.reshape(g, C, 3).transpose(1, 2).contiguous()


def _check_slots(slot_pos, slot_q, slot_sub, dev):
    g, _, C = slot_pos.shape
    _check("slot_pos", slot_pos, (g, 3, C), torch.float32, dev)
    _check("slot_q", slot_q, (g, C), torch.float32, dev)
    _check("slot_sub", slot_sub, (g, C), torch.int32, dev)
    return g, C


def pme_spread(slot_pos, slot_q, slot_sub, recip, grid_shape, nsub,
               double=False):
    """Charge grids (nsub, nx, ny, nz): float32, or with ``double`` float64
    from a float64 ``recip``, splines and weights in double.  CPU tensors
    take the plain twin; CUDA tensors launch the kernel (deterministic
    fixed-point adds)."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pme_spread_plain(slot_pos, slot_q, slot_sub, recip,
                                grid_shape, nsub, double)
    if dev.type != "cuda":
        raise ValueError(f"pme_spread: unsupported device {dev}")
    g, C = _check_slots(slot_pos, slot_q, slot_sub, dev)
    real = torch.float64 if double else torch.float32
    _check("recip", recip, (3, 3), real, dev)
    nx, ny, nz = grid_shape
    acc = torch.zeros((nsub, nx, ny, nz), dtype=torch.int64, device=dev)
    grid = torch.empty((nsub, nx, ny, nz), dtype=real, device=dev)
    LIBRARY.call("nbs_pme_spread", slot_pos.data_ptr(), slot_q.data_ptr(),
                 slot_sub.data_ptr(), recip.data_ptr(), acc.data_ptr(),
                 grid.data_ptr(), g, C, nsub, nx, ny, nz, int(bool(double)),
                 torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["pme_spread_energies" if double else "pme_spread"] += 1
    return grid


def pme_interp(phi, slot_pos, slot_q, slot_sub, recip):
    """Slot forces (n_cells, 3, C).  CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pme_interp_plain(phi, slot_pos, slot_q, slot_sub, recip)
    if dev.type != "cuda":
        raise ValueError(f"pme_interp: unsupported device {dev}")
    g, C = _check_slots(slot_pos, slot_q, slot_sub, dev)
    _check("recip", recip, (3, 3), torch.float32, dev)
    _check("phi", phi, phi.shape, torch.float32, dev)
    if phi.dim() != 4:
        raise ValueError(f"phi must be (nsub, nx, ny, nz), got {phi.shape}")
    nx, ny, nz = phi.shape[1:]
    forces = torch.empty((g, 3, C), dtype=torch.float32, device=dev)
    LIBRARY.call("nbs_pme_interp", phi.data_ptr(), slot_pos.data_ptr(),
                 slot_q.data_ptr(), slot_sub.data_ptr(), recip.data_ptr(),
                 forces.data_ptr(), g, C, nx, ny, nz,
                 torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["pme_interp"] += 1
    return forces


def pme_reciprocal(slot_pos, slot_q, slot_sub, box, lam_nn, *, grid_shape,
                   eterm, slice_subset_pairs, energies=True):
    """Sliced PME for slot-ordered atoms.

    ``eterm`` is the z-half convolution kernel (nx, ny, nz//2+1) in the
    working dtype (``pme.coulomb_eterm_np``); ``lam_nn`` (nsub, nsub) the
    Coulomb lambda of each subset pair.  Returns (slice_energies (S,)
    float64 — zeros unless ``energies`` — and slot forces (n_cells, 3, C)).
    """
    nsub = lam_nn.shape[0]
    dev = slot_pos.device
    recip = recip_box_vectors(box)
    grid = pme_spread(slot_pos, slot_q, slot_sub, recip, grid_shape, nsub)
    spec = torch.fft.rfftn(grid, dim=(1, 2, 3))
    n_slices = np.asarray(slice_subset_pairs).shape[0]
    if energies:
        grid64 = pme_spread(slot_pos, slot_q, slot_sub,
                            recip_box_vectors(box.to(torch.float64)),
                            grid_shape, nsub, double=True)
        spec64 = torch.fft.rfftn(grid64, dim=(1, 2, 3))
        w = torch.as_tensor(rfft_energy_weights(grid_shape[2]),
                            dtype=torch.float64, device=dev)
        slice_e = pme_slice_energies_ri(spec64.real, spec64.imag,
                                        eterm.to(torch.float64) * w,
                                        slice_subset_pairs)
    else:
        slice_e = torch.zeros(n_slices, dtype=torch.float64, device=dev)
    # the lambda combination commutes with the linear inverse transform,
    # so it runs on the (half-size) spectra
    comb = torch.einsum("st,txyk->sxyk", lam_nn.to(spec.dtype),
                        spec * eterm)
    # unnormalized inverse: phi(r) = sum_k eterm * S(k) e^{+ik.r}
    phi = torch.fft.irfftn(comb, s=tuple(grid_shape), dim=(1, 2, 3),
                           norm="forward")
    forces = pme_interp(phi.contiguous(), slot_pos, slot_q, slot_sub, recip)
    return slice_e, forces
