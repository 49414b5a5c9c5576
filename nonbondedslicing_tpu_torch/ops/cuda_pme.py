"""Sliced PME reciprocal space: the spread, interpolation, fold and extract
kernels (CUDA), their plain twins, and the FFT pipelines around them.

Port of ``nonbondedslicing_tpu/ops/pallas_pme.py``.  Two pipelines compute
the same reciprocal forces (``pme_reciprocal(pipeline=...)``); the
transforms of both are ``torch.fft.rfftn`` / ``irfftn`` (cuFFT on the card).

``"stencil"`` (the default): ``make_spread_kernel`` becomes ``pme_spread``
(``csrc/pme_spread.cu``) and ``make_interp_kernel`` becomes ``pme_interp``
(``csrc/pme_interp.cu``), which spread into and read from whole
(nsub, nx, ny, nz) grids, 125 points per atom.  Grid point k of an atom
along an axis is (floor(t) + k) mod n, t the scaled fractional coordinate,
as in the JAX package.

The spread kernel is owner-computes: the slot groups lie on a lattice of
fractional cells (``lattice``: the cell counts, or the bricks of the window
pipeline's slot tensors), and a block owns the grid points of its group's
fractional range, ``spread_owned_ranges``.  It gathers the slots of the
groups within ``spread_radius`` of its own whose stencils reach its points,
sums their contributions in shared memory in 64-bit fixed point and stores
each point once: one launch, no global atomics, the grid bitwise
repeatable.  The radius covers the stencil's reach and the drift an atom
may make between slot rebuilds (half the skin), so the CUDA wrapper takes
both the lattice and the radius.

``"grid"``: the JAX package's brick-window pipeline
(``NBS_PME_PIPELINE=grid``, ``pallas_pme.py:489-513``) on brick-major slot
tensors (``pme_bricks.cells_to_bricks``).  ``pme_spread_windows``
(``csrc/pme_spread_windows.cu``) spreads each brick's atoms into the brick's
own window of w = p + 6 points per axis, starting one grid point before the
brick; ``pme_fold`` (``csrc/pme_fold.cu``, ``make_fold_kernel``) adds the
overlapping windows into the charge grids; after the transforms
``pme_extract`` (``csrc/pme_extract.cu``, ``make_extract_kernel``) copies
the potential grids back into windows and ``pme_interp_windows``
(``csrc/pme_interp_windows.cu``) reads each atom's force from its brick's
window.  Window point u of brick b is line (b*p + u) mod n of the folded
grid, so that grid is the true one rolled by +1 on each axis.  The whole
pipeline stays in that shifted frame without correction: the shift is a pure
phase of the spectrum, which cancels in |S|^2 and passes through the
diagonal convolution unchanged.  A spline point that falls outside its
brick's window (an atom that drifted more than one grid point past it) drops
out, as in the JAX kernels; the skin guard of the MD step keeps atoms inside.
No kernel of this pipeline uses global atomics: its grids and forces are
bitwise repeatable.

Slot tensors: ``slot_pos`` (g, 3, C) float, ``slot_q`` (g, C) float (0 on
pad slots), ``slot_sub`` (g, C) int32; g counts cells (cell-major) or bricks
(brick-major).  Windows are (bx, by, bz, nsub, wx, wy, wz).  The wrappers
launch the kernels for CUDA tensors and run the plain twins only for CPU
tensors.

LJPME runs the same kernels a second time on its dispersion grid
(``pme_reciprocal(..., dispersion=True)``, the JAX package's
``pme_reciprocal_pallas(dispersion=True)``): per-slot C6 in place of the
charge, the vdW lambdas in place of the Coulomb ones and the dispersion
convolution kernel (``pme.dispersion_eterm_np``).  The kernels take any
per-slot weight; ``dispersion`` only counts their launches under names of
their own (``pme_spread_dispersion``, ...).

Evaluations with energies spread the charges a second time, in double
(``pme_spread(..., double=True)``: splines and weights in float64, a float64
grid), and take the slice energies from its float64 spectra under both
pipelines; their forces come from the float pipeline, as on every other
step.  A weakly coupled slice's reciprocal energy is a small cross term of
two large grids, which float spline weights blur by about as much as its
dE/dlambda may err; there is no double window kernel.
"""

import numpy as np
import torch

from ..runtime.kernels import LIBRARY
from .cuda_direct import _check
from .geometry import recip_box_vectors
from .pme import bsplines, pme_slice_energies_ri, rfft_energy_weights
from .pme_bricks import brick_window, check_two_piece_windows

PME_ORDER = 5
# grid points added to an atom's drift in spread_radius: the rounding of
# float32 fractional coordinates (cell ids at the slot rebuild, grid bases
# in the kernel) is far smaller for positions within many box lengths
SPREAD_ROUNDING = 0.05

# launches of the CUDA kernels; "_dispersion" after the kernel's name: the
# LJPME pass
LAUNCHES = {name + kind: 0
            for name in ("pme_spread", "pme_interp", "pme_spread_windows",
                         "pme_fold", "pme_extract", "pme_interp_windows")
            for kind in ("", "_dispersion")}
LAUNCHES.update(pme_spread_energies=0, pme_spread_dispersion_energies=0)


def _count(name, dispersion, double=False):
    LAUNCHES[name + ("_dispersion" if dispersion else "")
             + ("_energies" if double else "")] += 1


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


def spread_owned_ranges(n, nc):
    """(nc + 1,) int64: group c of ``nc`` on an axis of ``n`` grid points
    owns the points [start[c], start[c + 1]), start[c] = ceil(c n / nc): the
    grid points whose fractional coordinate lies in the group's cell range,
    as the spread kernel's blocks own them."""
    c = torch.arange(nc + 1, dtype=torch.int64)
    return (c * n + nc - 1) // nc


def spread_radius(grid_shape, lattice, skin, box):
    """Neighbour radius R per axis of the spread kernel, host ints: the
    fewest groups of the ``lattice`` (n / nc grid points wide) that cover
    the stencil's reach, PME_ORDER - 1 points above an atom's base, plus
    the drift an atom may make after its slot rebuild (half the ``skin`` in
    nm, in grid points of the axis through the reciprocal box of the
    host-side ``box``, so triclinic boxes too) and SPREAD_ROUNDING.  An atom
    of a group more than R below a group then ends its stencil before the
    group's owned points, and one more than R above starts it after them
    (its base lies at most its drift and one point below its cell)."""
    n = torch.as_tensor(grid_shape, dtype=torch.float64)
    nc = torch.as_tensor(lattice, dtype=torch.float64)
    recip = recip_box_vectors(torch.as_tensor(np.asarray(box),
                                              dtype=torch.float64))
    drift = 0.5 * float(skin) * torch.linalg.norm(recip, dim=0) * n
    reach = PME_ORDER - 1 + drift + SPREAD_ROUNDING
    return tuple(int(r) for r in torch.ceil(reach * nc / n))


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


def _stencil_forces(vals, th, dth, slot_q, recip, grid_shape, slot_shape):
    """Slot forces (g, 3, C) from each slot's (M, 5, 5, 5) potential values
    at its spline points."""
    nx, ny, nz = grid_shape
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
    g, _, C = slot_shape
    return f.reshape(g, C, 3).transpose(1, 2).contiguous()


def pme_interp_plain(phi, slot_pos, slot_q, slot_sub, recip):
    """Plain torch twin of the interpolation kernel: forces (n_cells, 3, C)
    from the combined potential grids ``phi`` (nsub, nx, ny, nz)."""
    grid_shape = tuple(phi.shape[1:])
    base, th, dth = _splines(slot_pos, recip, grid_shape, True)
    idx = _stencil_index(base, grid_shape, slot_sub.reshape(-1).long())
    vals = phi.reshape(-1)[idx]                          # (M, 5, 5, 5)
    return _stencil_forces(vals, th, dth, slot_q, recip, grid_shape,
                           slot_pos.shape)


# ------------------------------------------------- the window pipeline

def _window_shapes(W):
    """(bricks, nsub, (wx, wy, wz), (px, py, pz), grid_shape) of windows
    (bx, by, bz, nsub, wx, wy, wz); raises ValueError unless w <= 2p."""
    if W.dim() != 7:
        raise ValueError("windows must be (bx, by, bz, nsub, wx, wy, wz), "
                         f"got {tuple(W.shape)}")
    bricks, nsub, w = tuple(W.shape[:3]), W.shape[3], tuple(W.shape[4:])
    p = tuple(wa - PME_ORDER - 1 for wa in w)
    grid_shape = tuple(b * pa for b, pa in zip(bricks, p))
    if min(p) < 1:
        raise ValueError(f"windows {w} are narrower than the spline stencil")
    check_two_piece_windows(grid_shape, bricks, PME_ORDER)
    return bricks, nsub, w, p, grid_shape


def _window_index(base, slot_sub, grid_shape, bricks, nsub):
    """Flat indices (M, 5, 5, 5) of every slot's spline points in the
    windows (bricks, nsub, wx, wy, wz) of brick-major slots, and the mask of
    the points inside their brick's window.  Spline point k lies at window
    row rel + k, rel = (base - (b*p - 1)) mod n; rows >= w drop out (their
    index is clamped into range)."""
    (px, wx), (py, wy), (pz, wz) = brick_window(grid_shape, bricks, PME_ORDER)
    dev = base.device
    gb = bricks[0] * bricks[1] * bricks[2]
    lin = torch.arange(gb, device=dev).repeat_interleave(base.shape[0] // gb)
    coord = torch.stack([lin // (bricks[1] * bricks[2]),
                         (lin // bricks[2]) % bricks[1], lin % bricks[2]], 1)
    p = torch.as_tensor((px, py, pz), device=dev)
    n = torch.as_tensor(grid_shape, device=dev)
    rel = (base - (coord * p - 1)) % n                   # (M, 3) in [0, n)
    k = torch.arange(PME_ORDER, device=dev)
    rows, inside = [], []
    for a, w in enumerate((wx, wy, wz)):
        r = rel[:, a:a + 1] + k
        inside.append(r < w)
        rows.append(torch.clamp(r, max=w - 1))
    idx = ((((lin * nsub + slot_sub.reshape(-1).long())[:, None, None, None]
             * wx + rows[0][:, :, None, None]) * wy
            + rows[1][:, None, :, None]) * wz + rows[2][:, None, None, :])
    mask = (inside[0][:, :, None, None] & inside[1][:, None, :, None]
            & inside[2][:, None, None, :])
    return idx, mask


def pme_spread_windows_plain(slot_pos, slot_q, slot_sub, recip, grid_shape,
                             bricks, nsub):
    """Plain torch twin of the window spread kernel: charge windows
    (bx, by, bz, nsub, wx, wy, wz) from brick-major slots."""
    check_two_piece_windows(grid_shape, bricks, PME_ORDER)
    (_, wx), (_, wy), (_, wz) = brick_window(grid_shape, bricks, PME_ORDER)
    base, th, _ = _splines(slot_pos, recip, grid_shape, False)
    q = slot_q.reshape(-1)
    vals = (q[:, None, None, None] * th[:, 0, :, None, None]
            * th[:, 1, None, :, None] * th[:, 2, None, None, :])
    idx, mask = _window_index(base, slot_sub, grid_shape, bricks, nsub)
    W = torch.zeros(slot_pos.shape[0] * nsub * wx * wy * wz,
                    dtype=slot_pos.dtype, device=slot_pos.device)
    W.index_add_(0, idx.reshape(-1),
                 torch.where(mask, vals, vals.new_zeros(())).reshape(-1))
    return W.reshape(tuple(bricks) + (nsub, wx, wy, wz))


def pme_interp_windows_plain(W_phi, slot_pos, slot_q, slot_sub, recip):
    """Plain torch twin of the window interpolation kernel: forces
    (g_bricks, 3, C_brick) of brick-major slots from the combined potential
    windows ``W_phi`` (bx, by, bz, nsub, wx, wy, wz)."""
    bricks, nsub, _, _, grid_shape = _window_shapes(W_phi)
    base, th, dth = _splines(slot_pos, recip, grid_shape, True)
    idx, mask = _window_index(base, slot_sub, grid_shape, bricks, nsub)
    vals = W_phi.reshape(-1)[idx]
    vals = torch.where(mask, vals, vals.new_zeros(()))
    return _stencil_forces(vals, th, dth, slot_q, recip, grid_shape,
                           slot_pos.shape)


def pme_fold_plain(W):
    """Plain torch twin of the fold kernel: overlap-add of the windows into
    the +1-shifted grids (nsub, nx, ny, nz).  Each block of p points takes
    at most two bricks' pieces per axis, summed in the order of the kernel
    (x outermost, the brick's own piece first)."""
    bricks, nsub, w, p, grid_shape = _window_shapes(W)
    Wg = W.permute(3, 0, 1, 2, 4, 5, 6)                  # (nsub, b..., w...)
    acc = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                lo = [d * pa for d, pa in zip((dx, dy, dz), p)]
                hi = [min(l + pa, wa) for l, pa, wa in zip(lo, p, w)]
                piece = Wg[..., lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                pad = []
                for a in (2, 1, 0):
                    pad += [0, p[a] - (hi[a] - lo[a])]
                piece = torch.roll(torch.nn.functional.pad(piece, pad),
                                   (dx, dy, dz), dims=(1, 2, 3))
                acc = piece if acc is None else acc + piece
    # (nsub, bx, by, bz, px, py, pz) -> grid-major
    return acc.permute(0, 1, 4, 2, 5, 3, 6).reshape((nsub,) + grid_shape)


def pme_extract_plain(grid, bricks):
    """Plain torch twin of the extract kernel: windows
    (bx, by, bz, nsub, wx, wy, wz) copied from the +1-shifted grids
    (nsub, nx, ny, nz); window point u of brick b is line (b*p + u) mod n."""
    grid_shape = tuple(grid.shape[1:])
    check_two_piece_windows(grid_shape, bricks, PME_ORDER)
    lines = []
    for n, b, (p, w) in zip(grid_shape, bricks,
                            brick_window(grid_shape, bricks, PME_ORDER)):
        lines.append((torch.arange(b, device=grid.device)[:, None] * p
                      + torch.arange(w, device=grid.device)[None, :]) % n)
    ix, iy, iz = lines                                   # (b, w) each
    # (nsub, bx, wx, by, wy, bz, wz)
    W = grid[:, ix[:, :, None, None, None, None],
             iy[None, None, :, :, None, None],
             iz[None, None, None, None, :, :]]
    return W.permute(1, 3, 5, 0, 2, 4, 6).contiguous()


def _check_slots(slot_pos, slot_q, slot_sub, dev):
    g, _, C = slot_pos.shape
    _check("slot_pos", slot_pos, (g, 3, C), torch.float32, dev)
    _check("slot_q", slot_q, (g, C), torch.float32, dev)
    _check("slot_sub", slot_sub, (g, C), torch.int32, dev)
    return g, C


def pme_spread(slot_pos, slot_q, slot_sub, recip, grid_shape, nsub,
               double=False, dispersion=False, lattice=None, radius=None):
    """Charge grids (nsub, nx, ny, nz): float32, or with ``double`` float64
    from a float64 ``recip``, splines and weights in double.  CPU tensors
    take the plain twin.  CUDA tensors launch the kernel (one launch,
    fixed-point sums in shared memory, bitwise repeatable) and need the
    slot groups' ``lattice`` (groups per axis; cell- or brick-major) and
    the neighbour ``radius`` per axis from :func:`spread_radius`.
    ``dispersion`` counts the launch as the LJPME pass's."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pme_spread_plain(slot_pos, slot_q, slot_sub, recip,
                                grid_shape, nsub, double)
    if dev.type != "cuda":
        raise ValueError(f"pme_spread: unsupported device {dev}")
    g, C = _check_slots(slot_pos, slot_q, slot_sub, dev)
    if lattice is None or radius is None:
        raise ValueError("pme_spread: CUDA tensors need the slot groups' "
                         "lattice and the spread_radius")
    if g != lattice[0] * lattice[1] * lattice[2]:
        raise ValueError(f"pme_spread: {g} slot groups for the lattice "
                         f"{tuple(lattice)}")
    if min(grid_shape) < PME_ORDER:
        raise ValueError(f"pme_spread: a grid of {tuple(grid_shape)} points "
                         f"is narrower than the spline stencil")
    real = torch.float64 if double else torch.float32
    _check("recip", recip, (3, 3), real, dev)
    nx, ny, nz = grid_shape
    grid = torch.empty((nsub, nx, ny, nz), dtype=real, device=dev)
    LIBRARY.call("nbs_pme_spread", slot_pos.data_ptr(), slot_q.data_ptr(),
                 slot_sub.data_ptr(), recip.data_ptr(), grid.data_ptr(),
                 *lattice, C, nsub, nx, ny, nz, *radius, int(bool(double)),
                 torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_spread", dispersion, double)
    return grid


def pme_interp(phi, slot_pos, slot_q, slot_sub, recip, dispersion=False):
    """Slot forces (n_cells, 3, C).  CPU tensors take the plain twin; CUDA
    tensors launch the kernel (two threads an atom, splitting its 25 stencil
    lines, a fixed-order reduction: bitwise repeatable).  ``dispersion`` counts the
    launch as the LJPME pass's."""
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
    if min(nx, ny, nz) < PME_ORDER or nx * ny * nz >= 2**31:
        raise ValueError(f"pme_interp: the CUDA kernel takes grids of at "
                         f"least 5 points an axis and fewer than 2^31 in "
                         f"all, got {(nx, ny, nz)}")
    forces = torch.empty((g, 3, C), dtype=torch.float32, device=dev)
    LIBRARY.call("nbs_pme_interp", phi.data_ptr(), slot_pos.data_ptr(),
                 slot_q.data_ptr(), slot_sub.data_ptr(), recip.data_ptr(),
                 forces.data_ptr(), g, C, nx, ny, nz,
                 torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_interp", dispersion)
    return forces


def _check_windows(name, W, dev):
    _check(name, W, W.shape, torch.float32, dev)
    return _window_shapes(W)


def pme_spread_windows(slot_pos, slot_q, slot_sub, recip, grid_shape, bricks,
                       nsub, dispersion=False):
    """Charge windows (bx, by, bz, nsub, wx, wy, wz) of brick-major slots.
    CPU tensors take the plain twin; CUDA tensors launch the kernel (a block
    per brick and subset, fixed-point sums in shared memory, no global
    atomics: bitwise repeatable).  ``dispersion`` counts the launch as the
    LJPME pass's."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pme_spread_windows_plain(slot_pos, slot_q, slot_sub, recip,
                                        grid_shape, bricks, nsub)
    if dev.type != "cuda":
        raise ValueError(f"pme_spread_windows: unsupported device {dev}")
    check_two_piece_windows(grid_shape, bricks, PME_ORDER)
    g, C = _check_slots(slot_pos, slot_q, slot_sub, dev)
    if g != bricks[0] * bricks[1] * bricks[2]:
        raise ValueError(f"pme_spread_windows: {g} slot groups for bricks "
                         f"{tuple(bricks)}")
    _check("recip", recip, (3, 3), torch.float32, dev)
    (px, wx), (py, wy), (pz, wz) = brick_window(grid_shape, bricks, PME_ORDER)
    W = torch.empty(tuple(bricks) + (nsub, wx, wy, wz), dtype=torch.float32,
                    device=dev)
    LIBRARY.call("nbs_pme_spread_windows", slot_pos.data_ptr(),
                 slot_q.data_ptr(), slot_sub.data_ptr(), recip.data_ptr(),
                 W.data_ptr(), C, nsub, *bricks, px, py, pz,
                 torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_spread_windows", dispersion)
    return W


def pme_fold(W, dispersion=False):
    """+1-shifted charge grids (nsub, nx, ny, nz) from windows
    (bx, by, bz, nsub, wx, wy, wz); the true grids are ``roll(., -1)`` on
    each axis.  Raises ValueError unless w <= 2p.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel (a warp an output line, its window
    rows staged whole), whose sums equal the twin's to the bit.
    ``dispersion`` counts the launch as the LJPME pass's."""
    dev = W.device
    if dev.type == "cpu":
        return pme_fold_plain(W)
    if dev.type != "cuda":
        raise ValueError(f"pme_fold: unsupported device {dev}")
    bricks, nsub, _, p, grid_shape = _check_windows("W", W, dev)
    grid = torch.empty((nsub,) + grid_shape, dtype=torch.float32, device=dev)
    LIBRARY.call("nbs_pme_fold", W.data_ptr(), grid.data_ptr(), nsub,
                 *bricks, *p, torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_fold", dispersion)
    return grid


def pme_extract(grid, bricks, dispersion=False):
    """Windows (bx, by, bz, nsub, wx, wy, wz) of the +1-shifted grids
    (nsub, nx, ny, nz), the inverse layout of :func:`pme_fold`.  CPU tensors
    take the plain twin; CUDA tensors launch the kernel (a pure copy).
    ``dispersion`` counts the launch as the LJPME pass's."""
    dev = grid.device
    if dev.type == "cpu":
        return pme_extract_plain(grid, bricks)
    if dev.type != "cuda":
        raise ValueError(f"pme_extract: unsupported device {dev}")
    _check("grid", grid, grid.shape, torch.float32, dev)
    if grid.dim() != 4:
        raise ValueError(f"grid must be (nsub, nx, ny, nz), got {grid.shape}")
    nsub, grid_shape = grid.shape[0], tuple(grid.shape[1:])
    check_two_piece_windows(grid_shape, bricks, PME_ORDER)
    (px, wx), (py, wy), (pz, wz) = brick_window(grid_shape, bricks, PME_ORDER)
    W = torch.empty(tuple(bricks) + (nsub, wx, wy, wz), dtype=torch.float32,
                    device=dev)
    LIBRARY.call("nbs_pme_extract", grid.data_ptr(), W.data_ptr(), nsub,
                 *bricks, px, py, pz,
                 torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_extract", dispersion)
    return W


def pme_interp_windows(W_phi, slot_pos, slot_q, slot_sub, recip,
                       dispersion=False):
    """Forces (g_bricks, 3, C_brick) of brick-major slots from the combined
    potential windows ``W_phi`` (bx, by, bz, nsub, wx, wy, wz).  CPU tensors
    take the plain twin; CUDA tensors launch the kernel.  ``dispersion``
    counts the launch as the LJPME pass's."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pme_interp_windows_plain(W_phi, slot_pos, slot_q, slot_sub,
                                        recip)
    if dev.type != "cuda":
        raise ValueError(f"pme_interp_windows: unsupported device {dev}")
    bricks, nsub, _, p, _ = _check_windows("W_phi", W_phi, dev)
    g, C = _check_slots(slot_pos, slot_q, slot_sub, dev)
    if g != bricks[0] * bricks[1] * bricks[2]:
        raise ValueError(f"pme_interp_windows: {g} slot groups for bricks "
                         f"{bricks}")
    _check("recip", recip, (3, 3), torch.float32, dev)
    forces = torch.empty((g, 3, C), dtype=torch.float32, device=dev)
    LIBRARY.call("nbs_pme_interp_windows", W_phi.data_ptr(),
                 slot_pos.data_ptr(), slot_q.data_ptr(), slot_sub.data_ptr(),
                 recip.data_ptr(), forces.data_ptr(), C, nsub, *bricks, *p,
                 torch.cuda.current_stream(dev).cuda_stream)
    _count("pme_interp_windows", dispersion)
    return forces


PIPELINES = ("stencil", "grid")


def pme_reciprocal(slot_pos, slot_q, slot_sub, box, lam_nn, *, grid_shape,
                   eterm, slice_subset_pairs, energies=True,
                   pipeline="stencil", bricks=None, dispersion=False,
                   lattice=None, radius=None):
    """Sliced PME for slot-ordered atoms.

    ``eterm`` is the z-half convolution kernel (nx, ny, nz//2+1) in the
    working dtype (``pme.coulomb_eterm_np``); ``lam_nn`` (nsub, nsub) the
    Coulomb lambda of each subset pair.  ``dispersion=True`` is LJPME's
    pass: ``slot_q`` holds per-slot C6, ``eterm`` is
    ``pme.dispersion_eterm_np``'s, ``lam_nn`` the vdW lambdas and
    ``grid_shape`` the dispersion grid; the kernels count their launches
    under their dispersion names.  ``pipeline`` is ``"stencil"`` (any
    slot grouping) or ``"grid"``, the window pipeline, which takes
    brick-major slot tensors and their ``bricks`` (see the module
    docstring) and raises ValueError unless every brick has at least 6 grid
    points per axis.  ``lattice`` and ``radius`` are the whole-grid spread's
    (:func:`pme_spread`; needed on CUDA tensors by the stencil pipeline and
    by the energies' double spread of either).  Returns (slice_energies (S,)
    float64 (zeros unless ``energies``) and slot forces (g, 3, C) in the
    grouping given).
    """
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline must be one of {PIPELINES}, got "
                         f"{pipeline!r}")
    nsub = lam_nn.shape[0]
    dev = slot_pos.device
    recip = recip_box_vectors(box)
    if pipeline == "grid":
        if bricks is None:
            raise ValueError("pipeline=\"grid\" needs the bricks of its "
                             "brick-major slot tensors")
        # the +1-shifted frame from here to the interpolation
        grid = pme_fold(pme_spread_windows(slot_pos, slot_q, slot_sub, recip,
                                           grid_shape, bricks, nsub,
                                           dispersion), dispersion)
    else:
        grid = pme_spread(slot_pos, slot_q, slot_sub, recip, grid_shape, nsub,
                          dispersion=dispersion, lattice=lattice,
                          radius=radius)
    spec = torch.fft.rfftn(grid, dim=(1, 2, 3))
    n_slices = np.asarray(slice_subset_pairs).shape[0]
    if energies:
        grid64 = pme_spread(slot_pos, slot_q, slot_sub,
                            recip_box_vectors(box.to(torch.float64)),
                            grid_shape, nsub, double=True,
                            dispersion=dispersion, lattice=lattice,
                            radius=radius)
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
                           norm="forward").contiguous()
    if pipeline == "grid":
        forces = pme_interp_windows(pme_extract(phi, bricks, dispersion),
                                    slot_pos, slot_q, slot_sub, recip,
                                    dispersion)
    else:
        forces = pme_interp(phi, slot_pos, slot_q, slot_sub, recip,
                            dispersion)
    return slice_e, forces
