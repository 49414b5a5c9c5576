"""Direct-space pair kernels over the cell grid (CUDA) and their plain twins.

Ports of two kernels of ``nonbondedslicing_tpu/ops/pallas_direct.py`` that
share the physics of ``_make_pair_block``: LJ (sigma/2 + sigma/2,
2 sqrt(eps) * 2 sqrt(eps)), Coulomb by reaction field or Ewald erfc (the
Abramowitz-Stegun 7.1.26 polynomial, max abs error ~1.5e-7, as the
reference's GPU kernels), the quintic switch, and lambda per pair from the
subsets of the two atoms.

* ``pair_column`` (``csrc/pair_column.cu``) ports
  ``make_pallas_column_kernel``: positions in the image of the cell
  assignment, each neighbour cell shifted by its periodic image, pad slots
  moved far away (``ops/fused.py`` padfix).
* ``pair_cell`` (``csrc/pair_cell.cu``) ports ``make_pallas_cell_kernel`` as
  the fused engine builds it for general exclusions under PME: raw
  positions with minimum image per pair, a real-slot mask (atom index <
  ``n_real``), and the Ewald exclusion corrections of every excluded pair
  in the 27-cell neighbourhood fused in (unwrapped deltas unless
  ``cfg.exceptions_periodic``).

Slot layout (n_cells = ncx*ncy*ncz cells in x-major order, C slots each):

* ``slot_pos`` (n_cells, 3, C) float: positions;
* ``slot_par`` (n_cells, 3, C) float: charge, sigma/2, 2*sqrt(epsilon);
* ``slot_sub``, ``slot_ids`` (n_cells, C) int32: subset and atom index;
* ``slot_excl`` (n_cells, emax, C) int32: excluded partners, -1 padded.

Outputs: forces (n_cells, 3, C) and, with ``energies``, moment panels
(n_panels, 2, nsub, nsub) [Coulomb, vdW]: the unscaled pair energies summed
over (home subset a, partner subset b) with weight 1/2 (every pair is
visited from both sides).  Readers sum the panels (in float64): the plain
twins give one panel per cell, the kernels one per block (``row_blocks``
blocks per cell, ``pair_launch_shape``).  Slice energies are then m[a, a]
on the diagonal and m[a, b] + m[b, a] off it.

The kernels' design (``csrc/pair_common.cuh``): on an H100 they are bound
by the FP32 instruction rate and the latency of shared-memory round trips,
and most of the work is testing the 27 * C candidates of a row atom, of
which a few percent lie within the cutoff.  A block owns a share of one
home cell's rows and stages the real slots of the 27 neighbour cells in
shared memory (pads left out).  One warp takes one row atom; its lanes
test 128 candidates at a time, positions only, with a test that is cheap
and loses no pair (a contracted r^2 against a slightly widened cutoff);
the hits go in a fixed order into a queue per warp, and the pair physics
runs on 32 queued hits at a time with every lane alive: there the cutoff
is decided exactly as the twin decides it, and the partner's parameters
are gathered from the slot tensors.  A lane sums every 32nd hit of its row
and a butterfly adds the lanes in a fixed order, so forces and moments are
the same bits on every launch without atomics.  The cell kernel stages
every position as the periodic image nearest to the middle of the block's
home cell, where a plain difference is the minimum-image delta of every
pair within reach (if the block's data allow it; else a cheap minimum
image per candidate), and runs the exact, division-based sequence for the
queued pairs only.  Pad rows (atom index >= ``n_real``) are skipped.

The wrappers launch the kernels for CUDA tensors and run the plain twins
only for CPU tensors.
"""

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..runtime.kernels import LIBRARY
from ..utils.constants import ONE_4PI_EPS0, SQRT_PI

MODE_REACTION_FIELD = 0
MODE_EWALD = 1
# limits of the CUDA kernels (csrc/pair_common.cuh: register accumulators,
# the row's exclusion list in shared memory, the staged tile)
MAX_SUBSETS = 8
MAX_EXCLUSIONS = 16
MAX_CAPACITY = 1024

# launches of the CUDA kernels by variant (force-only, energies)
LAUNCHES = {"pair_column": 0, "pair_column_energies": 0,
            "pair_cell": 0, "pair_cell_energies": 0}


@dataclass(frozen=True)
class PairConfig:
    counts: tuple
    capacity: int
    nsub: int
    emax: int
    mode: int
    cutoff: float
    krf: float = 0.0
    crf: float = 0.0
    ewald_alpha: float = 0.0
    use_switch: bool = False
    switch_distance: float = 0.0
    exceptions_periodic: bool = False

    @property
    def n_cells(self):
        return self.counts[0] * self.counts[1] * self.counts[2]


def _erfc_gauss_hastings(x):
    """A&S 7.1.26 erfc(x) and exp(-x^2)."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    gauss = torch.exp(-x * x)
    return poly * gauss, gauss


def _neighbor_offsets():
    """The 27 neighbour-cell offsets in the kernels' order (self is 13)."""
    return [(o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1) for o in range(27)]


def _min_image(dx, dy, dz, box):
    """Reduced triclinic minimum image, z then y then x
    (pallas_direct.py:98-111), each operation rounded as the kernel
    rounds it."""
    nz = torch.floor(dz / box[2, 2] + 0.5)
    dx = dx - nz * box[2, 0]
    dy = dy - nz * box[2, 1]
    dz = dz - nz * box[2, 2]
    ny = torch.floor(dy / box[1, 1] + 0.5)
    dx = dx - ny * box[1, 0]
    dy = dy - ny * box[1, 1]
    nx = torch.floor(dx / box[0, 0] + 0.5)
    dx = dx - nx * box[0, 0]
    return dx, dy, dz


def _pair_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl, lam_c_nn,
                lam_v_nn, box, cfg, energies, n_real, cell_kernel):
    """Both kernels' plain twin, in the slot tensors' dtype.  The column
    kernel's does not read ``n_real``: its pads lie beyond the cutoff of
    every slot, so they get zero force as rows and give none as
    candidates."""
    ncx, ncy, ncz = cfg.counts
    C = cfg.capacity
    nsub = cfg.nsub
    g = cfg.n_cells
    dtype = slot_pos.dtype
    dev = slot_pos.device
    sqrt_ke = math.sqrt(ONE_4PI_EPS0)
    grid_pos = slot_pos.reshape(ncx, ncy, ncz, 3, C)
    grid_par = slot_par.reshape(ncx, ncy, ncz, 3, C)
    grid_sub = slot_sub.long().reshape(ncx, ncy, ncz, C)
    grid_ids = slot_ids.reshape(ncx, ncy, ncz, C)
    xi = slot_pos[:, :, :, None]                        # (g, 3, C, 1)
    qi = (slot_par[:, 0] * sqrt_ke)[:, :, None]
    sgi = slot_par[:, 1][:, :, None]
    epi = slot_par[:, 2][:, :, None]
    si = slot_sub.long()[:, :, None]
    excl = slot_excl[:, :, :, None]                     # (g, emax, C, 1)
    oh_i = torch.nn.functional.one_hot(slot_sub.long(), nsub).to(dtype)
    eye = torch.eye(C, dtype=torch.bool, device=dev)
    coords = [torch.arange(n, device=dev) for n in (ncx, ncy, ncz)]
    zero = torch.zeros((), dtype=dtype, device=dev)
    forces = torch.zeros_like(slot_pos)
    moments = (torch.zeros((g, 2, nsub, nsub), dtype=dtype, device=dev)
               if energies else None)
    # compared in the slot dtype: the kernel gets the same value rounded
    # once to float, so pairs at the cutoff fall on the same side
    cutoff2 = cfg.cutoff * cfg.cutoff
    fuse_corrections = cell_kernel and cfg.mode == MODE_EWALD
    for d in _neighbor_offsets():
        # cell c receives cell (c + d) mod nc, whose true image sits at
        # floor((c + d) / nc) box vectors
        roll = dict(shifts=(-d[0], -d[1], -d[2]), dims=(0, 1, 2))
        cand = torch.roll(grid_pos, **roll)
        if not cell_kernel:
            shift = torch.zeros((ncx, ncy, ncz, 3), dtype=dtype, device=dev)
            for axis in range(3):
                w = torch.div(coords[axis] + d[axis], cfg.counts[axis],
                              rounding_mode="floor").to(dtype)
                view = [1, 1, 1, 1]
                view[axis] = -1
                shift = shift + w.reshape(view) * box[axis].reshape(1, 1, 1, 3)
            cand = cand + shift[..., None]
        cand = cand.reshape(g, 3, C)
        cpar = torch.roll(grid_par, **roll).reshape(g, 3, C)
        csub = torch.roll(grid_sub, **roll).reshape(g, C)
        cids = torch.roll(grid_ids, **roll).reshape(g, C)

        delta0 = xi - cand[:, :, None, :]               # (g, 3, C, C)
        dx, dy, dz = delta0[:, 0], delta0[:, 1], delta0[:, 2]
        if cell_kernel:
            dx, dy, dz = _min_image(dx, dy, dz, box)
        # ((dx*dx + dy*dy) + dz*dz), each op rounded: the kernels' order
        r2 = dx * dx + dy * dy + dz * dz                # (g, C, C)
        mask = r2 < cutoff2
        if d == (0, 0, 0):
            mask = mask & ~eye
        excluded = torch.any(excl == cids[:, None, None, :], dim=1)
        if cell_kernel:
            real = (slot_ids[:, :, None] < n_real) & (cids[:, None, :] < n_real)
            xmask = real & excluded
            mask = mask & real
        mask = mask & ~excluded

        r2s = torch.where(mask, r2, torch.ones((), dtype=dtype, device=dev))
        rinv = torch.rsqrt(r2s)
        r = r2s * rinv
        qq = qi * (cpar[:, 0] * sqrt_ke)[:, None, :]
        sig = sgi + cpar[:, 1][:, None, :]
        eps = epi * cpar[:, 2][:, None, :]
        sig2 = (sig * rinv) ** 2
        sig6 = sig2 * sig2 * sig2
        if cfg.use_switch:
            width = cfg.cutoff - cfg.switch_distance
            u = torch.clamp((r - cfg.switch_distance) / width, 0.0, 1.0)
            sw_val = 1 + u * u * u * (-10 + u * (15 - u * 6))
            sw_der = u * u * (-30 + u * (60 - u * 30)) / width
        else:
            sw_val, sw_der = 1.0, 0.0
        dedr_vdw = sw_val * eps * (12.0 * sig6 - 6.0) * sig6 * rinv * rinv
        e_vdw = eps * (sig6 - 1.0) * sig6
        if cfg.mode == MODE_EWALD:
            ar = cfg.ewald_alpha * r
            erfc_ar, gauss = _erfc_gauss_hastings(ar)
            e_coul = qq * rinv * erfc_ar
            dedr_coul = qq * rinv * rinv * rinv * (
                erfc_ar + (2.0 / SQRT_PI) * ar * gauss)
        else:
            e_coul = qq * (rinv + cfg.krf * r2s - cfg.crf)
            dedr_coul = qq * (rinv - 2.0 * cfg.krf * r2s) * rinv * rinv
        if cfg.use_switch:
            dedr_vdw = dedr_vdw - e_vdw * sw_der * rinv
            e_vdw = e_vdw * sw_val
        sj = csub[:, None, :]
        lam_cp = lam_c_nn[si, sj]
        factor = torch.where(mask, lam_v_nn[si, sj] * dedr_vdw
                             + lam_cp * dedr_coul, zero)
        fx, fy, fz = factor * dx, factor * dy, factor * dz
        e_coul = torch.where(mask, e_coul, zero)
        if fuse_corrections:
            # Ewald exclusion corrections (pallas_direct.py:229-289)
            if cfg.exceptions_periodic:
                ux, uy, uz = dx, dy, dz
            else:
                ux, uy, uz = delta0[:, 0], delta0[:, 1], delta0[:, 2]
            r2x = torch.where(xmask, ux * ux + uy * uy + uz * uz,
                              torch.ones((), dtype=dtype, device=dev))
            rinvx = torch.rsqrt(r2x)
            arx = cfg.ewald_alpha * (r2x * rinvx)
            erfc_x, gauss_x = _erfc_gauss_hastings(arx)
            erf_x = 1.0 - erfc_x
            big = erf_x > 1e-6
            dedr_x = torch.where(big, qq * rinvx * rinvx * rinvx * (
                erf_x - (2.0 / SQRT_PI) * arx * gauss_x), zero)
            factor_x = torch.where(xmask, -lam_cp * dedr_x, zero)
            fx = fx + factor_x * ux
            fy = fy + factor_x * uy
            fz = fz + factor_x * uz
            e_x = torch.where(big, -qq * rinvx * erf_x,
                              -cfg.ewald_alpha * (2.0 / SQRT_PI) * qq)
            e_coul = e_coul + torch.where(xmask, e_x, zero)
        forces = forces + torch.stack([fx.sum(-1), fy.sum(-1), fz.sum(-1)],
                                      dim=1)
        if energies:
            oh_j = torch.nn.functional.one_hot(csub, nsub).to(dtype)
            for term, e in enumerate((e_coul,
                                      torch.where(mask, e_vdw, zero))):
                moments[:, term] += oh_i.transpose(1, 2) @ (0.5 * e) @ oh_j
    return forces, moments


def pair_column_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
                      lam_c_nn, lam_v_nn, box, cfg, energies, n_real):
    """Plain torch twin of ``csrc/pair_column.cu``."""
    return _pair_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
                       lam_c_nn, lam_v_nn, box, cfg, energies, n_real, False)


def pair_cell_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
                    lam_c_nn, lam_v_nn, box, cfg, energies, n_real):
    """Plain torch twin of ``csrc/pair_cell.cu``."""
    return _pair_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
                       lam_c_nn, lam_v_nn, box, cfg, energies, n_real, True)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_limits(entry, cfg):
    if (cfg.nsub > MAX_SUBSETS or cfg.emax > MAX_EXCLUSIONS
            or cfg.capacity > MAX_CAPACITY):
        raise ValueError(
            f"{entry}: the CUDA kernel takes at most {MAX_SUBSETS} "
            f"subsets, {MAX_EXCLUSIONS} exclusions per atom and "
            f"{MAX_CAPACITY} slots per cell (got {cfg.nsub}, {cfg.emax}, "
            f"{cfg.capacity})")


@functools.lru_cache(maxsize=None)
def pair_launch_shape(cfg, cell_kernel, energies):
    """How the CUDA kernel cuts a call with ``cfg`` (asked of the built
    library, ``nbs_pair_launch_shape``): blocks (``row_blocks`` per cell,
    each with its own moment panel), threads per block, the neighbour cells
    staged at a time and the dynamic shared memory of a block in bytes."""
    _check_limits("pair_launch_shape", cfg)
    out = (ctypes.c_int * 4)()
    LIBRARY.call("nbs_pair_launch_shape", cfg.capacity, cfg.nsub, cfg.emax,
                 int(bool(cell_kernel)), int(bool(energies)),
                 ctypes.addressof(out))
    row_blocks, threads, tile_cells, shared_bytes = out
    return dict(blocks=cfg.n_cells * row_blocks, row_blocks=row_blocks,
                threads=threads, tile_cells=tile_cells,
                shared_bytes=shared_bytes)


def _launch(entry, slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
            lam_c_nn, lam_v_nn, box, cfg, energies, n_real, cell_kernel):
    """Check the slot tensors, allocate the outputs and launch ``entry``."""
    dev = slot_pos.device
    if dev.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {dev}")
    _check_limits(entry, cfg)
    g, C, nsub = cfg.n_cells, cfg.capacity, cfg.nsub
    f32, i32 = torch.float32, torch.int32
    _check("slot_pos", slot_pos, (g, 3, C), f32, dev)
    _check("slot_par", slot_par, (g, 3, C), f32, dev)
    _check("slot_sub", slot_sub, (g, C), i32, dev)
    _check("slot_ids", slot_ids, (g, C), i32, dev)
    _check("slot_excl", slot_excl, (g, cfg.emax, C), i32, dev)
    _check("lam_c_nn", lam_c_nn, (nsub, nsub), f32, dev)
    _check("lam_v_nn", lam_v_nn, (nsub, nsub), f32, dev)
    _check("box", box, (3, 3), f32, dev)
    forces = torch.empty((g, 3, C), dtype=f32, device=dev)
    moments = None
    if energies:
        blocks = pair_launch_shape(cfg, cell_kernel, True)["blocks"]
        moments = torch.empty((blocks, 2, nsub, nsub), dtype=f32, device=dev)
    ncx, ncy, ncz = cfg.counts
    LIBRARY.call(
        entry, slot_pos.data_ptr(), slot_par.data_ptr(),
        slot_sub.data_ptr(), slot_ids.data_ptr(), slot_excl.data_ptr(),
        lam_c_nn.data_ptr(), lam_v_nn.data_ptr(), box.data_ptr(),
        forces.data_ptr(), None if moments is None else moments.data_ptr(),
        ncx, ncy, ncz, C, nsub, cfg.emax, cfg.mode, int(cfg.use_switch),
        int(n_real), *([int(cfg.exceptions_periodic)] if cell_kernel else []),
        cfg.cutoff, cfg.cutoff * cfg.cutoff, cfg.switch_distance, cfg.krf,
        cfg.crf, cfg.ewald_alpha,
        math.sqrt(ONE_4PI_EPS0), int(bool(energies)),
        torch.cuda.current_stream(dev).cuda_stream)
    return forces, moments


def pair_column(slot_pos, slot_par, slot_sub, slot_ids, slot_excl, lam_c_nn,
                lam_v_nn, box, cfg, energies, n_real):
    """Pair forces (n_cells, 3, C) and moment panels (n_panels, 2, nsub,
    nsub) or None.  Slots whose atom index is ``n_real`` or more are pads,
    which the caller has moved beyond the cutoff of every slot.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if slot_pos.device.type == "cpu":
        return pair_column_plain(slot_pos, slot_par, slot_sub, slot_ids,
                                 slot_excl, lam_c_nn, lam_v_nn, box, cfg,
                                 energies, n_real)
    out = _launch("nbs_pair_column", slot_pos, slot_par, slot_sub, slot_ids,
                  slot_excl, lam_c_nn, lam_v_nn, box, cfg, energies, n_real,
                  False)
    LAUNCHES["pair_column_energies" if energies else "pair_column"] += 1
    return out


def pair_cell(slot_pos, slot_par, slot_sub, slot_ids, slot_excl, lam_c_nn,
              lam_v_nn, box, cfg, energies, n_real):
    """Minimum-image pair forces with the Ewald exclusion corrections fused
    in: (n_cells, 3, C) and moment panels (n_panels, 2, nsub, nsub) or
    None.  ``slot_pos`` holds raw positions; slots whose atom index is
    ``n_real`` or more are pads.  CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    if slot_pos.device.type == "cpu":
        return pair_cell_plain(slot_pos, slot_par, slot_sub, slot_ids,
                               slot_excl, lam_c_nn, lam_v_nn, box, cfg,
                               energies, n_real)
    out = _launch("nbs_pair_cell", slot_pos, slot_par, slot_sub, slot_ids,
                  slot_excl, lam_c_nn, lam_v_nn, box, cfg, energies, n_real,
                  True)
    LAUNCHES["pair_cell_energies" if energies else "pair_cell"] += 1
    return out
