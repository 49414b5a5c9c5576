"""Direct-space pair kernel over the cell grid (CUDA) and its plain twin.

Port of ``nonbondedslicing_tpu/ops/pallas_direct.py::make_pallas_column_kernel``
with the physics of ``_make_pair_block``: LJ (sigma/2 + sigma/2,
2 sqrt(eps) * 2 sqrt(eps)), Coulomb by reaction field or Ewald erfc (the
Abramowitz-Stegun 7.1.26 polynomial, max abs error ~1.5e-7, as the
reference's GPU kernels), the quintic switch, and lambda per pair from the
subsets of the two atoms.

Slot layout (n_cells = ncx*ncy*ncz cells in x-major order, C slots each):

* ``slot_pos`` (n_cells, 3, C) float: positions in the image of the cell
  assignment, pad slots moved far away (``ops/fused.py`` padfix);
* ``slot_par`` (n_cells, 3, C) float: charge, sigma/2, 2*sqrt(epsilon);
* ``slot_sub``, ``slot_ids`` (n_cells, C) int32: subset and atom index;
* ``slot_excl`` (n_cells, emax, C) int32: excluded partners, -1 padded.

Outputs: forces (n_cells, 3, C) and, with ``energies``, per-cell moments
(n_cells, 2, nsub, nsub) [Coulomb, vdW]: the unscaled pair energies summed
over (home subset a, partner subset b) with weight 1/2 (every pair is
visited from both sides).  Slice energies are then m[a, a] on the diagonal
and m[a, b] + m[b, a] off it.

``pair_column`` launches ``csrc/pair_column.cu`` for CUDA tensors and runs
``pair_column_plain`` only for CPU tensors.
"""

import math
from dataclasses import dataclass

import torch

from ..runtime.kernels import LIBRARY
from ..utils.constants import ONE_4PI_EPS0, SQRT_PI

MODE_REACTION_FIELD = 0
MODE_EWALD = 1
# limits of the CUDA kernel (csrc/pair_column.cu: register accumulators and
# one thread per slot)
MAX_SUBSETS = 8
MAX_EXCLUSIONS = 16
MAX_CAPACITY = 1024

# launches of the CUDA kernel by variant (force-only, energies)
LAUNCHES = {"pair_column": 0, "pair_column_energies": 0}


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
    """The 27 neighbour-cell offsets in the kernel's order (self is 13)."""
    return [(o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1) for o in range(27)]


def pair_column_plain(slot_pos, slot_par, slot_sub, slot_ids, slot_excl,
                      lam_c_nn, lam_v_nn, box, cfg, energies):
    """Plain torch twin of the CUDA kernel, in the slot tensors' dtype."""
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
    forces = torch.zeros_like(slot_pos)
    moments = (torch.zeros((g, 2, nsub, nsub), dtype=dtype, device=dev)
               if energies else None)
    # compared in the slot dtype: the kernel gets the same value rounded
    # once to float, so pairs at the cutoff fall on the same side
    cutoff2 = cfg.cutoff * cfg.cutoff
    for d in _neighbor_offsets():
        # cell c receives cell (c + d) mod nc, whose true image sits at
        # floor((c + d) / nc) box vectors
        shift = torch.zeros((ncx, ncy, ncz, 3), dtype=dtype, device=dev)
        for axis in range(3):
            w = torch.div(coords[axis] + d[axis], cfg.counts[axis],
                          rounding_mode="floor").to(dtype)
            view = [1, 1, 1, 1]
            view[axis] = -1
            shift = shift + w.reshape(view) * box[axis].reshape(1, 1, 1, 3)
        roll = dict(shifts=(-d[0], -d[1], -d[2]), dims=(0, 1, 2))
        cand = (torch.roll(grid_pos, **roll) + shift[..., None]).reshape(g, 3, C)
        cpar = torch.roll(grid_par, **roll).reshape(g, 3, C)
        csub = torch.roll(grid_sub, **roll).reshape(g, C)
        cids = torch.roll(grid_ids, **roll).reshape(g, C)

        delta = xi - cand[:, :, None, :]                # (g, 3, C, C)
        # ((dx*dx + dy*dy) + dz*dz), each op rounded: the kernel's order
        dx, dy, dz = delta[:, 0], delta[:, 1], delta[:, 2]
        r2 = dx * dx + dy * dy + dz * dz                # (g, C, C)
        mask = r2 < cutoff2
        if d == (0, 0, 0):
            mask = mask & ~eye
        excluded = torch.any(excl == cids[:, None, None, :], dim=1)
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
        factor = (lam_v_nn[si, sj] * dedr_vdw + lam_c_nn[si, sj] * dedr_coul)
        factor = torch.where(mask, factor, torch.zeros((), dtype=dtype,
                                                       device=dev))
        forces = forces + torch.sum(factor[:, None] * delta, dim=-1)
        if energies:
            oh_j = torch.nn.functional.one_hot(csub, nsub).to(dtype)
            zero = torch.zeros((), dtype=dtype, device=dev)
            for term, e in enumerate((e_coul, e_vdw)):
                e = 0.5 * torch.where(mask, e, zero)
                moments[:, term] += oh_i.transpose(1, 2) @ e @ oh_j
    return forces, moments


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


def pair_column(slot_pos, slot_par, slot_sub, slot_ids, slot_excl, lam_c_nn,
                lam_v_nn, box, cfg, energies):
    """Pair forces (n_cells, 3, C) and moments (n_cells, 2, nsub, nsub) or
    None.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    dev = slot_pos.device
    if dev.type == "cpu":
        return pair_column_plain(slot_pos, slot_par, slot_sub, slot_ids,
                                 slot_excl, lam_c_nn, lam_v_nn, box, cfg,
                                 energies)
    if dev.type != "cuda":
        raise ValueError(f"pair_column: unsupported device {dev}")
    g, C, nsub = cfg.n_cells, cfg.capacity, cfg.nsub
    if nsub > MAX_SUBSETS or cfg.emax > MAX_EXCLUSIONS or C > MAX_CAPACITY:
        raise ValueError(
            f"pair_column: the CUDA kernel takes at most {MAX_SUBSETS} "
            f"subsets, {MAX_EXCLUSIONS} exclusions per atom and "
            f"{MAX_CAPACITY} slots per cell (got {nsub}, {cfg.emax}, {C})")
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
    moments = (torch.empty((g, 2, nsub, nsub), dtype=f32, device=dev)
               if energies else None)
    ncx, ncy, ncz = cfg.counts
    LIBRARY.call(
        "nbs_pair_column", slot_pos.data_ptr(), slot_par.data_ptr(),
        slot_sub.data_ptr(), slot_ids.data_ptr(), slot_excl.data_ptr(),
        lam_c_nn.data_ptr(), lam_v_nn.data_ptr(), box.data_ptr(),
        forces.data_ptr(), None if moments is None else moments.data_ptr(),
        ncx, ncy, ncz, C, nsub, cfg.emax, cfg.mode, int(cfg.use_switch),
        cfg.cutoff, cfg.cutoff * cfg.cutoff, cfg.switch_distance, cfg.krf,
        cfg.crf, cfg.ewald_alpha,
        math.sqrt(ONE_4PI_EPS0), int(bool(energies)),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["pair_column_energies" if energies else "pair_column"] += 1
    return forces, moments
