"""The rigid-water tail of a force-only MD step: one CUDA kernel
(``csrc/water_tail.cu``) and its plain twin.

On the rigid-water box every inner step of ``fastpath.make_md_step`` ends
with the same per-molecule work between the slot forces and the next
state: the slot->atom force unsort of the fused engine (``ops/fused.py``),
the water-triangle Ewald exclusion corrections
(``ops/bonded.exclusion_corrections_rows``, forces only), the leapfrog
kick and drift and SETTLE's positions and RATTLE's velocities
(``runtime/constraints.SettleConstrainer``).  The plain twin runs exactly
that sequence of PyTorch operations, about 335 kernels a step on the card;
the kernel does it in one launch, one thread per molecule (the source's
note says what bounds it and how it is laid out).  The kernel rounds every
operation as the twin does, in the twin's order; its erf, exp, sqrt and
rsqrt are CUDA's, as PyTorch's are, and only its three-term sums and cross
products may differ from PyTorch's in their order or contraction, a few
ulps of the new positions (``tests/test_torch_gpu_water_tail.py``).  No
atomics: the kernel repeats to the bit, so a replayed CUDA graph equals its
eager body.

:func:`uses_water_tail` says which steps take it: those where the fused
engine hands out its slot forces (``config["slot_forces"]``), float32 PME
on the column kernel (water-triangle exclusions, no 1-4 exceptions), SETTLE as
the constrainer (rigid triangles on contiguous triples cover every
particle), no harmonic bonds, not mixed precision.  Everything else keeps
the engine's atom forces and ``make_integrator``'s step, as the tail's
twin does.  The wrapper launches the kernel for CUDA tensors and runs the
twin only for CPU tensors; ``LAUNCHES`` counts the launches.
"""

import numpy as np
import torch

from ..ops import bonded, fused
from ..ops.cuda_direct import _check
from ..utils.constants import COUL, ONE_4PI_EPS0, SQRT_PI, VDW
from .constraints import SettleConstrainer
from .kernels import LIBRARY

# launches of the CUDA kernel
LAUNCHES = {"water_tail": 0}


def uses_water_tail(cfg, constrainer, *, dtype, mixed_precision, bonds):
    """Whether the force-only steps of the fused engine of config ``cfg``
    (``make_fused_engine(..., energies=False)``'s) with ``constrainer``
    (``make_integrator``'s ``integrate.constrainer``) end in the tail: the
    engine hands out its slot forces (``cfg["slot_forces"]``: PME on the
    column kernel with its water-triangle exclusion rows and no 1-4
    exceptions), float32 positions (not ``mixed_precision``), SETTLE and
    no harmonic ``bonds``."""
    return (cfg["slot_forces"] and dtype == torch.float32
            and not mixed_precision
            and (bonds is None or len(bonds) == 0)
            and isinstance(constrainer, SettleConstrainer))


def water_tail_plain(slot_f, pos, vel, state, lam, *, integrate, alpha,
                     num_slices):
    """The plain twin: the slot->atom unsort of ``slot_f`` (n_cells, 3, C)
    through ``state["inv_slots"]``, the exclusion rows' forces at ``pos``
    (``state``'s charges and pair slices, ``lam`` (S, 2) the slice
    lambdas), then ``integrate(pos, vel, forces)``; returns (positions,
    velocities)."""
    forces = fused.unsort(slot_f, state["inv_slots"])
    _, f_x = bonded.exclusion_corrections_rows(
        pos, state["charge"], state["sig_half"], state["eps2"],
        state["pair_slices"], lam[:, COUL], lam[:, VDW], alpha=alpha,
        ljpme=False, dispersion_alpha=0.0, num_slices=num_slices)
    return integrate(pos, vel, forces + f_x)


def water_tail(slot_f, pos, vel, inv_slots, charge, pair_slices, lam,
               inv_mass, settle, *, alpha, dt):
    """Launch ``csrc/water_tail.cu`` on CUDA tensors: (positions,
    velocities) after the step, new tensors.  ``inv_mass`` (N,) and
    ``settle`` (M, 14) are the constants of :func:`settle_constants`."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"water_tail: unsupported device {dev}")
    f32, i64 = torch.float32, torch.int64
    n = pos.shape[0]
    m = n // 3
    if n != 3 * m or m == 0:
        raise ValueError(f"water_tail: {n} atoms are not whole waters")
    _check("slot_f", slot_f, slot_f.shape, f32, dev)
    if slot_f.dim() != 3 or slot_f.shape[1] != 3:
        raise ValueError(f"slot_f has shape {tuple(slot_f.shape)}, "
                         "expected (n_cells, 3, capacity)")
    _check("pos", pos, (n, 3), f32, dev)
    _check("vel", vel, (n, 3), f32, dev)
    _check("inv_slots", inv_slots, (n,), i64, dev)
    _check("charge", charge, (n,), f32, dev)
    _check("pair_slices", pair_slices, (m, 3), i64, dev)
    _check("lam", lam, (lam.shape[0], 2), f32, dev)
    _check("inv_mass", inv_mass, (n,), f32, dev)
    _check("settle", settle, (m, 14), f32, dev)
    pos_out = torch.empty((n, 3), dtype=f32, device=dev)
    vel_out = torch.empty((n, 3), dtype=f32, device=dev)
    one = np.float32(1.0)
    LIBRARY.call(
        "nbs_water_tail", slot_f.data_ptr(), inv_slots.data_ptr(),
        pos.data_ptr(), vel.data_ptr(), charge.data_ptr(),
        pair_slices.data_ptr(), lam.data_ptr(), inv_mass.data_ptr(),
        settle.data_ptr(), pos_out.data_ptr(), vel_out.data_ptr(), m,
        slot_f.shape[2], alpha, ONE_4PI_EPS0,
        float(one / np.float32(SQRT_PI)), dt, float(one / np.float32(dt)),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["water_tail"] += 1
    return pos_out, vel_out


def settle_constants(settle, like):
    """(inverse masses (N,), (M, 14) ra, rb, rc, wa, wb and the RATTLE
    coupling S row-major) of the SettleConstrainer ``settle``, in the
    dtype and on the device of ``like``: the values its projections use."""
    c = settle.consts(like)
    m = c["ra"].shape[0]
    inv_mass = c["inv_m"][..., 0].T.reshape(-1).contiguous()
    packed = torch.cat([c["ra"], c["rb"], c["rc"], c["wa"], c["wb"],
                        c["s"].reshape(9, m).T], dim=1).contiguous()
    return inv_mass, packed


def make_water_tail(plan, dt, integrate):
    """tail(slot_f, pos, vel, state, lam) -> (positions, velocities): the
    step of ``integrate`` (``fastpath.make_integrator``, SETTLE) from the
    fused engine's slot forces ``slot_f`` (``apply(..., slot_forces=True)``)
    at ``pos``, ``state`` the engine's slot state and ``lam`` its (S, 2)
    slice lambdas.  CUDA tensors launch the kernel, CPU tensors take the
    twin; ``tail.plain`` is the twin on any device."""
    settle = integrate.constrainer
    consts = {}

    def plain(slot_f, pos, vel, state, lam):
        return water_tail_plain(slot_f, pos, vel, state, lam,
                                integrate=integrate, alpha=plan.ewald_alpha,
                                num_slices=plan.num_slices)

    def tail(slot_f, pos, vel, state, lam):
        if pos.device.type == "cpu":
            return plain(slot_f, pos, vel, state, lam)
        if pos.device not in consts:
            # made on the first (eager) window, before any capture
            consts[pos.device] = settle_constants(settle, pos)
        # (the brick-window pipeline's slot forces, and a caller's state,
        # may come strided)
        return water_tail(slot_f.contiguous(), pos.contiguous(),
                          vel.contiguous(), state["inv_slots"],
                          state["charge"], state["pair_slices"], lam,
                          *consts[pos.device], alpha=plan.ewald_alpha, dt=dt)

    tail.plain = plain
    return tail
