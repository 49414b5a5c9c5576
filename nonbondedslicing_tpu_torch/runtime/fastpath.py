"""Fused MD step loop for production throughput.

Leapfrog-Verlet steps with the full sliced nonbonded evaluation, over the
fused engine (``ops/fused.py``).  The neighbour/slot state from ``prepare``
is rebuilt every ``reuse_steps`` (K) steps and reused by the steps between
under a skin guard, the analog of Verlet-list reuse.  Inner steps run the
force-only engine; each ``run()`` ends with one evaluation with energies.
Safety is monitored on the device and checked on the host once per
``run()``, after the steps:

* ``overflow`` — atoms beyond the static cell capacity (never silently
  dropped; raise and rebuild with a larger capacity)
* ``maxdisp2`` — max squared displacement since the last rebuild; beyond
  (skin/2)^2 the frozen cell assignment may miss pairs
* the runtime box must equal ``plan.box0``: the cell grid sizing and the
  PME convolution kernel are built once from it
"""

import numpy as np
import torch

from ..models.force import OpenMMException
from ..ops import engine as engine_mod
from ..ops import fused as fused_mod
from ..ops.params import slice_lambdas

# nm — Verlet-list style cell oversizing for MD reuse (as the JAX package)
DEFAULT_SKIN = 0.09


def make_md_step(plan, masses, dt, *, dtype=torch.float32, cell_capacity=None,
                 reuse_steps=None, constraints=None, target_skin=DEFAULT_SKIN,
                 mixed_precision=False, bonds=None):
    """Returns run(pos, vel, box, gvals, data, n_steps) -> (pos, vel, energy).

    Leapfrog Verlet: v += dt*F/m; x += dt*v, with SETTLE/RATTLE when
    ``constraints`` = (pairs, dists) describes rigid waters.  Positions,
    velocities, box and gvals may be numpy arrays or tensors; the run works
    on the device of ``data`` (``ops.engine.data_from_numpy``) in ``dtype``
    and returns tensors there, ``energy`` as a float64 0-d tensor.

    ``reuse_steps`` (K) sets how many steps share one slot rebuild; None
    picks K from the skin and the lightest mass.  Raises OpenMMException
    after the run if the cell capacity overflowed or an atom moved more than
    skin/2 between rebuilds.
    """
    if mixed_precision:
        raise NotImplementedError(
            "make_md_step: mixed precision is not ported yet (ROADMAP A7)")
    if bonds is not None and len(bonds):
        raise NotImplementedError(
            "make_md_step: harmonic bonds are not ported yet (ROADMAP A11)")
    eng = fused_mod.make_fused_engine(plan, cell_capacity=cell_capacity,
                                      target_skin=target_skin, energies=False)
    if eng is None:
        raise NotImplementedError(
            "make_md_step: systems without a cell list need the per-step "
            "rebuild path of the generic engine (ROADMAP A9)")
    prepare, apply, cfg = eng
    _, apply_full, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=cell_capacity,
        target_skin=target_skin, energies=True)
    n = plan.num_particles
    m_np = np.asarray(masses, dtype=np.float64)
    inv_m_np = np.where(m_np > 0, 1.0 / np.maximum(m_np, 1e-300), 0.0)[:, None]
    box0 = np.asarray(plan.box0, dtype=np.float64)
    if constraints is not None:
        from .constraints import make_constrainer
        c_mask = constraints[2] if len(constraints) > 2 else None
        proj_x, proj_v = make_constrainer(constraints[0], constraints[1],
                                          masses, n, mask=c_mask)
    else:
        proj_x = proj_v = None

    skin = cfg["skin"]
    if reuse_steps is None:
        # steps until the fastest plausible atom covers half the skin: 7
        # nm/ps for 1 amu hydrogens at 300 K, thermal speeds scale as
        # 1/sqrt(m) (the JAX package's calibration on the 23k rigid-water
        # benchmark); the skin guard still checks every run
        m_min = float(np.min(m_np[m_np > 0])) if np.any(m_np > 0) else 1.0
        v_ref = 7.0 / np.sqrt(max(m_min, 1.008) / 1.008)
        reuse_steps = int(0.5 * skin / (dt * v_ref))
    K = min(25, max(1, int(reuse_steps)))
    disp_limit2 = (0.5 * skin) ** 2 if K > 1 else np.inf

    def run(pos, vel, box, gvals, data, n_steps):
        dev = data["base_params"].device
        box = torch.as_tensor(box, device=dev).to(dtype)
        # the convolution kernel and static cell grid are box0-only
        # (tolerance covers the f32 cast of an f64 default box)
        if not np.allclose(box.detach().to("cpu", torch.float64).numpy(),
                           box0, rtol=0.0,
                           atol=1e-6 * float(np.max(np.abs(box0)))):
            raise OpenMMException(
                "make_md_step: the runtime box must equal the plan's default "
                "box (the cell grid and PME convolution kernel are "
                "box-static); reinitialize for a different box.")
        pos = torch.as_tensor(pos, device=dev).to(dtype)
        vel = torch.as_tensor(vel, device=dev).to(dtype)
        gvals = torch.as_tensor(gvals, device=dev).to(dtype)
        inv_m = torch.as_tensor(inv_m_np, device=dev).to(dtype)

        def integrate(pos, vel, forces):
            vel = vel + dt * forces * inv_m
            if proj_x is None:
                return pos + dt * vel, vel
            pos_new = proj_x(pos, pos + dt * vel)
            vel = (pos_new - pos) / dt
            return pos_new, proj_v(pos_new, vel)

        ov = torch.zeros((), dtype=torch.int64, device=dev)
        dmax = torch.zeros((), dtype=dtype, device=dev)
        n_outer, rem = divmod(int(n_steps), K)
        for k in [K] * n_outer + ([rem] if rem else []):
            state = prepare(pos, box, gvals, data)
            for _ in range(k):
                _, forces, aux = apply(pos, box, gvals, data, state)
                pos, vel = integrate(pos, vel, forces)
                dmax = torch.maximum(dmax, aux["maxdisp2"])
            ov = torch.maximum(ov, state["overflow"])
        # energies variant for the reported energy
        state = prepare(pos, box, gvals, data)
        slice_e, _, _ = apply_full(pos, box, gvals, data, state)
        ov = torch.maximum(ov, state["overflow"])
        energy = engine_mod.contract_energy(
            slice_e, slice_lambdas(plan.lam_source, gvals))
        # one device->host transfer for both guards
        ov_cell, dmax_h = torch.stack([ov.to(torch.float64),
                                       dmax.to(torch.float64)]).tolist()
        if ov_cell > 0:
            raise OpenMMException(
                f"Cell-list capacity overflow ({int(ov_cell)} atoms dropped): "
                "the density fluctuation exceeded the static cell capacity. "
                "Rebuild with a larger cell_capacity.")
        if dmax_h > disp_limit2:
            raise OpenMMException(
                "Neighbor-list skin violation: an atom moved "
                f"{dmax_h ** 0.5:.4f} nm between rebuilds "
                f"(> skin/2 = {0.5 * skin:.4f} nm). Reduce reuse_steps.")
        return pos, vel, energy

    run.config = dict(reuse_steps=K, skin=skin, mixed_precision=False,
                      **{k: v for k, v in cfg.items()
                         if k in ("counts", "capacity", "pme_grid")})
    return run
