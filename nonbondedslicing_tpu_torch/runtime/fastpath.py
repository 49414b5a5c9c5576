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
* ``excl_span`` — on the min-image cell kernel's path, every excluded pair
  must lie within one cell width per axis (minimum image): the kernel
  corrects the excluded pairs it meets among the 27 neighbour cells
* the runtime box must equal ``plan.box0``: the cell grid sizing and the
  PME convolution kernels are built once from it

Optionally adds harmonic bonds (flexible intramolecular geometry) to the
forces of every step, with the minimum image on the bond vectors when
``bonds_periodic``.
"""

import numpy as np
import torch

from ..models.force import OpenMMException
from ..ops import engine as engine_mod
from ..ops import fused as fused_mod
from ..ops.geometry import min_image
from ..ops.params import slice_lambdas

# nm — Verlet-list style cell oversizing for MD reuse (as the JAX package)
DEFAULT_SKIN = 0.09


def _bond_forces_fn(bonds, n, periodic=False, box=None):
    """forces(pos) (n, 3) of harmonic bonds ``bonds`` (M, 4) rows (i, j, r0,
    k) with energy k/2 (r - r0)^2, or None without bonds.  Bond vectors are
    taken as they are or, with ``periodic``, as their minimum image in the
    static ``box`` (the JAX package's ``fastpath._bond_forces_fn``)."""
    if bonds is None or len(bonds) == 0:
        return None
    bonds = np.asarray(bonds, dtype=np.float64)
    host = dict(b_i=bonds[:, 0].astype(np.int64),
                b_j=bonds[:, 1].astype(np.int64), r0=bonds[:, 2],
                k=bonds[:, 3])
    if periodic:
        host["box"] = np.asarray(box, dtype=np.float64)
    cache = {}

    def bond_forces(pos):
        key = (pos.device, pos.dtype)
        if key not in cache:
            cache[key] = {name: torch.as_tensor(v, device=pos.device).to(
                pos.dtype if v.dtype.kind == "f" else torch.int64)
                for name, v in host.items()}
        c = cache[key]
        dr = pos[c["b_i"]] - pos[c["b_j"]]
        if periodic:
            dr = min_image(dr, c["box"])
        r = torch.sqrt(torch.sum(dr * dr, dim=-1))
        dedr = c["k"] * (r - c["r0"]) / torch.clamp(r, min=1e-12)
        f = -dedr[:, None] * dr
        out = torch.zeros((n, 3), dtype=pos.dtype, device=pos.device)
        return out.index_add(0, c["b_i"], f).index_add(0, c["b_j"], -f)

    return bond_forces


def make_md_step(plan, masses, dt, *, dtype=torch.float32, cell_capacity=None,
                 reuse_steps=None, constraints=None, target_skin=DEFAULT_SKIN,
                 mixed_precision=False, bonds=None, bonds_periodic=False,
                 pme_pipeline="stencil"):
    """Returns run(pos, vel, box, gvals, data, n_steps) -> (pos, vel, energy).

    Leapfrog Verlet: v += dt*F/m; x += dt*v, with constraint projections
    when ``constraints`` = (pairs, dists[, mask]) is given
    (``runtime.constraints.make_constrainer``).  ``bonds`` is an optional
    (M, 4) array-like of (i, j, r0, k) harmonic bonds added to the forces of
    every step; ``bonds_periodic`` takes their vectors as minimum images in
    the plan's box (a HarmonicBondForce that uses periodic boundary
    conditions), else as they are.  Positions, velocities, box and gvals
    may be numpy arrays
    or tensors; the run works on the device of ``data``
    (``ops.engine.plan_data``) in ``dtype`` and returns tensors there,
    ``energy`` as a float64 0-d tensor.  The energy is the nonbonded
    energy, as in the JAX package.

    ``pme_pipeline`` is ``"stencil"`` (whole-grid spread and interpolation)
    or ``"grid"`` (the brick-window pipeline), for every evaluation of the
    run; see ``ops.fused.make_fused_engine``.

    ``reuse_steps`` (K) sets how many steps share one slot rebuild; None
    picks K from the skin and the lightest mass.  Raises OpenMMException
    after the run if the cell capacity overflowed or an atom moved more than
    skin/2 between rebuilds, or, on the min-image cell kernel's path, if an
    excluded pair spans a cell width or more.
    """
    if mixed_precision:
        raise NotImplementedError(
            "make_md_step: mixed precision is not ported yet (ROADMAP A7)")
    eng = fused_mod.make_fused_engine(plan, cell_capacity=cell_capacity,
                                      target_skin=target_skin, energies=False,
                                      pme_pipeline=pme_pipeline)
    if eng is None:
        raise NotImplementedError(
            "make_md_step: systems without a cell list need the per-step "
            "rebuild path of the generic engine (ROADMAP A9)")
    prepare, apply, cfg = eng
    _, apply_full, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=cell_capacity, target_skin=target_skin,
        energies=True, pme_pipeline=pme_pipeline)
    n = plan.num_particles
    m_np = np.asarray(masses, dtype=np.float64)
    inv_m_np = np.where(m_np > 0, 1.0 / np.maximum(m_np, 1e-300), 0.0)[:, None]
    box0 = np.asarray(plan.box0, dtype=np.float64)
    bond_forces = _bond_forces_fn(bonds, n, periodic=bonds_periodic,
                                  box=box0)
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
        span = torch.zeros((), dtype=torch.float64, device=dev)
        n_outer, rem = divmod(int(n_steps), K)
        for k in [K] * n_outer + ([rem] if rem else []):
            state = prepare(pos, box, gvals, data)
            for _ in range(k):
                _, forces, aux = apply(pos, box, gvals, data, state)
                if bond_forces is not None:
                    forces = forces + bond_forces(pos)
                pos, vel = integrate(pos, vel, forces)
                dmax = torch.maximum(dmax, aux["maxdisp2"])
            ov = torch.maximum(ov, state["overflow"])
            if "excl_span" in aux:
                span = torch.maximum(span, aux["excl_span"])
        # energies variant for the reported energy
        state = prepare(pos, box, gvals, data)
        slice_e, _, aux = apply_full(pos, box, gvals, data, state)
        ov = torch.maximum(ov, state["overflow"])
        if "excl_span" in aux:
            span = torch.maximum(span, aux["excl_span"])
        energy = engine_mod.contract_energy(
            slice_e, slice_lambdas(plan.lam_source, gvals))
        # one device->host transfer for the guards
        ov_cell, dmax_h, span_h = torch.stack(
            [ov.to(torch.float64), dmax.to(torch.float64), span]).tolist()
        if ov_cell > 0:
            raise OpenMMException(
                f"Cell-list capacity overflow ({int(ov_cell)} atoms dropped): "
                "the density fluctuation exceeded the static cell capacity. "
                "Rebuild with a larger cell_capacity.")
        if span_h >= 1.0:
            raise OpenMMException(
                "SlicedNonbondedForce: an excluded pair spans more than one "
                f"neighbor-list cell ({span_h:.3f} cell widths along an "
                "axis); the fused engine corrects only the excluded pairs of "
                "neighbouring cells, so excluded pairs must be bonded-range.")
        if dmax_h > disp_limit2:
            raise OpenMMException(
                "Neighbor-list skin violation: an atom moved "
                f"{dmax_h ** 0.5:.4f} nm between rebuilds "
                f"(> skin/2 = {0.5 * skin:.4f} nm). Reduce reuse_steps.")
        return pos, vel, energy

    run.config = dict(reuse_steps=K, skin=skin, mixed_precision=False,
                      pme_pipeline=pme_pipeline,
                      **{k: v for k, v in cfg.items()
                         if k in ("counts", "capacity", "pme_grid",
                                  "dispersion_grid")})
    return run
