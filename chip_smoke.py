#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the benchmark's MD step (bench.py): 7,763 rigid 3-site
waters (23,289 atoms) in a 6.16 nm box, 3 subsets and two lambda scaling
parameters, PME (cutoff 0.9 nm, Ewald tolerance 5e-4), water-triangle
exclusions, SETTLE and leapfrog at 2 fs, from the pre-equilibrated 300 K
state in extras/bench_state_rigid.npz.  The system is built here through
the port's force/System API (bench.py itself imports the JAX package).

Phases, each printed on its own line; any failure exits non-zero before
the last line:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. the nvcc build of csrc/*.cu (sm_90a) and its time;
3. each kernel against its plain PyTorch twin on the same CUDA tensors at
   the benchmark shapes, with CUDA-event times of both;
4. one prepare + apply (energies) in float32 on the card against the same
   code on CPU tensors in float64 (the plain twins);
5. make_md_step from the benchmark state: one 200-step warm-up chunk, then
   five timed 200-step chunks (median and range of ms/step and ns/day);
   energy, guards, constraints, temperature and each kernel's launch
   count over all six.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(ROOT, "nonbondedslicing_tpu_torch")
STATE_FILE = os.path.join(ROOT, "extras", "bench_state_rigid.npz")

N_MOLECULES = 7763
DT_PS = 0.002
CHUNK_STEPS = 200
TIMED_CHUNKS = 5
D_OH, D_HH = 0.09572, 0.15139
KB = 8.31446261815324e-3          # kJ/mol/K

# tolerances (kernel vs plain twin on the card; card f32 vs CPU f64)
TOL_FORCE = 2e-5          # of max|F| + 1
TOL_ENERGY = 1e-5         # of max|E| + 1, after the f64 reduction
TOL_GRID = 2e-5           # of the spread grid's max
TOL_EVAL_ENERGY = 1e-5    # relative total energy, card f32 vs CPU f64
TOL_EVAL_FORCE = 5e-5     # of max|F|, card f32 vs CPU f64
TOL_EVAL_DERIV = 1e-5     # relative dE/dlambda
TOL_CONSTRAINT = 1e-5     # nm

KERNELS = {
    "pair_column": ("csrc/pair_column.cu",
                    "nonbondedslicing_tpu/ops/pallas_direct.py:609"),
    "pair_column_energies": ("csrc/pair_column.cu",
                             "nonbondedslicing_tpu/ops/pallas_direct.py:609"),
    "pme_spread": ("csrc/pme_spread.cu",
                   "nonbondedslicing_tpu/ops/pallas_pme.py:156"),
    "pme_interp": ("csrc/pme_interp.cu",
                   "nonbondedslicing_tpu/ops/pallas_pme.py:391"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def build_system(nbt):
    """bench.py:56-138 (rigid) through the port's API, plus dE/dlambda
    requests for both scaling parameters."""
    n_mol = N_MOLECULES
    n_atoms = 3 * n_mol
    box = float(np.cbrt(n_atoms / 100.2))
    rng = np.random.default_rng(42)
    force = nbt.SlicedNonbondedForce(3)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.PME)
    force.setCutoffDistance(0.9)
    force.setEwaldErrorTolerance(5e-4)
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    positions = np.zeros((n_atoms, 3))
    c_pairs, c_dists = [], []
    m = int(np.ceil(n_mol ** (1 / 3)))
    spacing = box / m
    qO, qH = -0.834, 0.417
    sigO, epsO = 0.3151, 0.6364
    sigH, epsH = 0.04, 0.192
    for k in range(n_mol):
        iz, r = divmod(k, m * m)
        iy, ix = divmod(r, m)
        center = (np.array([ix, iy, iz]) + 0.5) * spacing
        system.addParticle(15.999)
        system.addParticle(1.008)
        system.addParticle(1.008)
        force.addParticle(qO, sigO, epsO)
        force.addParticle(qH, sigH, epsH)
        force.addParticle(qH, sigH, epsH)
        o = 3 * k
        center = center + rng.uniform(-0.06, 0.06, 3) * spacing
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        perp = np.cross(axis, rng.normal(size=3))
        perp /= np.linalg.norm(perp)
        half = D_HH / 2
        h = np.sqrt(D_OH ** 2 - half ** 2)
        positions[o] = center
        positions[o + 1] = center + h * axis + half * perp
        positions[o + 2] = center + h * axis - half * perp
        force.addException(o, o + 1, 0, 1, 0)
        force.addException(o, o + 2, 0, 1, 0)
        force.addException(o + 1, o + 2, 0, 1, 0)
        c_pairs.append([[o, o + 1], [o, o + 2], [o + 1, o + 2]])
        c_dists.append([D_OH, D_OH, D_HH])
    for k in range(n_mol):
        subset = 0 if k < n_mol // 3 else (1 if k < 2 * n_mol // 3 else 2)
        for a in range(3):
            force.setParticleSubset(3 * k + a, subset)
    force.addGlobalParameter("lambda01", 1.0)
    force.addScalingParameter("lambda01", 0, 1, True, True)
    force.addGlobalParameter("lambda12", 1.0)
    force.addScalingParameter("lambda12", 1, 2, True, True)
    force.addEnergyParameterDerivative("lambda01")
    force.addEnergyParameterDerivative("lambda12")
    system.addForce(force)
    return system, force, box, (c_pairs, c_dists)


def max_cell_occupancy(positions, box, counts):
    frac = positions @ np.linalg.inv(box).T
    frac -= np.floor(frac)
    ci = np.minimum((frac * counts).astype(np.int64), np.asarray(counts) - 1)
    cell = (ci[:, 0] * counts[1] + ci[:, 1]) * counts[2] + ci[:, 2]
    return int(np.bincount(cell).max())


def cuda_ms(fn, reps):
    """Mean ms per call of fn over reps calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_pair(kernel_fn, plain_fn, reps):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def main():
    if not os.path.isdir(PACKAGE) or not os.path.exists(STATE_FILE):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(nonbondedslicing_tpu_torch/ and extras/ are missing)",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import cuda_direct, cuda_pme
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import neighbors, plan as plan_mod
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    from nonbondedslicing_tpu_torch.runtime.kernels import LIBRARY
    t_start = time.time()

    # ---- 1. the card
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    print(card)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "no JAX module is loaded")

    # ---- 2. build
    t0 = time.time()
    LIBRARY.build()
    print(f"build: {LIBRARY.path.name} in {time.time() - t0:.1f} s "
          f"(nvcc {LIBRARY.build_seconds:.1f} s)")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip())

    # ---- system, plan, state
    t0 = time.time()
    system, force, box_len, constraints = build_system(nbt)
    plan = plan_mod.build_plan(force, system)
    n = plan.num_particles
    blob = np.load(STATE_FILE)
    pos_np = np.asarray(blob["positions"], dtype=np.float64)
    vel_np = np.asarray(blob["velocities"], dtype=np.float64)
    masses = np.tile([15.999, 1.008, 1.008], N_MOLECULES)
    counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n,
                                        target_skin=DEFAULT_SKIN)[0]
    occ = max_cell_occupancy(pos_np, plan.box0, counts)
    capacity = max(8, int(np.ceil((occ + 8) / 4) * 4))
    box_np = np.diag([box_len] * 3)
    print(f"system: {n} atoms, box {box_len:.4f} nm, cells {counts}, "
          f"capacity {capacity}, PME alpha {plan.ewald_alpha:.4f}, built in "
          f"{time.time() - t0:.1f} s")

    # ---- 3. kernels vs plain twins at the benchmark shapes
    prepare, apply, cfg = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity,
        target_skin=DEFAULT_SKIN, energies=True)
    pc = cfg["pair"]
    print(f"shapes: cells {pc.counts} x {pc.capacity} slots, nsub "
          f"{pc.nsub}, emax {pc.emax}, PME grid {cfg['pme_grid']}")
    f32 = torch.float32
    data = engine_mod.plan_data(plan, device=dev, dtype=f32)
    pos = torch.as_tensor(pos_np, device=dev).to(f32)
    box = torch.as_tensor(box_np, device=dev).to(f32)
    gvals = torch.ones(2, device=dev, dtype=f32)
    st = prepare(pos, box, gvals, data)
    check(int(st["overflow"]) == 0, "no cell overflow at the bench state")
    g, C = pc.n_cells, pc.capacity
    slot_pos = (torch.cat([st["pos0w"], pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    lam = slice_lambdas(plan.lam_source, gvals)
    sl_tab = torch.as_tensor(plan.slice_table, dtype=torch.int64, device=dev)
    lam_c_nn = lam[:, 0][sl_tab].contiguous()
    lam_v_nn = lam[:, 1][sl_tab].contiguous()
    results = {}
    reps = 20

    def pair_args(energies):
        return (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
                st["sexcl"], lam_c_nn, lam_v_nn, box, pc, energies)

    def slice_e(moments):
        m = moments.double().sum(0)
        return torch.stack([m[:, a, a] if a == b else m[:, a, b] + m[:, b, a]
                            for a, b in zip(*np.triu_indices(pc.nsub))])

    for name, energies in (("pair_column", False),
                           ("pair_column_energies", True)):
        f_k, m_k = cuda_direct.pair_column(*pair_args(energies))
        f_p, m_p = cuda_direct.pair_column_plain(*pair_args(energies))
        torch.cuda.synchronize()
        err = float((f_k - f_p).abs().max())
        fmax = float(f_p.abs().max())
        check(err <= TOL_FORCE * (fmax + 1.0),
              f"{name}: forces max|dF| {err:.3e} <= {TOL_FORCE} * "
              f"(max|F| {fmax:.1f} + 1)")
        if energies:
            e_k, e_p = slice_e(m_k), slice_e(m_p)
            e_err = float((e_k - e_p).abs().max())
            emax = float(e_p.abs().max())
            check(e_err <= TOL_ENERGY * (emax + 1.0),
                  f"{name}: slice energies max|dE| {e_err:.3e} <= "
                  f"{TOL_ENERGY} * (max|E| {emax:.1f} + 1)")
        ms, plain_ms = timed_pair(
            lambda: cuda_direct.pair_column(*pair_args(energies)),
            lambda: cuda_direct.pair_column_plain(*pair_args(energies)),
            reps)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    recip = recip_box_vectors(box)
    grid_shape = cfg["pme_grid"]
    spread_args = (slot_pos, st["slot_q"], st["slot_sub"], recip, grid_shape,
                   pc.nsub)
    grid_k = cuda_pme.pme_spread(*spread_args)
    grid_p = cuda_pme.pme_spread_plain(*spread_args)
    torch.cuda.synchronize()
    err = float((grid_k - grid_p).abs().max())
    gmax = float(grid_p.abs().max())
    check(err <= TOL_GRID * gmax,
          f"pme_spread: grid max|d| {err:.3e} <= {TOL_GRID} * max {gmax:.3f}")
    check(torch.equal(grid_k, cuda_pme.pme_spread(*spread_args)),
          "pme_spread: bitwise repeatable (fixed-point adds)")
    ms, plain_ms = timed_pair(lambda: cuda_pme.pme_spread(*spread_args),
                              lambda: cuda_pme.pme_spread_plain(*spread_args),
                              reps)
    results["pme_spread"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"pme_spread: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    eterm = torch.as_tensor(pme_mod.coulomb_eterm_np(
        grid_shape, cfg["pme_moduli"], plan.box0, plan.ewald_alpha),
        device=dev).to(f32)
    spec = torch.fft.rfftn(grid_k, dim=(1, 2, 3))
    lam_nn = lam[:, 0][sl_tab]
    phi = torch.fft.irfftn(
        torch.einsum("st,txyk->sxyk", lam_nn.to(spec.dtype), spec * eterm),
        s=tuple(grid_shape), dim=(1, 2, 3), norm="forward").contiguous()
    interp_args = (phi, slot_pos, st["slot_q"], st["slot_sub"], recip)
    f_k = cuda_pme.pme_interp(*interp_args)
    f_p = cuda_pme.pme_interp_plain(*interp_args)
    torch.cuda.synchronize()
    err = float((f_k - f_p).abs().max())
    fmax = float(f_p.abs().max())
    check(err <= TOL_FORCE * (fmax + 1.0),
          f"pme_interp: forces max|dF| {err:.3e} <= {TOL_FORCE} * "
          f"(max|F| {fmax:.1f} + 1)")
    ms, plain_ms = timed_pair(lambda: cuda_pme.pme_interp(*interp_args),
                              lambda: cuda_pme.pme_interp_plain(*interp_args),
                              reps)
    results["pme_interp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"pme_interp: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # ---- 4. whole evaluation: card f32 vs CPU f64 (plain twins)
    t0 = time.time()
    e_g, f_g, _ = apply(pos, box, gvals, data, st)
    torch.cuda.synchronize()
    f64 = torch.float64
    data_c = engine_mod.plan_data(plan, dtype=f64)
    pos_c = torch.as_tensor(pos_np)
    box_c = torch.as_tensor(box_np)
    gvals_c = torch.ones(2, dtype=f64)
    prep_c, apply_c, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity,
        target_skin=DEFAULT_SKIN, energies=True)
    e_c, f_c, _ = apply_c(pos_c, box_c, gvals_c, data_c,
                          prep_c(pos_c, box_c, gvals_c, data_c))
    lam_c = slice_lambdas(plan.lam_source, gvals_c)
    E_g = float(engine_mod.contract_energy(e_g.cpu(), lam_c))
    E_c = float(engine_mod.contract_energy(e_c, lam_c))
    rel_e = abs(E_g - E_c) / abs(E_c)
    f_err = float((f_g.cpu().double() - f_c).abs().max()) / float(
        f_c.abs().max())
    d_g = engine_mod.parameter_derivatives(e_g.cpu(), plan.deriv_mask)
    d_c = engine_mod.parameter_derivatives(e_c, plan.deriv_mask)
    rel_d = float(((d_g - d_c).abs() / d_c.abs().clamp(min=1.0)).max())
    print(f"evaluation: E card f32 {E_g:.6f}, CPU f64 {E_c:.6f} kJ/mol; "
          f"dE/dlambda card {d_g.tolist()}, CPU {d_c.tolist()} "
          f"({time.time() - t0:.1f} s)")
    check(math.isfinite(E_g) and rel_e <= TOL_EVAL_ENERGY,
          f"evaluation: relative energy error {rel_e:.3e} <= "
          f"{TOL_EVAL_ENERGY}")
    check(f_err <= TOL_EVAL_FORCE,
          f"evaluation: force error {f_err:.3e} of max|F| <= {TOL_EVAL_FORCE}")
    check(rel_d <= TOL_EVAL_DERIV,
          f"evaluation: relative dE/dlambda error {rel_d:.3e} <= "
          f"{TOL_EVAL_DERIV}")

    # ---- 5. MD: the main path, counted
    run_state = {"run": None, "capacity": capacity, "reuse": None}

    def run_chunk(p, v):
        """One chunk with bench.py's capacity / reuse retries."""
        while True:
            if run_state["run"] is None:
                run_state["run"] = make_md_step(
                    plan, masses, dt=DT_PS, dtype=f32,
                    cell_capacity=run_state["capacity"],
                    reuse_steps=run_state["reuse"], constraints=constraints)
                run_state["reuse"] = run_state["run"].config["reuse_steps"]
            try:
                return run_state["run"](p, v, box, gvals, data, CHUNK_STEPS)
            except nbt.OpenMMException as exc:
                if "capacity overflow" in str(exc):
                    run_state["capacity"] += 8
                elif "skin violation" in str(exc) and run_state["reuse"] > 1:
                    run_state["reuse"] = max(1, run_state["reuse"] // 2)
                else:
                    raise
                run_state["run"] = None
                print(f"md: retry after guard: {exc}")

    for key in cuda_direct.LAUNCHES:
        cuda_direct.LAUNCHES[key] = 0
    for key in cuda_pme.LAUNCHES:
        cuda_pme.LAUNCHES[key] = 0
    p = torch.as_tensor(pos_np, device=dev).to(f32)
    v = torch.as_tensor(vel_np, device=dev).to(f32)
    chunk_s = []
    for _ in range(1 + TIMED_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.time()
        p, v, energy = run_chunk(p, v)
        torch.cuda.synchronize()
        chunk_s.append(time.time() - t0)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    config = run_state["run"].config
    print(f"md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, timed "
          f"chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")

    e_md = float(energy)
    check(math.isfinite(e_md), f"md: energy {e_md:.3f} kJ/mol is finite")
    p64 = p.double().cpu().numpy().reshape(-1, 3, 3)
    c_err = 0.0
    for (a, b), d in (((0, 1), D_OH), ((0, 2), D_OH), ((1, 2), D_HH)):
        c_err = max(c_err, float(np.abs(np.linalg.norm(
            p64[:, a] - p64[:, b], axis=-1) - d).max()))
    check(c_err <= TOL_CONSTRAINT,
          f"md: max |constraint distance - target| {c_err:.3e} nm <= "
          f"{TOL_CONSTRAINT}")
    v64 = v.double().cpu().numpy()
    n_dof = 3 * n - 3 * N_MOLECULES - 3
    temp = float(np.sum(masses[:, None] * v64 * v64)) / (KB * n_dof)
    check(270.0 <= temp <= 330.0, f"md: temperature {temp:.1f} K in 300 +- 30")
    for name in KERNELS:
        check(launches[name] > 0,
              f"md: {name} launched {launches[name]} times")
    ms = sorted(1000.0 * t / CHUNK_STEPS for t in chunk_s[1:])
    ms_step = float(np.median(ms))
    ns_day = DT_PS * 1e-3 * 86400.0 / (1e-3 * ms_step)
    print(f"md: {ms_step:.3f} ms/step median of {TIMED_CHUNKS} x "
          f"{CHUNK_STEPS} steps (range {ms[0]:.3f}-{ms[-1]:.3f}), "
          f"{ns_day:.2f} ns/day at {DT_PS} ps ({n} atoms, {card})")
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source="nonbondedslicing_tpu_torch/" + KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name],
             **results[name])
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
