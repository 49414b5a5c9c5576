#!/usr/bin/env python3
"""Where the time of the port's MD step goes, on one NVIDIA GPU.

    python3 profile_md.py

Builds the benchmark system of chip_smoke.py (23,289 atoms, PME, SETTLE,
2 fs) from extras/bench_state_rigid.npz, warms make_md_step up with one
200-step chunk, then:

1. times five unprofiled 200-step chunks (torch.cuda.synchronize() around
   each) and prints the median and range of ms/step;
2. runs one 40-step ``run()`` (ten slot rebuilds, one final evaluation
   with energies) under torch.profiler and prints, per step: the device
   busy time (union of the device activity intervals), the number of
   kernel launches, the profiled wall time and the device's idle share,
   then the device time of each kernel name, largest first.

The timing lines name the card and its power limit as nvidia-smi reports
them.
"""

import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

from chip_smoke import (CHUNK_STEPS, DT_PS, N_MOLECULES, STATE_FILE,
                        build_system, max_cell_occupancy)

TIMED_CHUNKS = 5
PROFILED_STEPS = 40


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_md.py: no CUDA device", file=sys.stderr)
        return 2
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import neighbors, plan as plan_mod
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    system, force, box_len, constraints = build_system(nbt)
    plan = plan_mod.build_plan(force, system)
    n = plan.num_particles
    blob = np.load(STATE_FILE)
    pos_np = np.asarray(blob["positions"], dtype=np.float64)
    counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n,
                                        target_skin=DEFAULT_SKIN)[0]
    occ = max_cell_occupancy(pos_np, plan.box0, counts)
    # a wider margin than chip_smoke.py's, as no capacity retry runs here
    capacity = max(8, int(np.ceil((occ + 16) / 4) * 4))
    masses = np.tile([15.999, 1.008, 1.008], N_MOLECULES)
    run = make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                       cell_capacity=capacity, constraints=constraints)
    data = engine_mod.plan_data(plan, device=dev, dtype=f32)
    box = torch.as_tensor(np.diag([box_len] * 3), device=dev).to(f32)
    gvals = torch.ones(2, device=dev, dtype=f32)
    p = torch.as_tensor(pos_np, device=dev).to(f32)
    v = torch.as_tensor(blob["velocities"], device=dev).to(f32)
    print(f"md: {n} atoms, config {run.config}")

    p, v, _ = run(p, v, box, gvals, data, CHUNK_STEPS)       # warm-up
    ms = []
    for _ in range(TIMED_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, v, _ = run(p, v, box, gvals, data, CHUNK_STEPS)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0) / CHUNK_STEPS)
    ms.sort()
    print(f"unprofiled: {float(np.median(ms)):.3f} ms/step median of "
          f"{TIMED_CHUNKS} x {CHUNK_STEPS} steps (range {ms[0]:.3f}-"
          f"{ms[-1]:.3f}) ({card})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, v, energy = run(p, v, box, gvals, data, PROFILED_STEPS)
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    if not np.isfinite(float(energy)):
        raise RuntimeError(f"profiled run: energy {float(energy)} is not "
                           "finite")
    intervals, per_name, n_kernels = [], defaultdict(float), 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        per_name[ev.name] += end - start
        if not ev.name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = busy_us(intervals) / 1000.0
    steps = PROFILED_STEPS
    print(f"profiled: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step, "
          f"{n_kernels / steps:.1f} kernel launches/step, device idle "
          f"{100.0 * (1.0 - busy_ms / wall_ms):.1f}% ({card})")
    total_us = sum(per_name.values())
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1000.0 / steps:8.4f} ms/step "
              f"{100.0 * us / total_us:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
