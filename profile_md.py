#!/usr/bin/env python3
"""Where the time of the port's MD step goes, on one NVIDIA GPU.

    python3 profile_md.py [--solute | --constrained] [--pipeline grid]
                          [--method LJPME] [--precision mixed]

Builds the benchmark system of port_systems.py (23,289 atoms, PME, SETTLE,
2 fs) from extras/bench_state_rigid.npz, or with ``--solute`` its solute
system (the 12-site chain in that box, harmonic bonds, the gather
constrainer for the waters, the min-image cell pair kernel), or with
``--constrained`` that system with the chain's 1-2 pairs as constraints
(one 11-wide cluster, the water triangles padded to it, the CGLS solve)
and only its 1-3 pairs as bonds, under PME or
with ``--method LJPME`` under LJPME, with the default PME pipeline or with
``--pipeline grid`` the brick-window one, in single precision or with
``--precision mixed`` in make_md_step's mixed precision (float64
positions).  On the card make_md_step replays one CUDA graph per K-step
window; the warm-up (one 200-step chunk and one run of the profiled
length) captures the graphs of both window lengths.  Then:

1. times five unprofiled 200-step chunks (torch.cuda.synchronize() around
   each) and prints the median and range of ms/step;
2. runs one 40-step ``run()`` (ten slot rebuilds, one final evaluation
   with energies) under torch.profiler and prints, per step: the device
   busy time (union of the device activity intervals), the number of
   kernels the device ran (copies and fills not counted, nor the kernels
   that run a CUDA graph's copy and fill nodes), the host's launch calls
   (``cudaLaunchKernel`` and ``cudaGraphLaunch``, each by name), the
   profiled wall time and the device's idle share, then the device time
   and the launches per step of each kernel name, largest time first.

The timing lines name the card and its power limit as nvidia-smi reports
them.
"""

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

from port_systems import (DT_PS, N_MOLECULES, STATE_FILE, WATER_MASSES,
                          build_solute_system, build_system,
                          chain_constraints, max_cell_occupancy,
                          solute_velocities)

CHUNK_STEPS = 200
TIMED_CHUNKS = 5
PROFILED_STEPS = 40
# the host's calls that put work on the card: one kernel, or one graph
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaGraphLaunch")


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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--solute", action="store_true",
                        help="profile the solute path (the chain in water)")
    parser.add_argument("--constrained", action="store_true",
                        help="the solute path with the chain's bonds as "
                             "constraints")
    parser.add_argument("--pipeline", choices=("stencil", "grid"),
                        default="stencil",
                        help="the PME pipeline (make_md_step's pme_pipeline)")
    parser.add_argument("--method", choices=("PME", "LJPME"), default="PME",
                        help="the nonbonded method of the system")
    parser.add_argument("--precision", choices=("single", "mixed"),
                        default="single",
                        help="make_md_step's precision (mixed: float64 "
                             "positions)")
    args = parser.parse_args()
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
    system, force, box_len, constraints = build_system(nbt, args.method)
    blob = np.load(STATE_FILE)
    pos_np = np.asarray(blob["positions"], dtype=np.float64)
    vel_np = np.asarray(blob["velocities"], dtype=np.float64)
    masses = np.tile(WATER_MASSES, N_MOLECULES)
    bonds = None
    if args.solute or args.constrained:
        (system, force, pos_np, masses, constraints, bonds,
         kept) = build_solute_system(nbt, pos_np, box_len, args.method)
        vel_np = solute_velocities(vel_np, kept)
    if args.constrained:
        from nonbondedslicing_tpu_torch.runtime.constraints import \
            cluster_constraints
        triples, bonds = chain_constraints(constraints, bonds)
        constraints = cluster_constraints(triples, len(masses))
    plan = plan_mod.build_plan(force, system)
    n = plan.num_particles
    counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n,
                                        target_skin=DEFAULT_SKIN)[0]
    occ = max_cell_occupancy(pos_np, plan.box0, counts)
    # a wider margin than chip_smoke.py's, as no capacity retry runs here
    capacity = max(8, int(np.ceil((occ + 16) / 4) * 4))
    run = make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                       cell_capacity=capacity, constraints=constraints,
                       bonds=bonds, pme_pipeline=args.pipeline,
                       mixed_precision=args.precision == "mixed")
    data = engine_mod.plan_data(plan, device=dev, dtype=f32)
    box = torch.as_tensor(np.diag([box_len] * 3), device=dev).to(f32)
    gvals = torch.as_tensor(plan.global_defaults, device=dev).to(f32)
    p = torch.as_tensor(pos_np, device=dev).to(f32)
    v = torch.as_tensor(vel_np, device=dev).to(f32)
    path = (" (constrained solute)" if args.constrained
            else " (solute path)" if args.solute else "")
    print(f"md: {n} atoms{path}, "
          f"config {run.config}")

    # warm-up: both window lengths' graphs are captured
    p, v, _ = run(p, v, box, gvals, data, CHUNK_STEPS)
    p, v, _ = run(p, v, box, gvals, data, PROFILED_STEPS)
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
    host, launches = defaultdict(int), defaultdict(int)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name in HOST_LAUNCHES:
                host[ev.name] += 1
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        per_name[ev.name] += end - start
        launches[ev.name] += 1
        # copies and fills; a CUDA graph runs its copy and fill nodes as
        # kernels of these names
        if not ev.name.lower().startswith(("memcpy", "memset")):
            n_kernels += 1
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = busy_us(intervals) / 1000.0
    steps = PROFILED_STEPS
    by_call = ", ".join(f"{k} {v / steps:.2f}"
                        for k, v in sorted(host.items()))
    print(f"profiled: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step, "
          f"{n_kernels / steps:.1f} kernel launches/step, "
          f"{sum(host.values()) / steps:.2f} host launch calls/step "
          f"({by_call}), device idle "
          f"{100.0 * (1.0 - busy_ms / wall_ms):.1f}% ({card})")
    if hasattr(run, "stats"):        # the graph's captures and replays
        print(f"graphs: {run.stats}")
    total_us = sum(per_name.values())
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1000.0 / steps:8.4f} ms/step "
              f"{100.0 * us / total_us:5.1f}% "
              f"{launches[name] / steps:6.3f}/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
