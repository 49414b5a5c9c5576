#!/usr/bin/env python3
"""Times of the port's paths that run the atom-space PME or the exclusion
rows, for one copy of the port, on one NVIDIA GPU.

    python3 time_paths.py [--tree DIR]

Imports ``nonbondedslicing_tpu_torch`` from DIR (default: this checkout;
its kernels build under DIR/build/), so that two versions of the package
can be timed in turns on one card: unpack an earlier commit's package
and pyproject.toml into a directory that .gitignore lists
(``git archive <rev> nonbondedslicing_tpu_torch pyproject.toml``) and run
the two in turns, earlier, current, current, earlier.  The systems and
helpers come from this checkout's port_systems.py and chip_smoke.py.
Prints the card's name and power limit, then one JSON object:

* ``md_rigid``: the benchmark's graphed MD step (chip_smoke.py phase 5:
  23,289 atoms, PME, the fused engine, whose exclusion rows run every
  step), ms/step of TIMED_CHUNKS chunks of CHUNK_STEPS steps after a
  warm-up chunk;
* ``compute``: ``ops/engine.make_compute`` in float32 (phase 11: the
  kernel route and the atom-space PME) on the rigid box under PME and
  LJPME and on the solute box under PME, CUDA-event ms of CALLS calls
  after a warm-up call;
* ``rebuild``: the per-step rebuild (phase 12 (g): the 1,596-atom water
  cube, all pairs and the atom-space PME, graphed windows of 25 steps),
  ms/step of TIMED_CHUNKS chunks after a warm-up chunk;
* ``slab_nccl``: ``parallel/fused_shard.make_sharded_md_step`` on one
  NCCL rank in this process (phase 15 (b): graphed, the atom-range PME
  and exclusion rows) on the rigid box under PME and LJPME and the solute
  box with its chain constrained, ms/step of SLAB_CHUNKS chunks after a
  warm-up chunk.

Every list holds the times of the chunks or calls in the order they ran.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMED_CHUNKS = 5
SLAB_CHUNKS = 3
CALLS = 5


def free_port():
    """A free TCP port on localhost for the one-rank process group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="the directory whose nonbondedslicing_tpu_torch "
                             "is timed (default: this checkout)")
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path[:0] = [tree, ROOT]
    import torch
    if not torch.cuda.is_available():
        print("time_paths.py: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    import nonbondedslicing_tpu_torch as nbt
    if not os.path.dirname(nbt.__file__).startswith(tree):
        print(f"time_paths.py: imported {nbt.__file__}, not from {tree}",
              file=sys.stderr)
        return 2
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import neighbors
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    from nonbondedslicing_tpu_torch.parallel import fused_shard
    from nonbondedslicing_tpu_torch.runtime import constraints as cons_mod
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    from nonbondedslicing_tpu_torch.runtime.kernels import LIBRARY
    from chip_smoke import CHUNK_STEPS, Chunks, card_inputs
    from port_systems import (DT_PS, N_MOLECULES, STATE_FILE, WATER_MASSES,
                              build_solute_system, build_system,
                              chain_constraints, max_cell_occupancy,
                              solute_velocities, water_cube, water_system)

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")
    t0 = time.time()
    LIBRARY.build()
    print(f"tree {tree}: kernels built in {time.time() - t0:.1f} s")
    blob = np.load(STATE_FILE)
    pos_np = np.asarray(blob["positions"], dtype=np.float64)
    vel_np = np.asarray(blob["velocities"], dtype=np.float64)
    masses = np.tile(WATER_MASSES, N_MOLECULES)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}

    def capacity_of(plan, p_np, target_skin):
        counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                            plan.num_particles,
                                            target_skin=target_skin)[0]
        occ = max_cell_occupancy(p_np, plan.box0, counts)
        return max(8, int(np.ceil((occ + 8) / 4) * 4))

    def chunk_ms(chunks, p, v, box, gvals, data, timed):
        """ms/step of ``timed`` chunks after a warm-up chunk."""
        ms = []
        for i in range(1 + timed):
            torch.cuda.synchronize()
            start = time.perf_counter()
            p, v, _ = chunks(p, v, box, gvals, data, CHUNK_STEPS)
            torch.cuda.synchronize()
            if i:
                ms.append(1e3 * (time.perf_counter() - start) / CHUNK_STEPS)
        return ms

    def calls_ms(fn):
        """CUDA-event ms of CALLS calls after a warm-up call."""
        fn()
        ms = []
        for _ in range(CALLS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return ms

    def vel(v_np):
        return torch.as_tensor(v_np, device=dev).to(f32)

    # phase 5: the graphed fused step
    system, force, box_len, cons = build_system(nbt)
    plan = plan_mod.build_plan(force, system)
    pos, box, gvals, data = card_inputs(plan, pos_np, f32, dev)
    chunks = Chunks(lambda cap, reuse: make_md_step(
        plan, masses, dt=DT_PS, dtype=f32, cell_capacity=cap,
        reuse_steps=reuse, constraints=cons),
        capacity_of(plan, pos_np, DEFAULT_SKIN), nbt.OpenMMException)
    out["md_rigid"] = chunk_ms(chunks, pos, vel(vel_np), box, gvals, data,
                               TIMED_CHUNKS)

    # phase 11: make_compute
    s_system, s_force, s_pos, s_masses, water_cons, bonds, kept = \
        build_solute_system(nbt, pos_np, box_len)
    s_plan = plan_mod.build_plan(s_force, s_system)
    lj_system, lj_force, _, _ = build_system(nbt, "LJPME")
    lj_plan = plan_mod.build_plan(lj_force, lj_system)
    out["compute"] = {}
    for label, p_plan, p_np in (("rigid PME", plan, pos_np),
                                ("rigid LJPME", lj_plan, pos_np),
                                ("solute PME", s_plan, s_pos)):
        compute = engine_mod.make_compute(p_plan, True, True)
        args = card_inputs(p_plan, p_np, f32, dev)
        out["compute"][label] = calls_ms(lambda: compute(*args))

    # phase 12 (g): the per-step rebuild on the water cube
    c_pos, c_vel, c_edge = water_cube(pos_np, vel_np, box_len, 2.6)
    c_system, c_force, c_cons = water_system(nbt, len(c_pos) // 3, c_edge)
    c_plan = plan_mod.build_plan(c_force, c_system)
    c_masses = np.tile(WATER_MASSES, len(c_pos) // 3)
    chunks = Chunks(lambda cap, reuse: make_md_step(
        c_plan, c_masses, dt=DT_PS, dtype=f32, constraints=c_cons),
        None, nbt.OpenMMException)
    c_p, c_box, c_gvals, c_data = card_inputs(c_plan, c_pos, f32, dev)
    out["rebuild"] = chunk_ms(chunks, c_p, vel(c_vel), c_box, c_gvals,
                              c_data, TIMED_CHUNKS)

    # phase 15 (b): the slab step on one NCCL rank
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        triples, _ = chain_constraints(water_cons, bonds)
        slab = {"rigid PME": (plan, pos_np, vel_np, masses, cons),
                "rigid LJPME": (lj_plan, pos_np, vel_np, masses, cons),
                "solute PME": (s_plan, s_pos,
                               solute_velocities(vel_np, kept), s_masses,
                               cons_mod.cluster_constraints(
                                   triples, len(s_masses)))}
        out["slab_nccl"] = {}
        for label, (p_plan, p_np, v_np, p_masses, p_cons) in slab.items():
            chunks = Chunks(
                lambda cap, reuse, p_plan=p_plan, p_masses=p_masses,
                p_cons=p_cons: fused_shard.make_sharded_md_step(
                    p_plan, p_masses, DT_PS, dtype=f32, constraints=p_cons,
                    reuse_steps=reuse, cell_capacity=cap),
                capacity_of(p_plan, p_np, 0.1), nbt.OpenMMException)
            pos, box, gvals, data = card_inputs(p_plan, p_np, f32, dev)
            out["slab_nccl"][label] = chunk_ms(chunks, pos, vel(v_np), box,
                                               gvals, data, SLAB_CHUNKS)
            if not chunks.run.config["graph"]:
                print(f"time_paths.py: the slab step of {label} is not "
                      f"graphed", file=sys.stderr)
                return 1
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
