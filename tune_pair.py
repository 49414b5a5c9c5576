#!/usr/bin/env python3
"""Time variants of the two pair kernels on one NVIDIA GPU.

    python3 tune_pair.py variants.json

``variants.json`` maps a variant's name to the edits that make it from the
sources in ``nonbondedslicing_tpu_torch/csrc``:

    {"base": {},
     "warps16": {"pair_common.cuh": [["kWarps = 8;", "kWarps = 16;"]]}}

Each variant is a copy of the package in a temporary directory with the
edits applied (every ``old`` text must occur), built there by its own
``runtime/kernels.py`` and timed in its own process: ``pair_column`` on the
23,289-atom water box and ``pair_cell`` on the 23,172-atom solute box of
``chip_smoke.py``, force-only and with energies, by ``chip_smoke.cuda_ms``
(30 launches queued behind other device work, twice each).  Prints, per
variant, what ptxas reports for the pair kernels (registers, spills) and
one line ``TIMES <name> {...}`` in ms.  A variant that leaves pieces of a
kernel out shows what the rest costs; nothing here checks results: that is
``chip_smoke.py``'s and the ``gpu`` tests' part.  The repository's sources
are not touched.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "nonbondedslicing_tpu_torch"


def time_variant(variant_dir):
    """The worker: build the package copy in ``variant_dir`` and time it."""
    sys.path.insert(0, variant_dir)
    sys.path.append(ROOT)
    os.environ["NBS_TORCH_BUILD_DIR"] = os.path.join(variant_dir, "lib")
    import numpy as np
    import torch
    import nonbondedslicing_tpu_torch as nbt
    import chip_smoke
    import port_systems
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import neighbors, plan as plan_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN
    from nonbondedslicing_tpu_torch.runtime.kernels import LIBRARY
    assert nbt.__file__.startswith(variant_dir), nbt.__file__
    dev = torch.device("cuda", 0)
    LIBRARY.build()
    keep = False
    for line in LIBRARY.build_log.splitlines():
        if "Compiling entry" in line:
            keep = "pair_c" in line
            if keep:
                print("ptxas:", "cell" if "pair_cell" in line else "column",
                      "energies" if "ILb1" in line else "force-only")
        elif keep and ("registers" in line or "spill" in line):
            print("ptxas:", line.strip())

    def slot_args(system, force, pos_np, raw):
        """The pair wrapper's arguments up to ``cfg``, and n_real."""
        plan = plan_mod.build_plan(force, system)
        n = plan.num_particles
        counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff, n,
                                            target_skin=DEFAULT_SKIN)[0]
        occ = port_systems.max_cell_occupancy(pos_np, plan.box0, counts)
        capacity = max(8, int(np.ceil((occ + 8) / 4) * 4))
        prepare, _, cfg = fused_mod.make_fused_engine(
            plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
            energies=True)
        pc = cfg["pair"]
        f32 = torch.float32
        data = engine_mod.plan_data(plan, device=dev, dtype=f32)
        pos = torch.as_tensor(pos_np, device=dev).to(f32)
        box = torch.as_tensor(np.asarray(plan.box0), device=dev).to(f32)
        gvals = torch.as_tensor(plan.global_defaults, device=dev).to(f32)
        st = prepare(pos, box, gvals, data)
        g, C = pc.n_cells, pc.capacity
        base = pos if raw else st["pos0w"]
        slot_pos = (torch.cat([base, pos.new_zeros((1, 3))])[st["slots"]]
                    .reshape(g, C, 3).transpose(1, 2)
                    + st["padfix3"]).contiguous()
        lam = slice_lambdas(plan.lam_source, gvals)
        sl = torch.as_tensor(plan.slice_table, dtype=torch.int64, device=dev)
        return (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
                st["sexcl"], lam[:, 0][sl].contiguous(),
                lam[:, 1][sl].contiguous(), box, pc), n

    system, force, box_len, _ = port_systems.build_system(nbt)
    pos_np = np.asarray(np.load(port_systems.STATE_FILE)["positions"],
                        dtype=np.float64)
    column = slot_args(system, force, pos_np, False)
    s_system, s_force, s_pos_np, *_ = port_systems.build_solute_system(
        nbt, pos_np, box_len)
    cell = slot_args(s_system, s_force, s_pos_np, True)
    times = {}
    for _ in range(2):
        for name, fn, (args, n), energies in (
                ("pair_column", cuda_direct.pair_column, column, False),
                ("pair_column_energies", cuda_direct.pair_column, column,
                 True),
                ("pair_cell", cuda_direct.pair_cell, cell, False),
                ("pair_cell_energies", cuda_direct.pair_cell, cell, True)):
            times.setdefault(name, []).append(round(chip_smoke.cuda_ms(
                lambda: fn(*args, energies, n), 30), 4))
    print("TIMES", os.path.basename(variant_dir), times, flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        time_variant(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        variants = json.load(f)
    failed = 0
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        for name, edits in variants.items():
            variant_dir = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, PACKAGE),
                            os.path.join(variant_dir, PACKAGE),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for source, pairs in edits.items():
                path = os.path.join(variant_dir, PACKAGE, "csrc", source)
                with open(path) as f:
                    text = f.read()
                for old, new in pairs:
                    if old not in text:
                        raise SystemExit(f"{name}: {source} has no {old!r}")
                    text = text.replace(old, new)
                with open(path, "w") as f:
                    f.write(text)
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 variant_dir], capture_output=True, text=True)
            print(f"== {name}: exit code {run.returncode}", flush=True)
            print("\n".join(line for line in run.stdout.splitlines()
                            if line.startswith(("ptxas", "TIMES"))),
                  flush=True)
            if run.returncode:
                failed += 1
                print(run.stdout[-1500:], run.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
