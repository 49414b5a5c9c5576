#!/usr/bin/env python3
"""Time variants of the PME kernels on one NVIDIA GPU.

    python3 tune_spread.py variants.json

``variants.json`` maps a variant's name to the edits that make it from the
sources in ``nonbondedslicing_tpu_torch/csrc``, as tune_pair.py's do:

    {"base": {},
     "no_adds": {"pme_spread.cu": [
         ["nbs::accumulate<Real>(st, lines, n, layout, acc);", ""]]}}

With ``"probe": true`` the worker also runs each spread once and prints
``PROBE`` lines: the mean and largest over the blocks of the eight floats
that the variant's edits leave in a ``__device__`` array, read through the
C entry points ``nbs_debug_read`` (pme_spread.cu) and ``nbs_debug_read_w``
(pme_spread_windows.cu) that the edits add; clock64() phase times, say.

Each variant is a copy of the package in a temporary directory with the
edits applied (every ``old`` text must occur), built there by its own
``runtime/kernels.py`` and timed in its own process at the shapes of
chip_smoke.py's benchmark box (23,289 atoms, cells and bricks 6^3): the
float spread of the charges on the 60^3 PME grid, its double variant, the
float spread of LJPME's C6 weights on the 30^3 dispersion grid, the window
spread of the charges, the interpolation of the charges' forces from 60^3
potential grids and of the C6 weights' from 30^3 ones, the fold of the
charges' windows, the extract of the windows of the potential grids made
from that fold, and the window interpolation of the charges' forces from
those windows, each by chip_smoke.cuda_ms (30 launches queued behind
other device work, twice).  When build/parent_csrc/ holds the parent's
pme_extract.cu and pme_interp_windows.cu (see chip_smoke.py), each
process times them too, in the same turns.  Prints, per variant, what
ptxas reports for these kernels and one line ``TIMES <name> {...}`` in ms,
after the card's name and power limit.  Nothing here checks results (a variant that leaves
a piece out shows what the rest costs): that is chip_smoke.py's and the
``gpu`` tests' part.  The repository's sources are not touched.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "nonbondedslicing_tpu_torch"


def time_variant(variant_dir, probe):
    """The worker: build the package copy in ``variant_dir`` and time it."""
    sys.path.insert(0, variant_dir)
    sys.path.append(ROOT)
    os.environ["NBS_TORCH_BUILD_DIR"] = os.path.join(variant_dir, "lib")
    import numpy as np
    import torch
    import nonbondedslicing_tpu_torch as nbt
    import chip_smoke
    import port_systems
    from nonbondedslicing_tpu_torch.ops import cuda_pme, pme_bricks
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import neighbors, plan as plan_mod
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors
    from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN
    from nonbondedslicing_tpu_torch.runtime.kernels import LIBRARY
    assert nbt.__file__.startswith(variant_dir), nbt.__file__
    dev = torch.device("cuda", 0)
    procs = chip_smoke.start_parent_build()
    LIBRARY.build()
    parent = chip_smoke.load_parent(procs)
    keep = False
    for line in LIBRARY.build_log.splitlines():
        if "Compiling entry" in line:
            keep = any(k in line for k in ("spread", "interp", "fold",
                                           "extract"))
            if keep:
                print("ptxas:", line.split("'")[1] if "'" in line else line)
        elif keep and ("registers" in line or "spill" in line):
            print("ptxas:", line.strip())

    system, force, _, _ = port_systems.build_system(nbt, "LJPME")
    plan = plan_mod.build_plan(force, system)
    pos_np = np.asarray(np.load(port_systems.STATE_FILE)["positions"],
                        dtype=np.float64)
    counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                        plan.num_particles,
                                        target_skin=DEFAULT_SKIN)[0]
    occ = port_systems.max_cell_occupancy(pos_np, plan.box0, counts)
    capacity = max(8, int(np.ceil((occ + 8) / 4) * 4))
    prepare, _, cfg = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN)
    f32 = torch.float32
    data = engine_mod.plan_data(plan, device=dev, dtype=f32)
    pos = torch.as_tensor(pos_np, device=dev).to(f32)
    box = torch.as_tensor(np.asarray(plan.box0), device=dev).to(f32)
    st = prepare(pos, box, torch.ones(2, device=dev), data)
    g, C = cfg["pair"].n_cells, cfg["pair"].capacity
    slot_pos = (torch.cat([st["pos0w"], pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    nsub, bricks = plan.num_subsets, cfg["bricks"]
    calls = {}
    for name, weight, grid_key, double in (
            ("pme_spread", "slot_q", "pme_grid", False),
            ("pme_spread_energies", "slot_q", "pme_grid", True),
            ("pme_spread_dispersion", "slot_c6", "dispersion_grid", False)):
        grid = cfg[grid_key]
        args = (slot_pos, st[weight], st["slot_sub"],
                recip_box_vectors(box.double() if double else box), grid,
                nsub)
        kw = dict(double=double, lattice=counts,
                  radius=cuda_pme.spread_radius(grid, counts, cfg["skin"],
                                                plan.box0))
        calls[name] = (lambda a=args, k=kw: cuda_pme.pme_spread(*a, **k))
        if not double:   # the potential grids of this grid's interpolation
            eterm = (pme_mod.dispersion_eterm_np(
                grid, cfg["dpme_moduli"], plan.box0, plan.dispersion_alpha)
                if weight == "slot_c6" else pme_mod.coulomb_eterm_np(
                    grid, cfg["pme_moduli"], plan.box0, plan.ewald_alpha))
            eterm = torch.as_tensor(eterm, device=dev).to(f32)
            phi = torch.fft.irfftn(
                torch.fft.rfftn(calls[name](), dim=(1, 2, 3)) * eterm,
                s=tuple(grid), dim=(1, 2, 3), norm="forward").contiguous()
            i_args = (phi,) + args[:4]
            i_name = name.replace("spread", "interp")
            calls[i_name] = (lambda a=i_args: cuda_pme.pme_interp(*a))

    def to_bricks(x):
        return pme_bricks.cells_to_bricks(x, counts, bricks).contiguous()

    w_args = (to_bricks(slot_pos), to_bricks(st["slot_q"][:, None])[:, 0],
              to_bricks(st["slot_sub"][:, None])[:, 0],
              recip_box_vectors(box), cfg["pme_grid"], bricks, nsub)
    w_args = tuple(a.contiguous() if torch.is_tensor(a) else a
                   for a in w_args)
    calls["pme_spread_windows"] = lambda: cuda_pme.pme_spread_windows(*w_args)
    W = calls["pme_spread_windows"]()
    calls["pme_fold"] = lambda: cuda_pme.pme_fold(W)
    grid = cfg["pme_grid"]
    eterm = torch.as_tensor(pme_mod.coulomb_eterm_np(
        grid, cfg["pme_moduli"], plan.box0, plan.ewald_alpha),
        device=dev).to(f32)
    phi = torch.fft.irfftn(
        torch.fft.rfftn(calls["pme_fold"](), dim=(1, 2, 3)) * eterm,
        s=tuple(grid), dim=(1, 2, 3), norm="forward").contiguous()
    calls["pme_extract"] = lambda: cuda_pme.pme_extract(phi, bricks)
    i_args = (calls["pme_extract"](),) + w_args[:4]
    calls["pme_interp_windows"] = lambda: cuda_pme.pme_interp_windows(*i_args)
    if parent is not None:
        calls["pme_extract parent"] = (
            lambda: chip_smoke.parent_extract(parent, phi, bricks))
        calls["pme_interp_windows parent"] = (
            lambda: chip_smoke.parent_interp_windows(parent, *i_args))
    times = {}
    for _ in range(2):
        for name, fn in calls.items():
            times.setdefault(name, []).append(
                round(chip_smoke.cuda_ms(fn, 30), 5))
    print("TIMES", os.path.basename(variant_dir), times, flush=True)
    if probe:
        import ctypes
        lib = LIBRARY.build()
        for name, reader, blocks in (
                ("pme_spread", "nbs_debug_read", g),
                ("pme_spread_dispersion", "nbs_debug_read", g),
                ("pme_spread_windows", "nbs_debug_read_w", g * nsub)):
            calls[name]()
            torch.cuda.synchronize()
            buf = (ctypes.c_float * (8 * blocks))()
            getattr(lib, reader)(buf, 8 * blocks)
            a = np.frombuffer(buf, dtype=np.float32).reshape(blocks, 8)
            print("PROBE", name, "mean", np.round(a.mean(0), 1).tolist(),
                  "max", np.round(a.max(0), 1).tolist(), flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        time_variant(sys.argv[2], json.loads(sys.argv[3]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        variants = json.load(f)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    failed = 0
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        for name, edits in variants.items():
            edits = dict(edits)
            probe = edits.pop("probe", False)
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
                 variant_dir, json.dumps(probe)],
                capture_output=True,
                text=True)
            print(f"== {name}: exit code {run.returncode}", flush=True)
            print("\n".join(line for line in run.stdout.splitlines()
                            if line.startswith(("ptxas", "TIMES", "PROBE"))),
                  flush=True)
            if run.returncode:
                failed += 1
                print(run.stdout[-1500:], run.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
