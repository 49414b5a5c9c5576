#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Two systems through make_md_step, both at full width, under PME and under
LJPME:

* the benchmark's MD step (bench.py): 7,763 rigid 3-site waters (23,289
  atoms) in a 6.16 nm box, 3 subsets and two lambda scaling parameters, PME
  (cutoff 0.9 nm, Ewald tolerance 5e-4), water-triangle exclusions, SETTLE
  and leapfrog at 2 fs, from the pre-equilibrated 300 K state in
  extras/bench_state_rigid.npz.  Its pair kernel is the column kernel
  (csrc/pair_column.cu).
* the solute path: a flexible 12-site united-atom chain in a cavity of the
  same water box, decoupled by lambda_elec / lambda_vdw, with harmonic
  bonds.  Its exclusions are not water triangles, so the fused engine takes
  the min-image cell kernel (csrc/pair_cell.cu) with the Ewald exclusion
  corrections fused in, and the waters take the gather (M-SHAKE)
  constrainer.

Both systems are built through the port's force/System API (bench.py
itself imports the JAX package).  Under LJPME (port_systems.py,
method="LJPME": the dispersion Ewald sum at the same cutoff and tolerance,
alpha 2.92, a 28-point dispersion grid aligned to the bricks as 30) both
pair kernels add the real-space dispersion terms (B4 also backs out the
excluded pairs' reciprocal dispersion) and the spread and interpolation
kernels run a second time on the dispersion grid with per-slot C6 weights.

Phases, each printed on its own line; any failure exits non-zero before
the last line:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. the nvcc build of csrc/*.cu (sm_90a) and its time;
3. each kernel of the benchmark path (the double spread of energy
   evaluations included) against its plain PyTorch twin on the same CUDA
   tensors at the benchmark shapes, with CUDA-event times of both;
4. one prepare + apply (energies) in float32 on the card against the same
   code on CPU tensors in float64 (the plain twins), and the forces of one
   force-only apply, the variant every MD inner step runs, against the
   same;
5. make_md_step from the benchmark state: one 200-step warm-up chunk, then
   five timed 200-step chunks (median and range of ms/step and ns/day);
   energy, guards, constraints, temperature and the launch count of each
   kernel;
6. the solute path: the system (atoms, waters removed, cells, capacity,
   emax), every excluded pair's span against one cell width, pair_cell and
   the three PME kernels against their plain twins at these shapes
   (nsub 2), the card-f32 vs CPU-f64 evaluations of phase 4, and
   make_md_step with the bonds and the water constraints: one 200-step
   warm-up chunk, then three timed chunks; energy, constraints,
   temperature and the launch counts (pair_cell > 0, pair_column 0);
7. the brick-window PME pipeline (pme_pipeline="grid"): at both boxes'
   shapes the window spread, fold, extract and window interpolation kernels
   against their plain twins (fold and extract to the bit), the folded
   windows against the whole-grid spread and the pipeline's forces against
   the default pipeline's; the evaluations of phases 4 and 6 through it
   against the same CPU float64 references; and the benchmark's MD through
   make_md_step(pme_pipeline="grid"), one warm-up chunk and three timed
   chunks, with the window kernels launched on every step and the
   whole-grid float kernels never, its ms/step beside phase 5's;
8. LJPME: the rigid-water box's plan (its skin as under PME; the window
   pipeline refused, 5 dispersion-grid points a brick), the LJPME variants
   of pair_column (force-only and energies) against the plain twin, the
   spread (float and double) and interpolation kernels with C6 weights on
   the dispersion grid against theirs, the card-f32 vs CPU-f64 evaluations
   of phase 4, and make_md_step: one warm-up chunk and three timed chunks,
   the dispersion pass launched as often as the Coulomb one; then the
   solute box under LJPME: the LJPME variants of pair_cell and the
   dispersion pass's kernels at its shapes against their twins, and the
   evaluations with energies and force-only against CPU f64 (dE/dlambda_vdw
   and dE/dlambda_elec included), counted; no MD chunks.

The two spread kernels (csrc/pme_spread.cu, csrc/pme_spread_windows.cu;
their shared design in csrc/spread_common.cuh) are owner-computes: a block
owns a region of points (a slot group's grid points, or a brick's window),
gathers the atoms that reach it, sums them in shared memory in 64-bit fixed
point and stores each point once, in one launch without global atomics.
The whole-grid interpolation (csrc/pme_interp.cu) gives each atom two
threads in two warps, splitting its 25 stencil lines 13 and 12, reads each
line's 5 z points as aligned float4 (float2) chunks and adds the two shares
in a fixed order; the fold (csrc/pme_fold.cu) gives a warp one output
line and stages that line's window rows whole; extract (csrc/pme_extract.cu)
gives a block one window and a thread 16-byte chunks of its rows; the
window interpolation (csrc/pme_interp_windows.cu) is B3's design with the
window's edges in place of the wrap.  Each PME
kernel entry counts the kernels one call puts on the card
(launches_per_call, from a profiler trace of ten calls of each kernel and
variant at its first entry); the spreads give the whole-grid spread's
neighbour radius per axis (radius), and every interpolation entry, whole
grid or windows, checks that two launches give the same forces to the
bit.  When build/parent_csrc/ (or $NBS_PARENT_CSRC) holds an earlier
version's pme_extract.cu and pme_interp_windows.cu with the same C entry
points (``git show <rev>:nonbondedslicing_tpu_torch/csrc/<file>``), they
are built beside the kernels and every pme_extract and pme_interp_windows
entry also gets that version's time from this run, in turns parent,
kernel, kernel, parent (parent_ms), its launches per call, and how far its
output is from the kernel's (equals_parent, parent_max_abs_diff); extract
must equal it to the bit.

Both systems come from port_systems.py.  The line before the last is a
JSON object of the kernels, one entry per kernel and path ("rigid",
"solute", "rigid_ljpme" or "solute_ljpme"): launches in that path's run
(the MD runs of phases 5, 6, 7 and 8; the solute box's evaluations of
phases 7 and 8), max abs error against the plain
twin, CUDA-event ms of kernel and twin, and the bound: the larger of the
operations the inputs need over 67 TFLOP/s (H100 SXM FP32 outside the
tensor cores; 34 TFLOP/s FP64 for the double spread) and the bytes read
and written once over 3.35 TB/s; library_ms is the time of one PyTorch call
that computes the same function where there is one (fold: index_add_,
extract: take; the port calls neither), else null.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from port_systems import (CAVITY_NM, D_HH, D_OH, DT_PS, KB, N_MOLECULES,
                          SOLUTE_SITES, STATE_FILE, WATER_MASSES,
                          build_solute_system, build_system,
                          max_cell_occupancy, solute_velocities)

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(ROOT, "nonbondedslicing_tpu_torch")
# an earlier version's extract and window interpolation kernels to time
# beside the current ones
PARENT_DIR = os.environ.get("NBS_PARENT_CSRC",
                            os.path.join(ROOT, "build", "parent_csrc"))
PARENT_SOURCES = ("pme_extract.cu", "pme_interp_windows.cu")

CHUNK_STEPS = 200
TIMED_CHUNKS = 5
SOLUTE_TIMED_CHUNKS = 3
GRID_TIMED_CHUNKS = 3
LJPME_TIMED_CHUNKS = 3
BACKLOG_MS = 1.0          # see cuda_ms

# tolerances (kernel vs plain twin on the card; card f32 vs CPU f64)
TOL_FORCE = 2e-5          # of max|F| + 1
TOL_ENERGY = 1e-5         # of max|E| + 1, after the f64 reduction
TOL_GRID = 2e-5           # of the spread grid's max
TOL_GRID64 = 1e-7         # of the max, the double spread (2^-40 fixed point)
TOL_GRID_SUM = 1e-6       # relative, a subset's charge on either design's grid
TOL_EVAL_ENERGY = 1e-5    # relative total energy, card f32 vs CPU f64
TOL_EVAL_FORCE = 5e-5     # of max|F|, card f32 vs CPU f64
TOL_EVAL_DERIV = 1e-5     # relative dE/dlambda
TOL_CONSTRAINT = 1e-5     # nm

# the bound: peaks of one H100 SXM (NVIDIA's data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12           # FP32 outside the tensor cores
PEAK_FP64_FLOPS = 34e12           # FP64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12        # HBM3
# float operations of the kernels' arithmetic per unit of work that the
# inputs need (an FMA counts two; rsqrt, exp, floor and a division one)
PAIR_OPS = 58           # a pair within the cutoff: Ewald + LJ forces
PAIR_ENERGY_OPS = 9     # ... and its two energies (pair_common.cuh)
MIN_IMAGE_OPS = 21      # ... and its minimum image (pair_cell.cu)
EXCL_OPS = 45           # an excluded pair's Ewald correction, force
EXCL_ENERGY_OPS = 5     # ... and its energy (pair_cell.cu)
LJPME_PAIR_OPS = 25     # LJPME: a pair's c6 product and dispersion force
LJPME_PAIR_ENERGY_OPS = 16   # ... its dispersion energy and shift
LJPME_EXCL_OPS = 26     # ... an excluded pair's dispersion back-out, force
LJPME_EXCL_ENERGY_OPS = 4    # ... and energy (pair_common.cuh, dispersion)
SPREAD_OPS = 466        # a charged atom: coordinates, 3 splines, 125 weights
GRID_POINT_OPS = 2      # a grid point: fixed point to float (pme_spread.cu)
INTERP_OPS = 935        # a charged atom: splines and derivatives, 125-point
                        # gradient, force (pme_interp.cu)
FOLD_OPS = 1            # a window point beyond a grid point's first: one add

# the port's kernels: launch-count key -> (source, the TPU kernel's
# pallas_call it replaces); a key's "_ljpme" and "_dispersion" variants
# are LJPME's, "_energies" the variants of evaluations with energies
_SOURCES = {
    "pair_column": ("csrc/pair_column.cu",
                    "nonbondedslicing_tpu/ops/pallas_direct.py:609"),
    "pair_cell": ("csrc/pair_cell.cu",
                  "nonbondedslicing_tpu/ops/pallas_direct.py:377"),
    "pme_spread": ("csrc/pme_spread.cu",
                   "nonbondedslicing_tpu/ops/pallas_pme.py:156"),
    "pme_interp": ("csrc/pme_interp.cu",
                   "nonbondedslicing_tpu/ops/pallas_pme.py:391"),
    "pme_spread_windows": ("csrc/pme_spread_windows.cu",
                           "nonbondedslicing_tpu/ops/pallas_pme.py:156"),
    "pme_fold": ("csrc/pme_fold.cu",
                 "nonbondedslicing_tpu/ops/pallas_pme.py:249"),
    "pme_extract": ("csrc/pme_extract.cu",
                    "nonbondedslicing_tpu/ops/pallas_pme.py:316"),
    "pme_interp_windows": ("csrc/pme_interp_windows.cu",
                           "nonbondedslicing_tpu/ops/pallas_pme.py:391"),
}
KERNELS = {
    key: _SOURCES[base]
    for base, variants in (
        ("pair_column", ("", "_energies", "_ljpme", "_ljpme_energies")),
        ("pair_cell", ("", "_energies", "_ljpme", "_ljpme_energies")),
        ("pme_spread", ("", "_energies", "_dispersion",
                        "_dispersion_energies")),
        ("pme_interp", ("", "_dispersion")),
        ("pme_spread_windows", ("", "_dispersion")),
        ("pme_fold", ("", "_dispersion")),
        ("pme_extract", ("", "_dispersion")),
        ("pme_interp_windows", ("", "_dispersion")))
    for key in (base + v for v in variants)}
WINDOW_KERNELS = ("pme_spread_windows", "pme_fold", "pme_extract",
                  "pme_interp_windows")
DISPERSION_KERNELS = ("pme_spread_dispersion",
                      "pme_spread_dispersion_energies",
                      "pme_interp_dispersion")
# the entries of the kernels line: (name, kernel, path, run), each kernel
# held against its plain twin at its path's shapes and counted in the run
# of that path that goes through it
ENTRIES = (
    ("pair_column", "pair_column", "rigid", "rigid"),
    ("pair_column_energies", "pair_column_energies", "rigid", "rigid"),
    ("pme_spread", "pme_spread", "rigid", "rigid"),
    ("pme_spread_energies", "pme_spread_energies", "rigid", "rigid"),
    ("pme_interp", "pme_interp", "rigid", "rigid"),
    ("pair_cell", "pair_cell", "solute", "solute"),
    ("pair_cell_energies", "pair_cell_energies", "solute", "solute"),
    ("pme_spread_solute", "pme_spread", "solute", "solute"),
    ("pme_spread_energies_solute", "pme_spread_energies", "solute", "solute"),
    ("pme_interp_solute", "pme_interp", "solute", "solute"),
) + tuple((k, k, "rigid", "rigid_grid") for k in WINDOW_KERNELS) + tuple(
    (k + "_solute", k, "solute", "solute_grid") for k in WINDOW_KERNELS) + (
    ("pair_column_ljpme", "pair_column_ljpme", "rigid_ljpme", "rigid_ljpme"),
    ("pair_column_ljpme_energies", "pair_column_ljpme_energies",
     "rigid_ljpme", "rigid_ljpme"),
) + tuple((k, k, "rigid_ljpme", "rigid_ljpme") for k in DISPERSION_KERNELS) + (
    ("pair_cell_ljpme", "pair_cell_ljpme", "solute_ljpme", "solute_ljpme"),
    ("pair_cell_ljpme_energies", "pair_cell_ljpme_energies", "solute_ljpme",
     "solute_ljpme"),
) + tuple((k + "_solute", k, "solute_ljpme", "solute_ljpme")
          for k in DISPERSION_KERNELS)
# the kernels each run must launch; it must launch no other
RUN_KERNELS = {
    "rigid": {"pair_column", "pair_column_energies", "pme_spread",
              "pme_spread_energies", "pme_interp"},
    "solute": {"pair_cell", "pair_cell_energies", "pme_spread",
               "pme_spread_energies", "pme_interp"},
    "rigid_grid": {"pair_column", "pair_column_energies",
                   "pme_spread_energies", *WINDOW_KERNELS},
    "solute_grid": {"pair_cell", "pair_cell_energies", "pme_spread_energies",
                    *WINDOW_KERNELS},
    "rigid_ljpme": {"pair_column_ljpme", "pair_column_ljpme_energies",
                    "pme_spread", "pme_spread_energies", "pme_interp",
                    *DISPERSION_KERNELS},
    "solute_ljpme": {"pair_cell_ljpme", "pair_cell_ljpme_energies",
                     "pme_spread", "pme_spread_energies", "pme_interp",
                     *DISPERSION_KERNELS},
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def check_launches(label, run, launches):
    """Every kernel of ``run`` was launched in it, and no other kernel."""
    for name in KERNELS:
        if name in RUN_KERNELS[run]:
            check(launches[name] > 0,
                  f"{label}: {name} launched {launches[name]} times")
        else:
            check(launches[name] == 0,
                  f"{label}: {name} launched {launches[name]} times (not "
                  f"this run's kernel)")


def exclusion_span(positions, pairs, box_len):
    """Largest minimum-image distance of the excluded pairs (cubic box)."""
    d = positions[pairs[:, 0]] - positions[pairs[:, 1]]
    d -= box_len * np.round(d / box_len)
    return float(np.linalg.norm(d, axis=1).max())


def cuda_ms(fn, reps, what=None):
    """Mean ms per call of fn over reps calls after one warm-up call.  The
    timed calls are queued while the card works off two large matrix
    products (a few ms), so that they run back to back: the time is the
    device's, not the rate at which the host can launch (0.02-0.04 ms a
    call through a wrapper, more than the small kernels take).  That holds
    if the card never waited for the host, which is checked: either the
    host had queued the last call before the card finished the products
    (an event after them says so), or the card still had BACKLOG_MS of work
    in front of it when the host had queued the last, far more than the
    0.05 ms a synchronize takes (with the products at the start and equal
    calls between, it then had work throughout).  Otherwise the measurement
    is taken again behind as many products as take twice the time the host
    needed, and fails the run the third time.  A plain twin (``what``
    given) is not held to this: PyTorch's own time for its hundreds of
    small launches is part of what the plain version costs, and the line
    printed says that the time is the host's."""
    import torch
    fn()
    busy = torch.ones((4096, 4096), device="cuda")
    n_busy = 2
    for _ in range(3):
        torch.cuda.synchronize()
        busy_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        busy_start.record()
        for _ in range(n_busy):
            torch.mm(busy, busy)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        stop.record()
        queued_in_time = not start.query()
        t1 = time.perf_counter()
        stop.synchronize()
        backlog_ms = 1e3 * (time.perf_counter() - t1)
        ms = start.elapsed_time(stop) / reps
        if queued_in_time or backlog_ms > BACKLOG_MS:
            return ms
        host_ms = 1e3 * (t1 - t0)
        if what is not None:
            print(f"{what}: the card waited for the host, which took "
                  f"{host_ms / reps:.4f} ms to queue a call: the time is "
                  f"the host's", flush=True)
            return ms
        product_ms = busy_start.elapsed_time(start) / n_busy
        n_busy = int(2 * host_ms / product_ms) + 2
    raise SmokeFailure(f"cuda_ms: the host took {host_ms:.1f} ms to queue "
                       f"{reps} calls of {ms:.4f} ms and the card did not "
                       f"stay busy that long: the time would be the host's "
                       f"launch rate")


def timed_pair(kernel_fn, plain_fn, reps, what="plain twin"):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain."""
    p1 = cuda_ms(plain_fn, reps, what)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps, what)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def bound(ops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """(bound ms, "operations" or "bytes") of work that needs ``ops``
    operations at ``peak_flops`` and moves ``nbytes`` bytes."""
    t_ops = ops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def start_parent_build():
    """Start one nvcc per source of the parent's kernels (PARENT_DIR), or
    return None where they are not there."""
    from nonbondedslicing_tpu_torch.runtime import kernels
    if not all(os.path.exists(os.path.join(PARENT_DIR, f))
               for f in PARENT_SOURCES):
        return None
    out = os.path.join(PARENT_DIR, "lib")
    os.makedirs(out, exist_ok=True)
    procs = []
    for f in PARENT_SOURCES:
        obj = os.path.join(out, f[:-3] + ".o")
        procs.append((obj, subprocess.Popen(
            [kernels._nvcc()] + kernels.NVCC_FLAGS
            + ["-I", str(kernels.CSRC_DIR), "-c", os.path.join(PARENT_DIR, f),
               "-o", obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def load_parent(procs):
    """Link and load the parent's kernels; returns the ctypes library (or
    None where there are none)."""
    import ctypes
    from nonbondedslicing_tpu_torch.runtime import kernels
    if procs is None:
        print("parent: no earlier kernels in " + PARENT_DIR
              + ": parent_ms not measured")
        return None
    for obj, proc in procs:
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"parent: nvcc built {obj}\n" + out)
    path = os.path.join(PARENT_DIR, "lib", "libnbs_parent.so")
    proc = subprocess.run([kernels._nvcc()] + kernels.ARCH_FLAGS
                          + ["-shared", "-o", path] + [o for o, _ in procs],
                          capture_output=True, text=True)
    check(proc.returncode == 0, "parent: linked " + path + proc.stderr)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nbs_pme_extract.argtypes = [P] * 2 + [I] * 7 + [P]
    lib.nbs_pme_interp_windows.argtypes = [P] * 6 + [I] * 8 + [P]
    print(f"parent: the kernels of {PARENT_DIR} built")
    return lib


def parent_extract(lib, grid, bricks):
    """The parent's extract, called as its wrapper calls it."""
    import torch
    nsub, grid_shape = grid.shape[0], tuple(grid.shape[1:])
    p = tuple(n // b for n, b in zip(grid_shape, bricks))
    W = torch.empty(tuple(bricks) + (nsub,) + tuple(pa + 6 for pa in p),
                    dtype=torch.float32, device=grid.device)
    err = lib.nbs_pme_extract(grid.data_ptr(), W.data_ptr(), nsub, *bricks,
                              *p,
                              torch.cuda.current_stream(grid.device)
                              .cuda_stream)
    if err:
        raise SmokeFailure(f"parent nbs_pme_extract: CUDA error {err}")
    return W


def parent_interp_windows(lib, W_phi, slot_pos, weight, slot_sub, recip):
    """The parent's window interpolation, called as its wrapper calls it."""
    import torch
    dev = slot_pos.device
    g, _, C = slot_pos.shape
    forces = torch.empty((g, 3, C), dtype=torch.float32, device=dev)
    err = lib.nbs_pme_interp_windows(
        W_phi.data_ptr(), slot_pos.data_ptr(), weight.data_ptr(),
        slot_sub.data_ptr(), recip.data_ptr(), forces.data_ptr(), C,
        W_phi.shape[3], *W_phi.shape[:3],
        *(w - 6 for w in W_phi.shape[4:]),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise SmokeFailure(f"parent nbs_pme_interp_windows: CUDA error {err}")
    return forces


_OPS_PER_CALL = {}


def device_ops_per_call(fn, key, calls=10):
    """Kernels and memsets one call of fn puts on the card: those of a
    profiler trace of ``calls`` calls after a warm-up, per call, rounded (a
    trace can miss its first event).  Measured at the first call with each
    ``key`` (a kernel and its variant, whose count the inputs do not
    change): traces taken late in a long run lose events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if key not in _OPS_PER_CALL:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        _OPS_PER_CALL[key] = round(sum(
            1 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.name.startswith("Memcpy")) / calls)
    return _OPS_PER_CALL[key]


def against_parent(name, key, kernel_fn, parent_fn, reps):
    """An entry's launches per call (``key``: the kernel and variant) and,
    where ``parent_fn`` runs the parent's kernel, the parent's launches per
    call, its time beside the kernel's (in turns parent, kernel, kernel,
    parent) and how far apart their outputs are."""
    out = dict(launches_per_call=device_ops_per_call(kernel_fn, key),
               parent_ms=None)
    if parent_fn is None:
        print(f"{name}: {out['launches_per_call']} launches a call")
        return out
    import torch
    out["parent_launches_per_call"] = device_ops_per_call(parent_fn,
                                                          "parent " + key)
    ms, out["parent_ms"] = timed_pair(kernel_fn, parent_fn, reps, what=None)
    new, old = kernel_fn(), parent_fn()
    torch.cuda.synchronize()
    out["equals_parent"] = bool(torch.equal(new, old))
    out["parent_max_abs_diff"] = float((new - old).abs().max())
    print(f"{name}: kernel {ms:.4f} ms beside the parent's "
          f"{out['parent_ms']:.4f} ms ({ms / out['parent_ms']:.3f} of it); "
          f"{out['launches_per_call']} launches a call, the parent "
          f"{out['parent_launches_per_call']}; equal to the parent's to the "
          f"bit: {out['equals_parent']} (max|d| "
          f"{out['parent_max_abs_diff']:.3e})")
    return out


def pair_counts(slot_pos, slot_ids, slot_excl, box, cutoff, n_real, counts):
    """(pairs within the cutoff that are not excluded, excluded pairs) among
    the real slots of every 27-cell neighbourhood, each unordered pair once,
    by minimum image in the rectangular ``box``."""
    import torch
    g, _, C = slot_pos.shape
    lengths = torch.diagonal(box).reshape(1, 3, 1, 1)
    grid_pos = slot_pos.reshape(*counts, 3, C)
    grid_ids = slot_ids.reshape(*counts, C)
    real = slot_ids < n_real
    eye = torch.eye(C, dtype=torch.bool, device=slot_pos.device)
    n_pair = n_excl = 0
    for o in range(27):
        roll = dict(shifts=(1 - o // 9, 1 - (o // 3) % 3, 1 - o % 3),
                    dims=(0, 1, 2))
        cand = torch.roll(grid_pos, **roll).reshape(g, 3, C)
        cids = torch.roll(grid_ids, **roll).reshape(g, C)
        d = slot_pos[:, :, :, None] - cand[:, :, None, :]
        d = d - lengths * torch.round(d / lengths)
        near = torch.sum(d * d, dim=1) < cutoff * cutoff
        both = real[:, :, None] & (cids < n_real)[:, None, :]
        if o == 13:
            both = both & ~eye
        excluded = torch.any(slot_excl[:, :, :, None] == cids[:, None, None, :],
                             dim=1)
        n_pair += int((both & ~excluded & near).sum())
        n_excl += int((both & excluded).sum())
    return n_pair // 2, n_excl // 2


def pair_bound(pc, energies, n_pair, n_excl, cell_kernel):
    """Bound of one pair-kernel call: the pairs within the cutoff (and, for
    the cell kernel, their minimum image and the excluded pairs'
    corrections; under LJPME the dispersion terms of both), and the slot
    tensors read and the outputs written once."""
    ops = n_pair * (PAIR_OPS + (PAIR_ENERGY_OPS if energies else 0))
    if pc.ljpme:
        ops += n_pair * (LJPME_PAIR_OPS
                         + (LJPME_PAIR_ENERGY_OPS if energies else 0))
    if cell_kernel:
        ops += n_pair * MIN_IMAGE_OPS
        ops += n_excl * (EXCL_OPS + (EXCL_ENERGY_OPS if energies else 0))
        if pc.ljpme:
            ops += n_excl * (LJPME_EXCL_OPS
                             + (LJPME_EXCL_ENERGY_OPS if energies else 0))
    g, C, nsub = pc.n_cells, pc.capacity, pc.nsub
    nbytes = (4 * g * C * (3 + 3 + 1 + 1 + pc.emax) + 4 * 2 * nsub * nsub
              + 4 * 9 + 4 * g * 3 * C
              + (4 * g * 2 * nsub * nsub if energies else 0))
    return bound(ops, nbytes)


def slice_energies(moments, nsub):
    """Slice energies (S, 2) in f64 from per-cell moments."""
    import torch
    m = moments.double().sum(0)
    return torch.stack([m[:, a, a] if a == b else m[:, a, b] + m[:, b, a]
                        for a, b in zip(*np.triu_indices(nsub))])


def pair_kernel_check(name, kernel, plain, args, pc, reps, cell_kernel):
    """A pair kernel against its plain twin on the same CUDA tensors
    (``args[9]`` is the energies flag): how the call is cut into blocks,
    forces within TOL_FORCE, slice energies within TOL_ENERGY, two launches
    equal to the bit, and CUDA-event times of both."""
    import torch
    from nonbondedslicing_tpu_torch.ops.cuda_direct import pair_launch_shape
    energies = args[9]
    shape = pair_launch_shape(pc, cell_kernel, energies)
    print(f"{name}: {shape['blocks']} blocks ({shape['row_blocks']} per "
          f"cell) of {shape['threads']} threads, {shape['shared_bytes']} "
          f"bytes of dynamic shared memory, {shape['tile_cells']} of the 27 "
          f"neighbour cells staged at a time")
    f_k, m_k = kernel(*args)
    f_p, m_p = plain(*args)
    f_k2, m_k2 = kernel(*args)
    torch.cuda.synchronize()
    check(torch.equal(f_k, f_k2) and (not energies or torch.equal(m_k, m_k2)),
          f"{name}: forces" + (" and moments" if energies else "")
          + " of two launches equal to the bit (no atomics)")
    err = float((f_k - f_p).abs().max())
    fmax = float(f_p.abs().max())
    check(err <= TOL_FORCE * (fmax + 1.0),
          f"{name}: forces max|dF| {err:.3e} <= {TOL_FORCE} * "
          f"(max|F| {fmax:.1f} + 1)")
    if energies:
        e_k, e_p = slice_energies(m_k, pc.nsub), slice_energies(m_p, pc.nsub)
        e_err = float((e_k - e_p).abs().max())
        emax = float(e_p.abs().max())
        check(e_err <= TOL_ENERGY * (emax + 1.0),
              f"{name}: slice energies max|dE| {e_err:.3e} <= "
              f"{TOL_ENERGY} * (max|E| {emax:.1f} + 1)")
    ms, plain_ms = timed_pair(lambda: kernel(*args), lambda: plain(*args),
                              reps)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def cpu_evaluation(plan, capacity, pos_np, box_np, gvals_np):
    """(total energy, forces, dE/dlambda) of one apply with energies on CPU
    tensors in float64 (the plain twins)."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN
    f64 = torch.float64
    data = engine_mod.plan_data(plan, device="cpu", dtype=f64)
    pos = torch.as_tensor(pos_np, dtype=f64)
    box = torch.as_tensor(box_np, dtype=f64)
    gvals = torch.as_tensor(gvals_np, dtype=f64)
    prepare, apply, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN, energies=True)
    e, f, _ = apply(pos, box, gvals, data, prepare(pos, box, gvals, data))
    energy = float(engine_mod.contract_energy(
        e, slice_lambdas(plan.lam_source, gvals)))
    return energy, f, engine_mod.parameter_derivatives(e, plan.deriv_mask)


def pme_kernel_checks(names, slot_pos, st, box, cfg, plan, lam_nn, reps,
                      dispersion=False):
    """The spread kernel, its double variant (energy evaluations) and the
    interpolation kernel against their plain twins on one path's slot
    tensors: the grid within TOL_GRID of its max and bitwise repeatable, the
    double grid within TOL_GRID64, the forces within TOL_FORCE; CUDA-event
    times and the bound of each, and their launches per call (the spreads'
    with their neighbour radius).  ``names`` are the three entries' names.
    With ``dispersion``, LJPME's pass: C6 weights on the dispersion grid
    with its convolution kernel (``lam_nn`` the vdW lambdas).  Returns their
    results."""
    import torch
    from nonbondedslicing_tpu_torch.ops import cuda_pme
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors
    spread_name, spread64_name, interp_name = names
    recip = recip_box_vectors(box)
    grid_shape = cfg["dispersion_grid" if dispersion else "pme_grid"]
    weight = st["slot_c6" if dispersion else "slot_q"]
    nsub = lam_nn.shape[0]
    g, _, C = slot_pos.shape
    n_grid = nsub * int(np.prod(grid_shape))
    n_charged = int((weight != 0).sum())
    spread_args = (slot_pos, weight, st["slot_sub"], recip, grid_shape, nsub)
    radius = cuda_pme.spread_radius(grid_shape, cfg["counts"], cfg["skin"],
                                    plan.box0)
    kw = dict(dispersion=dispersion)
    spread_kw = dict(kw, lattice=cfg["counts"], radius=radius)

    def kernel():
        return cuda_pme.pme_spread(*spread_args, **spread_kw)

    grid_k = kernel()
    grid_p = cuda_pme.pme_spread_plain(*spread_args)
    torch.cuda.synchronize()
    err = float((grid_k - grid_p).abs().max())
    gmax = float(grid_p.abs().max())
    check(err <= TOL_GRID * gmax, f"{spread_name}: grid max|d| {err:.3e} <= "
          f"{TOL_GRID} * max {gmax:.3f}")
    check(torch.equal(grid_k, kernel()),
          f"{spread_name}: bitwise repeatable (fixed-point sums)")
    ms, plain_ms = timed_pair(kernel,
                              lambda: cuda_pme.pme_spread_plain(*spread_args),
                              reps)
    print(f"{spread_name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    spread = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  radius=list(radius))
    spread["bound_ms"], spread["bound_by"] = bound(
        n_charged * SPREAD_OPS + n_grid * GRID_POINT_OPS,
        4 * g * C * 5 + 4 * 9 + 4 * n_grid)
    spread.update(against_parent(spread_name, "pme_spread", kernel, None,
                                 reps))

    spread64_args = (slot_pos, weight, st["slot_sub"],
                     recip_box_vectors(box.double()), grid_shape, nsub)

    def kernel64():
        return cuda_pme.pme_spread(*spread64_args, double=True, **spread_kw)

    grid_k64 = kernel64()
    grid_p64 = cuda_pme.pme_spread_plain(*spread64_args, double=True)
    torch.cuda.synchronize()
    err = float((grid_k64 - grid_p64).abs().max())
    gmax = float(grid_p64.abs().max())
    check(grid_k64.dtype == torch.float64 and err <= TOL_GRID64 * gmax,
          f"{spread64_name}: grid max|d| {err:.3e} <= {TOL_GRID64} * max "
          f"{gmax:.3f}")
    ms, plain_ms = timed_pair(
        kernel64,
        lambda: cuda_pme.pme_spread_plain(*spread64_args, double=True), reps)
    print(f"{spread64_name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    spread64 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    radius=list(radius))
    spread64["bound_ms"], spread64["bound_by"] = bound(
        n_charged * SPREAD_OPS + n_grid * GRID_POINT_OPS,
        4 * g * C * 5 + 8 * 9 + 8 * n_grid, PEAK_FP64_FLOPS)
    spread64.update(against_parent(spread64_name, "pme_spread_energies",
                                   kernel64, None, reps))

    if dispersion:
        eterm = pme_mod.dispersion_eterm_np(grid_shape, cfg["dpme_moduli"],
                                            plan.box0, plan.dispersion_alpha)
    else:
        eterm = pme_mod.coulomb_eterm_np(grid_shape, cfg["pme_moduli"],
                                         plan.box0, plan.ewald_alpha)
    eterm = torch.as_tensor(eterm, device=slot_pos.device).to(torch.float32)
    spec = torch.fft.rfftn(grid_k, dim=(1, 2, 3))
    phi = torch.fft.irfftn(
        torch.einsum("st,txyk->sxyk", lam_nn.to(spec.dtype), spec * eterm),
        s=tuple(grid_shape), dim=(1, 2, 3), norm="forward").contiguous()
    interp_args = (phi, slot_pos, weight, st["slot_sub"], recip)

    def interp_kernel():
        return cuda_pme.pme_interp(*interp_args, **kw)

    f_k = interp_kernel()
    f_p = cuda_pme.pme_interp_plain(*interp_args)
    torch.cuda.synchronize()
    err = float((f_k - f_p).abs().max())
    fmax = float(f_p.abs().max())
    check(err <= TOL_FORCE * (fmax + 1.0),
          f"{interp_name}: forces max|dF| {err:.3e} <= {TOL_FORCE} * "
          f"(max|F| {fmax:.1f} + 1)")
    check(torch.equal(f_k, interp_kernel()),
          f"{interp_name}: bitwise repeatable (fixed-order sums)")
    ms, plain_ms = timed_pair(interp_kernel,
                              lambda: cuda_pme.pme_interp_plain(*interp_args),
                              reps)
    print(f"{interp_name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    interp = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    interp["bound_ms"], interp["bound_by"] = bound(
        n_charged * INTERP_OPS,
        4 * n_grid + 4 * g * C * 5 + 4 * 9 + 4 * g * 3 * C)
    interp.update(against_parent(interp_name, "pme_interp", interp_kernel,
                                 None, reps))
    return {spread_name: spread, spread64_name: spread64, interp_name: interp}


def window_grid_index(grid_shape, bricks, nsub, device):
    """Flat int64 index into the +1-shifted grids (nsub, nx, ny, nz) of every
    window element (bx, by, bz, nsub, wx, wy, wz): window point u of brick b
    lies on grid line (b*p + u) mod n."""
    import torch
    from nonbondedslicing_tpu_torch.ops import pme_bricks
    lines = []
    for n, b, (p, w) in zip(grid_shape, bricks,
                            pme_bricks.brick_window(grid_shape, bricks)):
        lines.append((torch.arange(b, device=device)[:, None] * p
                      + torch.arange(w, device=device)[None, :]) % n)
    ix, iy, iz = lines                                   # (b, w) each
    nx, ny, nz = grid_shape
    s = torch.arange(nsub, device=device)
    return (((s[None, None, None, :, None, None, None] * nx
              + ix[:, None, None, None, :, None, None]) * ny
             + iy[None, :, None, None, None, :, None]) * nz
            + iz[None, None, :, None, None, None, :]).contiguous()


def window_kernel_checks(suffix, slot_pos, st, box, cfg, plan, lam_c_nn,
                         reps, parent=None):
    """The four kernels of the window pipeline against their plain twins on
    one path's slot tensors, regrouped brick-major: the windows within
    TOL_GRID of their max and bitwise repeatable, fold and extract equal to
    the bit, the forces within TOL_FORCE; CUDA-event times and the bound of
    each.  Then the two designs against each other: the folded windows,
    rolled back by one point, against the whole-grid spread (TOL_GRID of its
    max, each subset's charge to TOL_GRID_SUM: no point dropped), and the
    reciprocal forces of the two pipelines (TOL_FORCE), the window
    pipeline's bitwise repeatable.  The window spread's, the fold's,
    extract's and the window interpolation's entries also get their launches
    per call, the window interpolation's its bitwise repeatability, and
    (``parent``: the parent's library) extract's and the window
    interpolation's the parent design's time; extract must equal the
    parent's windows to the bit.  Returns the results by entry name."""
    import torch
    from nonbondedslicing_tpu_torch.ops import cuda_pme, pme_bricks
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    from nonbondedslicing_tpu_torch.ops.geometry import recip_box_vectors
    from nonbondedslicing_tpu_torch.utils.indexing import slice_subsets
    recip = recip_box_vectors(box)
    grid_shape, bricks, counts = cfg["pme_grid"], cfg["bricks"], cfg["counts"]
    nsub = lam_c_nn.shape[0]

    def to_bricks(x):
        return pme_bricks.cells_to_bricks(x, counts, bricks).contiguous()

    pos_b = to_bricks(slot_pos)
    q_b = to_bricks(st["slot_q"][:, None])[:, 0].contiguous()
    sub_b = to_bricks(st["slot_sub"][:, None])[:, 0].contiguous()
    gb, _, Cb = pos_b.shape
    n_grid = nsub * int(np.prod(grid_shape))
    n_charged = int((q_b != 0).sum())
    slot_bytes = 4 * gb * Cb * 5 + 4 * 9
    out = {}

    def record(kernel, err, kernel_fn, plain_fn, ops, nbytes,
               library_fn=None):
        ms, plain_ms = timed_pair(kernel_fn, plain_fn, reps)
        library_ms = library_fn and cuda_ms(library_fn, reps)
        print(f"{kernel}{suffix}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + (f", library call {library_ms:.4f} ms" if library_fn else ""))
        bound_ms, bound_by = bound(ops, nbytes)
        out[kernel + suffix] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)

    spread_args = (pos_b, q_b, sub_b, recip, grid_shape, bricks, nsub)
    W_k = cuda_pme.pme_spread_windows(*spread_args)
    W_p = cuda_pme.pme_spread_windows_plain(*spread_args)
    torch.cuda.synchronize()
    n_window = W_k.numel()
    err = float((W_k - W_p).abs().max())
    wmax = float(W_p.abs().max())
    check(err <= TOL_GRID * wmax, f"pme_spread_windows{suffix}: windows "
          f"{tuple(W_k.shape)} max|d| {err:.3e} <= {TOL_GRID} * max "
          f"{wmax:.3f}")
    check(torch.equal(W_k, cuda_pme.pme_spread_windows(*spread_args)),
          f"pme_spread_windows{suffix}: bitwise repeatable (fixed-point "
          f"sums)")
    record("pme_spread_windows", err,
           lambda: cuda_pme.pme_spread_windows(*spread_args),
           lambda: cuda_pme.pme_spread_windows_plain(*spread_args),
           n_charged * SPREAD_OPS, slot_bytes + 4 * n_window)
    out["pme_spread_windows" + suffix].update(against_parent(
        "pme_spread_windows" + suffix, "pme_spread_windows",
        lambda: cuda_pme.pme_spread_windows(*spread_args), None, reps))

    shifted = cuda_pme.pme_fold(W_k)
    check(torch.equal(shifted, cuda_pme.pme_fold_plain(W_k)),
          f"pme_fold{suffix}: grid {tuple(shifted.shape)} equal to the plain "
          f"twin's to the bit")
    check(torch.equal(shifted, cuda_pme.pme_fold(W_k)),
          f"pme_fold{suffix}: bitwise repeatable")
    # the one-call library versions, timed here and used nowhere in the
    # port: fold is one index_add_ of the window elements at their grid
    # points (float atomics, so not to the bit), extract one take
    w_index = window_grid_index(grid_shape, bricks, nsub, slot_pos.device)

    def library_fold():
        return torch.zeros(n_grid, device=W_k.device).index_add_(
            0, w_index.reshape(-1), W_k.reshape(-1)).reshape(shifted.shape)

    err = float((library_fold() - shifted).abs().max())
    smax = float(shifted.abs().max())
    check(err <= TOL_GRID * smax, f"pme_fold{suffix}: one index_add_ gives "
          f"the same grid, max|d| {err:.3e} <= {TOL_GRID} * max {smax:.3f}")
    record("pme_fold", 0.0, lambda: cuda_pme.pme_fold(W_k),
           lambda: cuda_pme.pme_fold_plain(W_k),
           (n_window - n_grid) * FOLD_OPS, 4 * n_window + 4 * n_grid,
           library_fold)
    out["pme_fold" + suffix].update(against_parent(
        "pme_fold" + suffix, "pme_fold", lambda: cuda_pme.pme_fold(W_k),
        None, reps))

    eterm = torch.as_tensor(pme_mod.coulomb_eterm_np(
        grid_shape, cfg["pme_moduli"], plan.box0, plan.ewald_alpha),
        device=slot_pos.device).to(torch.float32)
    spec = torch.fft.rfftn(shifted, dim=(1, 2, 3))
    phi = torch.fft.irfftn(
        torch.einsum("st,txyk->sxyk", lam_c_nn.to(spec.dtype), spec * eterm),
        s=tuple(grid_shape), dim=(1, 2, 3), norm="forward").contiguous()
    W_phi = cuda_pme.pme_extract(phi, bricks)
    check(torch.equal(W_phi, cuda_pme.pme_extract_plain(phi, bricks)),
          f"pme_extract{suffix}: windows equal to the plain twin's to the bit")
    check(torch.equal(W_phi, torch.take(phi, w_index)),
          f"pme_extract{suffix}: one take gives the same windows to the bit")
    record("pme_extract", 0.0, lambda: cuda_pme.pme_extract(phi, bricks),
           lambda: cuda_pme.pme_extract_plain(phi, bricks), 0,
           4 * n_grid + 4 * n_window, lambda: torch.take(phi, w_index))
    extract = out["pme_extract" + suffix]
    extract.update(against_parent(
        "pme_extract" + suffix, "pme_extract",
        lambda: cuda_pme.pme_extract(phi, bricks),
        parent and (lambda: parent_extract(parent, phi, bricks)), reps))
    if parent is not None:
        check(extract["equals_parent"], f"pme_extract{suffix}: windows equal "
              f"to the parent's to the bit")

    interp_args = (W_phi, pos_b, q_b, sub_b, recip)
    f_k = cuda_pme.pme_interp_windows(*interp_args)
    f_p = cuda_pme.pme_interp_windows_plain(*interp_args)
    torch.cuda.synchronize()
    err = float((f_k - f_p).abs().max())
    fmax = float(f_p.abs().max())
    check(err <= TOL_FORCE * (fmax + 1.0),
          f"pme_interp_windows{suffix}: forces max|dF| {err:.3e} <= "
          f"{TOL_FORCE} * (max|F| {fmax:.1f} + 1)")
    check(torch.equal(f_k, cuda_pme.pme_interp_windows(*interp_args)),
          f"pme_interp_windows{suffix}: bitwise repeatable (fixed-order sums)")
    record("pme_interp_windows", err,
           lambda: cuda_pme.pme_interp_windows(*interp_args),
           lambda: cuda_pme.pme_interp_windows_plain(*interp_args),
           n_charged * INTERP_OPS,
           4 * n_window + slot_bytes + 4 * gb * 3 * Cb)
    out["pme_interp_windows" + suffix].update(against_parent(
        "pme_interp_windows" + suffix, "pme_interp_windows",
        lambda: cuda_pme.pme_interp_windows(*interp_args),
        parent and (lambda: parent_interp_windows(parent, *interp_args)),
        reps))

    # the two designs against each other
    stencil_kw = dict(lattice=counts, radius=cuda_pme.spread_radius(
        grid_shape, counts, cfg["skin"], plan.box0))
    grid_s = cuda_pme.pme_spread(slot_pos, st["slot_q"], st["slot_sub"],
                                 recip, grid_shape, nsub, **stencil_kw)
    grid_w = torch.roll(shifted, (-1, -1, -1), (1, 2, 3))
    err = float((grid_w - grid_s).abs().max())
    gmax = float(grid_s.abs().max())
    check(err <= TOL_GRID * gmax, f"grid pipeline{suffix}: folded windows vs "
          f"whole-grid spread max|d| {err:.3e} <= {TOL_GRID} * max {gmax:.3f}")
    sum_w = grid_w.double().sum(dim=(1, 2, 3))
    sum_s = grid_s.double().sum(dim=(1, 2, 3))
    rel = float(((sum_w - sum_s).abs() / sum_s.abs().clamp(min=1.0)).max())
    check(rel <= TOL_GRID_SUM, f"grid pipeline{suffix}: subset charges on "
          f"the two grids agree to {rel:.3e} <= {TOL_GRID_SUM} (no point "
          f"dropped)")
    kw = dict(grid_shape=grid_shape, eterm=eterm,
              slice_subset_pairs=slice_subsets(nsub), energies=False)
    _, f_s = cuda_pme.pme_reciprocal(slot_pos, st["slot_q"], st["slot_sub"],
                                     box, lam_c_nn, **kw, **stencil_kw)
    f_w = [pme_bricks.bricks_to_cells(cuda_pme.pme_reciprocal(
        pos_b, q_b, sub_b, box, lam_c_nn, pipeline="grid", bricks=bricks,
        **kw)[1].transpose(1, 2), counts, bricks).transpose(1, 2)
        for _ in range(2)]
    err = float((f_w[0] - f_s).abs().max())
    fmax = float(f_s.abs().max())
    check(err <= TOL_FORCE * (fmax + 1.0),
          f"grid pipeline{suffix}: reciprocal forces vs the stencil "
          f"pipeline's max|dF| {err:.3e} <= {TOL_FORCE} * (max|F| "
          f"{fmax:.1f} + 1)")
    check(torch.equal(f_w[0], f_w[1]),
          f"grid pipeline{suffix}: reciprocal forces bitwise repeatable")
    return out


def evaluation_check(label, plan, capacity, apply, state, pos, box, gvals,
                     data, pos_np, box_np, gvals_np, pme_pipeline="stencil",
                     reference=None):
    """One apply with energies in f32 on the card against the same code on
    CPU tensors in f64 (``cpu_evaluation`` of the numpy inputs, or the
    ``reference`` an earlier call returned): total energy, forces and every
    dE/dlambda; and the forces of one force-only apply, the variant every MD
    inner step runs, through ``pme_pipeline``.  Returns the CPU result."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN
    t0 = time.time()
    e_g, f_g, _ = apply(pos, box, gvals, data, state)
    prepare_f, apply_f, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
        energies=False, pme_pipeline=pme_pipeline)
    _, f_fo, _ = apply_f(pos, box, gvals, data,
                         prepare_f(pos, box, gvals, data))
    torch.cuda.synchronize()
    E_c, f_c, d_c = reference or cpu_evaluation(plan, capacity, pos_np,
                                                box_np, gvals_np)
    E_g = float(engine_mod.contract_energy(
        e_g.cpu(), slice_lambdas(plan.lam_source,
                                 torch.as_tensor(gvals_np, dtype=torch.float64))))
    rel_e = abs(E_g - E_c) / abs(E_c)
    f_err = float((f_g.cpu().double() - f_c).abs().max()) / float(
        f_c.abs().max())
    d_g = engine_mod.parameter_derivatives(e_g.cpu(), plan.deriv_mask)
    rel_d = float(((d_g - d_c).abs() / d_c.abs().clamp(min=1.0)).max())
    print(f"{label}: E card f32 {E_g:.6f}, CPU f64 {E_c:.6f} kJ/mol; "
          f"dE/dlambda card {d_g.tolist()}, CPU {d_c.tolist()} "
          f"({time.time() - t0:.1f} s)")
    check(math.isfinite(E_g) and rel_e <= TOL_EVAL_ENERGY,
          f"{label}: relative energy error {rel_e:.3e} <= {TOL_EVAL_ENERGY}")
    check(f_err <= TOL_EVAL_FORCE,
          f"{label}: force error {f_err:.3e} of max|F| <= {TOL_EVAL_FORCE}")
    f_err = float((f_fo.cpu().double() - f_c).abs().max()) / float(
        f_c.abs().max())
    check(f_err <= TOL_EVAL_FORCE,
          f"{label}: force-only apply, force error {f_err:.3e} of max|F| <= "
          f"{TOL_EVAL_FORCE}")
    check(rel_d <= TOL_EVAL_DERIV,
          f"{label}: relative dE/dlambda error {rel_d:.3e} <= "
          f"{TOL_EVAL_DERIV}")
    return E_c, f_c, d_c


def run_md(make_run, capacity, p, v, box, gvals, data, n_timed, guard_exc):
    """One warm-up chunk and ``n_timed`` timed chunks of CHUNK_STEPS steps,
    with bench.py's retries: capacity + 8 after a cell overflow, K halved
    after a skin violation (the chunk is then run again from its start).
    ``make_run(capacity, reuse_steps)`` builds the MD step.  Returns (p, v,
    energy, seconds per chunk, the step's config)."""
    import torch
    state = {"run": None, "capacity": capacity, "reuse": None}

    def run_chunk(p, v):
        while True:
            if state["run"] is None:
                state["run"] = make_run(state["capacity"], state["reuse"])
                state["reuse"] = state["run"].config["reuse_steps"]
            try:
                return state["run"](p, v, box, gvals, data, CHUNK_STEPS)
            except guard_exc as exc:
                if "capacity overflow" in str(exc):
                    state["capacity"] += 8
                elif "skin violation" in str(exc) and state["reuse"] > 1:
                    state["reuse"] = max(1, state["reuse"] // 2)
                else:
                    raise
                state["run"] = None
                print(f"md: retry after guard: {exc}")

    chunk_s = []
    for _ in range(1 + n_timed):
        torch.cuda.synchronize()
        t0 = time.time()
        p, v, energy = run_chunk(p, v)
        torch.cuda.synchronize()
        chunk_s.append(time.time() - t0)
    return p, v, energy, chunk_s, state["run"].config


def md_checks(label, p, v, energy, masses, first_water, n_dof, chunk_s,
              n_atoms, card):
    """Energy finite, water constraints, temperature; prints the median and
    range of ms/step and ns/day of the timed chunks and returns their sorted
    ms/step."""
    e_md = float(energy)
    check(math.isfinite(e_md), f"{label}: energy {e_md:.3f} kJ/mol is finite")
    p64 = p.double().cpu().numpy()[first_water:].reshape(-1, 3, 3)
    c_err = 0.0
    for (a, b), d in (((0, 1), D_OH), ((0, 2), D_OH), ((1, 2), D_HH)):
        c_err = max(c_err, float(np.abs(np.linalg.norm(
            p64[:, a] - p64[:, b], axis=-1) - d).max()))
    check(c_err <= TOL_CONSTRAINT,
          f"{label}: max |constraint distance - target| {c_err:.3e} nm <= "
          f"{TOL_CONSTRAINT}")
    v64 = v.double().cpu().numpy()
    temp = float(np.sum(masses[:, None] * v64 * v64)) / (KB * n_dof)
    check(270.0 <= temp <= 330.0,
          f"{label}: temperature {temp:.1f} K in 300 +- 30")
    ms = sorted(1000.0 * t / CHUNK_STEPS for t in chunk_s[1:])
    ms_step = float(np.median(ms))
    ns_day = DT_PS * 1e-3 * 86400.0 / (1e-3 * ms_step)
    print(f"{label}: {ms_step:.3f} ms/step median of {len(ms)} x "
          f"{CHUNK_STEPS} steps (range {ms[0]:.3f}-{ms[-1]:.3f}), "
          f"{ns_day:.2f} ns/day at {DT_PS} ps ({n_atoms} atoms, {card})")
    return ms


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

    # ---- 2. build (and, beside it, the parent's kernels)
    t0 = time.time()
    parent_procs = start_parent_build()
    LIBRARY.build()
    print(f"build: {LIBRARY.path.name} in {time.time() - t0:.1f} s "
          f"(nvcc {LIBRARY.build_seconds:.1f} s)")
    parent = load_parent(parent_procs)
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip())

    def reset_launches():
        for counts in (cuda_direct.LAUNCHES, cuda_pme.LAUNCHES):
            for key in counts:
                counts[key] = 0

    # ---- system, plan, state
    t0 = time.time()
    system, force, box_len, constraints = build_system(nbt)
    plan = plan_mod.build_plan(force, system)
    n = plan.num_particles
    blob = np.load(STATE_FILE)
    pos_np = np.asarray(blob["positions"], dtype=np.float64)
    vel_np = np.asarray(blob["velocities"], dtype=np.float64)
    masses = np.tile(WATER_MASSES, N_MOLECULES)
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

    n_pair, _ = pair_counts(slot_pos, st["table"], st["sexcl"], box,
                            plan.cutoff, n, pc.counts)
    print(f"bound inputs: {n_pair} pairs within the cutoff")
    for name, energies in (("pair_column", False),
                           ("pair_column_energies", True)):
        args = (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
                st["sexcl"], lam_c_nn, lam_v_nn, box, pc, energies, n)
        results[name] = pair_kernel_check(
            name, cuda_direct.pair_column, cuda_direct.pair_column_plain,
            args, pc, reps, cell_kernel=False)
        results[name]["bound_ms"], results[name]["bound_by"] = pair_bound(
            pc, energies, n_pair, 0, cell_kernel=False)

    results.update(pme_kernel_checks(
        ("pme_spread", "pme_spread_energies", "pme_interp"), slot_pos, st,
        box, cfg, plan, lam_c_nn, reps))

    # ---- 4. whole evaluation: card f32 vs CPU f64 (plain twins)
    reference = evaluation_check("evaluation", plan, capacity, apply, st, pos,
                                 box, gvals, data, pos_np, box_np, np.ones(2))

    # ---- 5. MD: the benchmark path, counted
    def make_bench_run(cap, reuse):
        return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints)

    reset_launches()
    p, v, energy, chunk_s, config = run_md(
        make_bench_run, capacity, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        TIMED_CHUNKS, nbt.OpenMMException)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, timed "
          f"chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("md", "rigid", launches)
    ms_stencil = md_checks("md", p, v, energy, masses, 0,
                           3 * n - 3 * N_MOLECULES - 3, chunk_s, n, card)
    run_launches = {"rigid": launches}

    # ---- 6. the solute path: the min-image cell kernel
    t0 = time.time()
    (s_system, s_force, s_pos_np, s_masses, s_constraints, s_bonds,
     kept) = build_solute_system(nbt, pos_np, box_len)
    s_plan = plan_mod.build_plan(s_force, s_system)
    s_n = s_plan.num_particles
    n_waters = (s_n - SOLUTE_SITES) // 3
    s_counts = neighbors.choose_cell_grid(s_plan.box0, s_plan.cutoff, s_n,
                                          target_skin=DEFAULT_SKIN)[0]
    s_occ = max_cell_occupancy(s_pos_np, s_plan.box0, s_counts)
    s_capacity = max(8, int(np.ceil((s_occ + 8) / 4) * 4))
    print(f"solute: {s_n} atoms ({SOLUTE_SITES} chain sites, {n_waters} "
          f"waters; {N_MOLECULES - n_waters} waters within {CAVITY_NM} nm "
          f"of a site removed), cells {s_counts}, capacity {s_capacity}, "
          f"emax {s_plan.exclusion_list.shape[1]}, {len(s_bonds)} bonds, "
          f"built in {time.time() - t0:.1f} s")
    # the fused exclusion corrections reach only the 27 neighbour cells
    width = float(np.min(np.diag(s_plan.box0) / np.asarray(s_counts)))
    span = exclusion_span(s_pos_np, s_plan.exclusion_pairs, box_len)
    check(span < width, f"solute: excluded pairs span at most {span:.4f} nm "
          f"< one cell width {width:.4f} nm")
    s_vel_np = solute_velocities(vel_np, kept)

    s_prepare, s_apply, s_cfg = fused_mod.make_fused_engine(
        s_plan, cell_capacity=s_capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    s_pc = s_cfg["pair"]
    print(f"solute shapes: cells {s_pc.counts} x {s_pc.capacity} slots, "
          f"nsub {s_pc.nsub}, emax {s_pc.emax}, PME grid "
          f"{s_cfg['pme_grid']}, lambdas {s_plan.global_defaults.tolist()}")
    s_data = engine_mod.plan_data(s_plan, device=dev, dtype=f32)
    s_pos = torch.as_tensor(s_pos_np, device=dev).to(f32)
    s_gvals = torch.as_tensor(s_plan.global_defaults, device=dev).to(f32)
    s_st = s_prepare(s_pos, box, s_gvals, s_data)
    check(int(s_st["overflow"]) == 0, "no cell overflow at the solute state")
    g, C = s_pc.n_cells, s_pc.capacity
    s_slot_pos = (torch.cat([s_pos, s_pos.new_zeros((1, 3))])[s_st["slots"]]
                  .reshape(g, C, 3).transpose(1, 2)
                  + s_st["padfix3"]).contiguous()
    s_lam = slice_lambdas(s_plan.lam_source, s_gvals)
    s_sl_tab = torch.as_tensor(s_plan.slice_table, dtype=torch.int64,
                               device=dev)
    s_n_pair, s_n_excl = pair_counts(s_slot_pos, s_st["table"],
                                     s_st["sexcl"], box, s_plan.cutoff, s_n,
                                     s_pc.counts)
    check(s_n_excl == len(s_plan.exclusion_pairs),
          f"solute: all {len(s_plan.exclusion_pairs)} excluded pairs lie in "
          f"the 27-cell neighbourhoods ({s_n_excl} found)")
    print(f"bound inputs: {s_n_pair} pairs within the cutoff, {s_n_excl} "
          f"excluded pairs")
    s_lam_c_nn = s_lam[:, 0][s_sl_tab].contiguous()
    for name, energies in (("pair_cell", False),
                           ("pair_cell_energies", True)):
        args = (s_slot_pos, s_st["slot_par"], s_st["slot_sub"],
                s_st["table"], s_st["sexcl"], s_lam_c_nn,
                s_lam[:, 1][s_sl_tab].contiguous(), box, s_pc, energies, s_n)
        results[name] = pair_kernel_check(
            name, cuda_direct.pair_cell, cuda_direct.pair_cell_plain, args,
            s_pc, reps, cell_kernel=True)
        results[name]["bound_ms"], results[name]["bound_by"] = pair_bound(
            s_pc, energies, s_n_pair, s_n_excl, cell_kernel=True)
    results.update(pme_kernel_checks(
        ("pme_spread_solute", "pme_spread_energies_solute",
         "pme_interp_solute"), s_slot_pos, s_st, box,
        s_cfg, s_plan, s_lam_c_nn, reps))

    s_reference = evaluation_check(
        "solute evaluation", s_plan, s_capacity, s_apply, s_st, s_pos, box,
        s_gvals, s_data, s_pos_np, box_np, s_plan.global_defaults)
    # the part of that gap no f32 evaluation can close: the solute's weak
    # coupling makes dE/dlambda_elec a few kJ/mol
    _, _, d_rounded = cpu_evaluation(
        s_plan, s_capacity, s_pos.double().cpu().numpy(),
        box.double().cpu().numpy(), s_gvals.double().cpu().numpy())
    print(f"solute evaluation: rounding the inputs to f32 moves dE/dlambda "
          f"of the f64 evaluation by {(d_rounded - s_reference[2]).tolist()} "
          f"kJ/mol")

    def make_solute_run(cap, reuse):
        return make_md_step(s_plan, s_masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=s_constraints, bonds=s_bonds)

    reset_launches()
    p, v, energy, chunk_s, config = run_md(
        make_solute_run, s_capacity, s_pos,
        torch.as_tensor(s_vel_np, device=dev).to(f32), box, s_gvals, s_data,
        SOLUTE_TIMED_CHUNKS, nbt.OpenMMException)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"solute md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("solute md", "solute", launches)
    span = exclusion_span(p.double().cpu().numpy(), s_plan.exclusion_pairs,
                          box_len)
    check(span < width, f"solute md: excluded pairs span at most "
          f"{span:.4f} nm < one cell width {width:.4f} nm after the run")
    md_checks("solute md", p, v, energy, s_masses, SOLUTE_SITES,
              3 * s_n - 3 * n_waters - 3, chunk_s, s_n, card)
    run_launches["solute"] = launches

    # ---- 7. the brick-window PME pipeline (pme_pipeline="grid")
    results.update(window_kernel_checks("", slot_pos, st, box, cfg, plan,
                                        lam_c_nn, reps, parent=parent))
    results.update(window_kernel_checks("_solute", s_slot_pos, s_st, box,
                                        s_cfg, s_plan, s_lam_c_nn, reps,
                                        parent=parent))
    prepare_g, apply_g, cfg_g = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
        energies=True, pme_pipeline="grid")
    print(f"grid pipeline: bricks {cfg_g['bricks']} of the PME grid "
          f"{cfg_g['pme_grid']}")
    evaluation_check("grid evaluation", plan, capacity, apply_g,
                     prepare_g(pos, box, gvals, data), pos, box, gvals, data,
                     pos_np, box_np, np.ones(2), pme_pipeline="grid",
                     reference=reference)

    def make_grid_run(cap, reuse):
        return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints, pme_pipeline="grid")

    reset_launches()
    p, v, energy, chunk_s, config = run_md(
        make_grid_run, capacity, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        GRID_TIMED_CHUNKS, nbt.OpenMMException)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"grid md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("grid md", "rigid_grid", launches)
    # one pair kernel and one of each window kernel per evaluation, one
    # double spread per evaluation with energies
    n_eval = launches["pair_column"] + launches["pair_column_energies"]
    check(all(launches[k] == n_eval for k in WINDOW_KERNELS)
          and n_eval >= (1 + GRID_TIMED_CHUNKS) * (CHUNK_STEPS + 1),
          f"grid md: each window kernel launched once per evaluation "
          f"({n_eval}: every step and once per run())")
    check(launches["pme_spread_energies"] == launches["pair_column_energies"],
          f"grid md: the double spread launched once per run() "
          f"({launches['pme_spread_energies']})")
    ms_grid = md_checks("grid md", p, v, energy, masses, 0,
                        3 * n - 3 * N_MOLECULES - 3, chunk_s, n, card)
    print(f"pipelines: stencil {np.median(ms_stencil):.3f} ms/step (range "
          f"{ms_stencil[0]:.3f}-{ms_stencil[-1]:.3f}), grid "
          f"{np.median(ms_grid):.3f} ms/step (range {ms_grid[0]:.3f}-"
          f"{ms_grid[-1]:.3f}) ({n} atoms, {card})")
    run_launches["rigid_grid"] = launches

    # the solute box: one evaluation with energies and one force-only
    s_prepare_g, s_apply_g, _ = fused_mod.make_fused_engine(
        s_plan, cell_capacity=s_capacity, target_skin=DEFAULT_SKIN,
        energies=True, pme_pipeline="grid")
    s_st_g = s_prepare_g(s_pos, box, s_gvals, s_data)
    reset_launches()
    evaluation_check("solute grid evaluation", s_plan, s_capacity, s_apply_g,
                     s_st_g, s_pos, box, s_gvals, s_data, s_pos_np, box_np,
                     s_plan.global_defaults, pme_pipeline="grid",
                     reference=s_reference)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"solute grid evaluation: launches {launches}")
    check_launches("solute grid evaluation", "solute_grid", launches)
    run_launches["solute_grid"] = launches

    # ---- 8. LJPME: the dispersion terms of B1 and B4, the dispersion pass
    # of B2 and B3
    t0 = time.time()
    l_system, l_force, _, _ = build_system(nbt, "LJPME")
    l_plan = plan_mod.build_plan(l_force, l_system)
    l_prepare, l_apply, l_cfg = fused_mod.make_fused_engine(
        l_plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    l_pc = l_cfg["pair"]
    print(f"ljpme: dispersion alpha {l_plan.dispersion_alpha:.4f}, grid "
          f"{l_plan.dispersion_grid} aligned to {l_cfg['dispersion_grid']}, "
          f"PME grid {l_cfg['pme_grid']}, skin {l_cfg['skin']:.4f} nm, "
          f"built in {time.time() - t0:.1f} s")
    check(l_pc.ljpme and l_cfg["skin"] == cfg["skin"],
          f"ljpme: the pair kernels take LJPME; the skin is PME's "
          f"{cfg['skin']:.4f} nm (two dispersion-grid spacings do not bind)")
    try:
        fused_mod.make_fused_engine(l_plan, cell_capacity=capacity,
                                    target_skin=DEFAULT_SKIN,
                                    pme_pipeline="grid")
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check("stencil" in refused, "ljpme: the window pipeline refuses 5 "
          "dispersion-grid points a brick and names the default one")
    l_data = engine_mod.plan_data(l_plan, device=dev, dtype=f32)
    l_st = l_prepare(pos, box, gvals, l_data)
    check(torch.equal(l_st["slots"], st["slots"]),
          "ljpme: the benchmark's slot table")
    for name, energies in (("pair_column_ljpme", False),
                           ("pair_column_ljpme_energies", True)):
        args = (slot_pos, l_st["slot_par"], l_st["slot_sub"], l_st["table"],
                l_st["sexcl"], lam_c_nn, lam_v_nn, box, l_pc, energies, n)
        results[name] = pair_kernel_check(
            name, cuda_direct.pair_column, cuda_direct.pair_column_plain,
            args, l_pc, reps, cell_kernel=False)
        results[name]["bound_ms"], results[name]["bound_by"] = pair_bound(
            l_pc, energies, n_pair, 0, cell_kernel=False)
    results.update(pme_kernel_checks(DISPERSION_KERNELS, slot_pos, l_st, box,
                                     l_cfg, l_plan, lam_v_nn, reps,
                                     dispersion=True))
    evaluation_check("ljpme evaluation", l_plan, capacity, l_apply, l_st,
                     pos, box, gvals, l_data, pos_np, box_np, np.ones(2))

    def make_ljpme_run(cap, reuse):
        return make_md_step(l_plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints)

    reset_launches()
    p, v, energy, chunk_s, config = run_md(
        make_ljpme_run, capacity, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, l_data,
        LJPME_TIMED_CHUNKS, nbt.OpenMMException)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"ljpme md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("ljpme md", "rigid_ljpme", launches)
    check(all(launches[k + "_dispersion" + e] == launches[k + e]
              for k, e in (("pme_spread", ""), ("pme_spread", "_energies"),
                           ("pme_interp", ""))),
          "ljpme md: the dispersion pass launched with every Coulomb pass "
          f"({launches['pme_spread_dispersion']} spreads)")
    ms_ljpme = md_checks("ljpme md", p, v, energy, masses, 0,
                         3 * n - 3 * N_MOLECULES - 3, chunk_s, n, card)
    print(f"ljpme: {np.median(ms_ljpme):.3f} ms/step against PME's "
          f"{np.median(ms_stencil):.3f} in this run ({n} atoms, {card})")
    run_launches["rigid_ljpme"] = launches

    # the solute box under LJPME: B4's dispersion terms and back-out
    t0 = time.time()
    ls_out = build_solute_system(nbt, pos_np, box_len, "LJPME")
    ls_plan = plan_mod.build_plan(ls_out[1], ls_out[0])
    ls_prepare, ls_apply, ls_cfg = fused_mod.make_fused_engine(
        ls_plan, cell_capacity=s_capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    ls_pc = ls_cfg["pair"]
    ls_data = engine_mod.plan_data(ls_plan, device=dev, dtype=f32)
    ls_st = ls_prepare(s_pos, box, s_gvals, ls_data)
    print(f"solute ljpme: dispersion grid {ls_cfg['dispersion_grid']}, "
          f"built in {time.time() - t0:.1f} s")
    check(ls_pc.ljpme and torch.equal(ls_st["slots"], s_st["slots"]),
          "solute ljpme: the cell kernel under LJPME, the solute's slot table")
    s_lam_v_nn = s_lam[:, 1][s_sl_tab].contiguous()
    for name, energies in (("pair_cell_ljpme", False),
                           ("pair_cell_ljpme_energies", True)):
        args = (s_slot_pos, ls_st["slot_par"], ls_st["slot_sub"],
                ls_st["table"], ls_st["sexcl"], s_lam_c_nn, s_lam_v_nn, box,
                ls_pc, energies, s_n)
        results[name] = pair_kernel_check(
            name, cuda_direct.pair_cell, cuda_direct.pair_cell_plain, args,
            ls_pc, reps, cell_kernel=True)
        results[name]["bound_ms"], results[name]["bound_by"] = pair_bound(
            ls_pc, energies, s_n_pair, s_n_excl, cell_kernel=True)
    results.update(pme_kernel_checks(
        tuple(k + "_solute" for k in DISPERSION_KERNELS), s_slot_pos, ls_st,
        box, ls_cfg, ls_plan, s_lam_v_nn, reps, dispersion=True))
    reset_launches()
    evaluation_check("solute ljpme evaluation", ls_plan, s_capacity,
                     ls_apply, ls_st, s_pos, box, s_gvals, ls_data, s_pos_np,
                     box_np, ls_plan.global_defaults)
    launches = dict(cuda_direct.LAUNCHES, **cuda_pme.LAUNCHES)
    print(f"solute ljpme evaluation: launches {launches}")
    check_launches("solute ljpme evaluation", "solute_ljpme", launches)
    run_launches["solute_ljpme"] = launches
    print(f"total: {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=name, path=path, route="cuda",
             source="nonbondedslicing_tpu_torch/" + KERNELS[kernel][0],
             replaces=KERNELS[kernel][1],
             launches=run_launches[run][kernel],
             **{"library_ms": None, **results[name]})
        for name, kernel, path, run in ENTRIES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
