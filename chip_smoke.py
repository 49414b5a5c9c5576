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
   kernel.  make_md_step replays one CUDA graph per K-step window, so the
   MD runs of phases 5-8 and 10 print, beside the kernels the card ran a
   step, the host's launch calls of them a step (graph replays, and the
   kernels launched outside a graph), and check that the force-only pair
   kernel ran once a step and its energies variant once a run();
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
   and dE/dlambda_elec included), counted; no MD chunks;
9. the CUDA graph against the eager body (``run.eager``, the same window
   without the graph): from the state of one captured window, two windows
   of K steps each way, the same kernel launches counted; on the rigid box
   (under PME, under LJPME and through pme_pipeline="grid") and on the
   solute box positions, velocities and the energy equal to the bit;
   then 200-step chunks of both timed in turns;
10. mixed precision (float64 positions) on the benchmark box: one warm-up
   chunk and three timed chunks with phase 5's checks; then the NVE pair,
   single and mixed, each 20 chunks of 100 steps from the benchmark state,
   the drift of PE + KE from a linear fit; mixed must drift less;
11. the generic engine, ``ops/engine.make_compute`` (evaluations only): the
   rigid box under CutoffPeriodic, Ewald, PME and LJPME and the solute box
   under PME and LJPME, each in float32 on the card through the kernel
   route (csrc/pair_cell.cu on a slot table built per call: reaction-field
   mode under CutoffPeriodic, Ewald mode otherwise): its launches (the
   energies variant once, nothing else), overflow 0, the excluded pairs'
   span under one cell, against the same make_compute in float64 on the
   card (the plain cell list and the generic exclusion corrections, no
   kernel) with phase 4's gates (under the reaction field, whose force
   jumps at the cutoff, the atoms with a pair within 1e-6 nm of it are
   held to the jump instead); pair_cell against its twin at these shapes
   in both modes and under LJPME; the CUDA-event ms of one call per method
   and pair_cell's share; the rigid PME box against the fused engine (B4
   against B1, both float32) with the same gates; direct space alone plus
   the reciprocal part alone against one call; NoCutoff and
   CutoffNonPeriodic (all pairs, no kernel) on a drop of the solute box
   (the chain and the waters within 1.5 nm of it), float32 against float64;
12. the user API (``nbt.Context``, ``VerletIntegrator``, ``Platform``):
   (a) the rigid box through ``Context(system, VerletIntegrator(0.002),
   Platform.getPlatformByName("CUDA"))``, SETTLE from the System's
   constraints, and make_md_step with the Context's K and capacity from
   the same state: a warm-up step(200) and chunk of each, then eight timed
   step(200) calls and eight chunks in turns (Context first in every other
   round); the Context's one MD step captures in the warm-up and never
   after, the two trajectories equal to the bit, ms/step of both;
   (e) a checkpoint, 200 steps, the checkpoint loaded and the same 200
   steps again, equal to the bit; (d) setParameter and
   updateParametersInContext (a charge) keep the graph and the data
   tensors, the next 200 steps equal to the bit those of a Context built
   with the new parameters from the same state, and the energy and
   dE/dlambda equal to its own to the bit; (b) the solute box through a
   Context (HarmonicBondForce, water constraints) with phase 6's gates;
   (c) getState on both boxes,
   float32 (K3 on the kernel route) against Precision double on the card
   with phase 4's gates (atoms with a pair within 1e-6 nm of the cutoff
   held to the force jump there), and with the reciprocal part in its own
   force group direct plus reciprocal equal to the total; (f) bare Ewald
   (25,326 half-space vectors) through the fused MD step: the fused
   evaluation against make_compute in float64, the column kernel in Ewald
   mode against its twin, one warm-up and three timed chunks with phase
   5's checks, phase 9's graph against eager; (g) the per-step rebuild: a
   cube of the state's whole waters at its density (port_systems
   .water_cube: the waters with their oxygen in a 2.6 nm cube, less those
   that overlap across its faces, moved into a 2.52 nm box: 1,596 atoms),
   2 cells of the cutoff per axis, through the Context: its route (all
   pairs, the atom-space PME, no hand-written kernel) and its graph, 20 x
   100 steps with the velocities rescaled to 300 K by each chunk's mean
   temperature (the cut's faces relax), then 200 timed steps and 200
   sampled every 25 steps, with phase 5's gates (the temperature the mean
   of the samples), and the evaluation against float64; then its graph
   against its eager body over two windows of 25 steps, in float64 and in
   float32: positions, velocities and energy equal to the bit (the
   atom-space PME spreads in int64 fixed point);
13. the constrained solute, the native library, the example: (a) the
   solute box with its chain's eleven 1-2 pairs as constraints
   (port_systems.chain_constraints: one 11-wide cluster, every water
   triangle padded to it, solved by CGLS inside the graph) and its 1-3
   pairs as harmonic bonds, through make_md_step at phase 6's capacity:
   one warm-up chunk and three timed chunks, replayed as CUDA graphs,
   with phase 5's gates and the chain's distances within 1e-5 nm; the
   evaluation at the state reached, card f32 against CPU f64; phase 9's
   graph against eager to the bit; 200-step chunks of the graph and of
   the eager body with the old ``torch.linalg.pinv`` solve in turns,
   ms/step printed beside the eager body's and phase 9's solute box; the
   same system through a Context (its constraints in the System, a
   HarmonicBondForce): no capture after the warm-up, phase 5's gates;
   (b) the native host library (runtime/native.py) built and loaded, its
   dispersion coefficients of the solute box within 1e-8 of the Python
   class loop; (c) examples/lambda_sweep_torch.py on the card, its
   linearity assertion included;
14. the sharded evaluation, ``parallel/mesh.make_sharded_compute``, in
   spawned ranks (``tests/torch_parallel_cases.run_ranks``: a file://
   rendezvous in a temporary directory; a rank that fails or is still
   running after SHARD_TIMEOUT seconds fails the phase, named; the kernels
   are built once, in phase 2, before any rank starts): the rigid box under
   PME, CutoffPeriodic and LJPME and the solute box under PME, in float32
   through the kernel route, pair_cell over each rank's range of cells.
   First pair_cell over the first half of the cells against its plain twin
   (and timed beside the whole grid), and the same evaluations on this
   card alone in float32 and float64.  (a) Two ranks on this card over
   gloo (CUDA tensors): each rank's call launches its pair_cell once
   (counted), every rank returns the same result to the bit, the
   direct-space forces equal the single card's to the bit, and so do the
   int64 PME grids after the all_reduce (every one of a call's, against
   the single card's spread), the total forces TOL_SHARD_FORCE, energy and
   dE/dlambda within 1e-6 relative (the ranks' float partial sums),
   and against float64 phase 4's gates (phase 11's cutoff exception); ms a
   call of both, the bytes of each all_reduce; (c) in the same two ranks,
   make_multichip_md_step on phase 12's 1,596-atom water cube (all-pairs
   rows split over the ranks), 10 steps of 1 fs in float64 from the cut's
   velocities, against a loop of make_compute with the same leapfrog on
   this card: positions within 1e-9 nm (the two differ only in the order
   of float64 sums); (b) one rank per card over NCCL (one rank on a
   one-card machine) with (a)'s gates;
15. the slab-decomposed MD step, ``parallel/fused_shard.make_sharded_md_step``
   (each rank its x-slab of cells, K4: its pair kernel over that range of
   home cells; the PME, the exclusion rows and the 1-4s by atom, molecule
   and exception range; one force all_reduce a step), in spawned ranks as
   phase 14's, on the rigid box under PME and LJPME (pair_column, SETTLE)
   and the solute box under PME (pair_cell) with phase 13's clusters (the
   step takes no bonds, as the JAX package's does not, so the chain is
   held by its 1-2 pairs as constraints, one 11-wide cluster solved by
   CGLS, its 1-3 bonds left out), at phases 5 and 6's capacity (the most
   atoms in a cell + 8, not choose_cell_grid's 220: the pair kernels' time
   grows with it), the cells of cutoff + 0.1 nm and K from the skin at 8
   nm/ps.  First K4 alone: pair_column (force-only and energies; LJPME
   force-only) over the first of two ranks' slabs against its plain twin,
   the two slabs concatenated against the whole grid to the bit, and its
   time beside the whole grid's in turns, with the range's bound.  (a) Two
   ranks on this card over gloo (eager windows): every rank ends with the
   same positions, velocities and energy to the bit; one warm-up chunk and
   one timed chunk of 200 steps (three over NCCL, (b)) with phase 5's
   gates (and the chain's
   distances); the energy at the state reached against CPU float64 (phase
   4's energy gate: the run returns the energy alone); 10 steps from the
   starting state against the single
   card's make_md_step at the same cells, K and capacity (positions within
   slab_md_tolerance, derived beside SLAB_ROUNDING_NM: the two steps'
   PME grids differ, the plan's 55 points against the 60 aligned to the
   bricks, and under LJPME the dispersion grids, 28 against 30, so the
   largest difference of their reciprocal forces is measured in the run);
   each rank's pair kernel launched once a
   step and its energies variant once a run() (counted, the counts set to
   0 just before the run), a rank with no cells none; ms/step of each rank
   beside the single card's make_md_step at the same K and capacity.  (b)
   One rank per card over NCCL (four on a four-card machine, where the
   last rank of the (6, 6, 6) grid owns no cell) with (a)'s gates; its
   windows replay CUDA graphs with the force all_reduce captured: two
   windows of the graph against two of the eager body, positions,
   velocities and energy equal to the bit, and no capture after the
   warm-up chunk.
   ``python3 chip_smoke.py --sharded`` runs phases 1, 2, 14 and 15 only
   (the call to make on several cards);
16. bitwise repeatability (the card's counterpart of the JAX package's
   ``tests/test_two_forces.py::test_deterministic_forces`` and
   ``tests/test_pme_paths.py::test_deterministic_forces``): the rigid and
   the solute box under PME and LJPME through ``nbt.Context`` on
   ``CUDA`` (float32) and ``Reference`` (float64), getState twice with
   setPositions between: forces, energy and dE/dlambda equal to the bit;
   then ``ops/pme.pme_reciprocal`` of the rigid box (charges and, under
   LJPME, C6) on the atoms and on the atoms permuted, in float32 and
   float64: slice energies equal to the bit, forces permuted to the bit.
   It prints how many evaluations it compared.
17. (after phase 3) the water tail (csrc/water_tail.cu: the force unsort,
   the water exclusion rows, the kick, SETTLE and RATTLE of a force-only
   step in one kernel) against its plain twin on the slot forces of the
   benchmark state, with TOL_TAIL_POS and TOL_TAIL_VEL; two launches equal
   to the bit; CUDA-event times of the kernel and of the twin, eager and
   as one CUDA graph, and the kernels one call of each puts on the card.
   Phases 5 and 7 check that every step launches it once, phase 12 that
   the Context's steps do, phase 10 (mixed precision) that it is not
   launched.

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
"solute", "rigid_ljpme", "solute_ljpme", "generic", "context",
"context_solute", "ewald", "getstate", "constrained", "sharded" or
"slab"): launches in that path's run
(the MD runs of phases 5, 6, 7 and 8; the solute box's evaluations of
phases 7 and 8; phase 11's six float32 evaluations; phase 12's step()
calls of both Contexts, the bare-Ewald MD and the float32 getState
calls; phase 13's MD of the constrained solute, whose kernels' shapes
are phase 6's and whose errors and times are phase 6's; phase 14's
ranks' evaluations; phase 15 (a)'s ranks' MD runs; the per-step
rebuild launches no hand-written kernel and has no entry), max abs error
against the plain
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

from port_systems import (BOND_R0, CAVITY_NM, D_HH, D_OH, DT_PS, KB,
                          N_MOLECULES, SOLUTE_SITES, STATE_FILE,
                          WATER_MASSES, add_bonds, add_constraints,
                          build_solute_system, build_system,
                          chain_constraints, cluster_waters,
                          max_cell_occupancy, solute_velocities, water_cube,
                          water_system)

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
MIXED_TIMED_CHUNKS = 3
NVE_CHUNKS = 20           # the NVE pair: 20 chunks of 100 steps each
NVE_STEPS = 100
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
TOL_SPLIT = 1e-6          # generic engine: direct + reciprocal vs one call
                          # (f32 sums of the parts in another order)
GENERIC_METHODS = ("CutoffPeriodic", "Ewald", "PME", "LJPME")
CLUSTER_NM = 1.5          # the non-periodic drop: waters this near the chain
# the drop's dE/dlambda (phase 11) sums some 30,000 chain-water pair
# energies of either sign to a few kJ/mol; the largest float32 rounding of
# it read so far is 1.2e-4 kJ/mol (on the CPU; 4.1e-5 on an H100), so its
# denominator is clamped where the relative gate admits twice that
DROP_DERIV_ROUNDING = 1.2e-4   # kJ/mol
DROP_DERIV_FLOOR = 2 * DROP_DERIV_ROUNDING / TOL_EVAL_DERIV   # 24 kJ/mol
DROP_JUMP = 2.5           # kJ/mol/nm: the reaction-field force jump of one
                          # pair at the cutoff (two oxygens: 2.24)
GENERIC_REPS = 5          # timed make_compute calls per method
SHARD_TIMEOUT = 240.0     # s, phase 14: a spawn of ranks, start to end
SHARD_MD_STEPS = 10       # phase 14 (c): make_multichip_md_step
SHARD_MD_DT = 0.001       # ps
TOL_SHARD_FORCE = 1e-5    # of max|F|, sharded against the single card,
                          # f32: the int64 grids and the direct-space
                          # forces are equal to the bit; a rank
                          # interpolates its share of the atoms, whose
                          # batched products (torch.einsum) round in the
                          # last bit against the whole array's (4e-8-8e-8
                          # of max|F| on 2 gloo ranks on one H100 and on 4
                          # NCCL ranks, an H100 each)
TOL_SHARD_ENERGY = 1e-6   # relative energy and dE/dlambda, the same
TOL_SHARD_MD = 1e-9       # nm, phase 14 (c) in float64
SLAB_TIMED_CHUNKS = 3     # phase 15: timed chunks after a warm-up chunk
SLAB_GLOO_TIMED_CHUNKS = 1   # phase 15 (a): gloo's eager windows move the
                             # int64 grid through the host (28-64 ms/step)
SLAB_CHECK_STEPS = 10     # phase 15: steps against the single card's
# phase 15: the positions of the slab step after SLAB_CHECK_STEPS (n = 10)
# steps of 2 fs against the single card's make_md_step are held to
# slab_md_tolerance (below), from two terms.  (1) Forces: the slab step
# spreads on the plan's PME grid (55 points at the benchmark box), the
# fused step on the grid aligned to its bricks (60), and under LJPME the
# dispersion grids differ too (28 against 30): the largest difference of
# the two reciprocal forces at the starting state, measured in float64 on
# the card in the run, plus float32 rounding within 1e-5 of max|F| ~ 3e3
# kJ/mol/nm (phase 14's gate); a force difference dF moves an atom of the
# lightest mass m by at most sum_k k dt^2 dF / m = 55 dt^2 dF / m.  (2)
# The float32 constraint solve rounds: inputs an ulp apart come out of it
# up to 8 ulps apart (1.9e-6 nm at 2.7 nm, a CPU float32 run of both steps
# from one state), 3.8e-6 nm at the box's 6.15 nm, and a position's error
# at step j is carried on by the velocity (x_j - x_{j-1}) / dt into every
# later step: sum_j (n - j + 1) = 55 of them, 2.1e-4 nm.
SLAB_ROUNDING_NM = 55 * 3.8e-6
SLAB_ROUNDING_FORCE = 1e-5 * 3e3       # kJ/mol/nm
CONTEXT_TIMED_CHUNKS = 3  # phase 12: step() chunks after a warm-up chunk
CONTEXT_ALTERNATED_CHUNKS = 8   # phase 12 (a): timed chunks of the Context
                                # and of make_md_step, in turns
EWALD_TIMED_CHUNKS = 3
CUBE_NM = 2.6             # the per-step rebuild's cut: a 2.52 nm box at
                          # the state's density, 2 cells of 0.9 nm
CUBE_EQUILIBRATION = 20   # 100-step chunks, velocities rescaled to 300 K,
                          # before a timed chunk and a sampled one without

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
# the water tail (csrc/water_tail.cu), a molecule: bytes read once
# (positions 36, velocities 36, three slot forces 36, slots 24, charges 12,
# pair slices 24, inverse masses 12, SETTLE constants 56) and written once
# (positions and velocities 72), and float operations (an upper count of
# its arithmetic: rows ~100, kick and drift 36, SETTLE ~330, RATTLE ~170)
TAIL_BYTES = 236 + 72
TAIL_OPS = 640
# the tail against its twin: both round every operation in the same order
# with CUDA's erff, expf, sqrt and rsqrtf; PyTorch may order a three-term
# sum otherwise or contract a cross product's terms, an ulp of an
# intermediate, and SETTLE carries inputs an ulp apart to outputs up to 8
# ulps apart (SLAB_ROUNDING_NM's note): 8 ulps of a coordinate below 8 nm;
# the velocity (x_new - x0) / dt carries that over dt
TOL_TAIL_POS = 3.8e-6     # nm
TOL_TAIL_VEL = 1.9e-3     # nm/ps

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
    "water_tail": ("csrc/water_tail.cu",
                   "none: the JAX package's jnp unsort, exclusion rows "
                   "(ops/bonded.py) and SETTLE (runtime/constraints.py)"),
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
        ("pme_interp_windows", ("", "_dispersion")),
        ("water_tail", ("",)))
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
    ("water_tail", "water_tail", "rigid", "rigid"),
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
          for k in DISPERSION_KERNELS) + (
    ("pair_cell_energies_generic_rf", "pair_cell_energies", "generic",
     "generic_rf"),
    ("pair_cell_energies_generic", "pair_cell_energies", "generic",
     "generic"),
    ("pair_cell_ljpme_energies_generic", "pair_cell_ljpme_energies",
     "generic", "generic"),
) + tuple((k + "_context", k, "context", "context")
          for k in ("pair_column", "pair_column_energies", "pme_spread",
                    "pme_spread_energies", "pme_interp")) + tuple(
    (k + "_context_solute", k, "context_solute", "context_solute")
    for k in ("pair_cell", "pair_cell_energies", "pme_spread",
              "pme_spread_energies", "pme_interp")) + (
    ("pair_column_ewald", "pair_column", "ewald", "ewald"),
    ("pair_column_energies_ewald", "pair_column_energies", "ewald", "ewald"),
    ("pair_cell_energies_getstate", "pair_cell_energies", "getstate",
     "getstate"),
) + tuple((k + "_constrained", k, "constrained", "constrained")
          for k in ("pair_cell", "pair_cell_energies", "pme_spread",
                    "pme_spread_energies", "pme_interp")) + (
    ("pair_cell_energies_sharded", "pair_cell_energies", "sharded",
     "sharded"),
    ("pair_cell_energies_sharded_rf", "pair_cell_energies", "sharded",
     "sharded_rf"),
    ("pair_cell_ljpme_energies_sharded", "pair_cell_ljpme_energies",
     "sharded", "sharded"),
    ("pair_column_sharded", "pair_column", "slab", "slab"),
    ("pair_column_energies_sharded", "pair_column_energies", "slab", "slab"),
    ("pair_column_ljpme_sharded", "pair_column_ljpme", "slab", "slab"),
)
# the kernels each run must launch; it must launch no other ("generic":
# phase 11's evaluations in Ewald mode, "generic_rf" in reaction-field mode;
# phase 12: "context" and "context_solute" the step() calls of a Context on
# either box, "ewald" bare Ewald's MD, "getstate" the float32 getState
# calls, K3; "simple" the per-step rebuild's steps, which launch none;
# phase 14: "sharded" the ranks' make_sharded_compute calls in Ewald mode,
# "sharded_rf" in reaction-field mode, pair_cell over each rank's cells;
# phase 15: "slab" the ranks' make_sharded_md_step runs over gloo, each
# rank's pair kernel over its x-slab of cells, the PME on the atoms)
RUN_KERNELS = {
    "generic": {"pair_cell_energies", "pair_cell_ljpme_energies"},
    "generic_rf": {"pair_cell_energies"},
    "rigid": {"pair_column", "pair_column_energies", "pme_spread",
              "pme_spread_energies", "pme_interp", "water_tail"},
    "rigid_mixed": {"pair_column", "pair_column_energies", "pme_spread",
                    "pme_spread_energies", "pme_interp"},
    "solute": {"pair_cell", "pair_cell_energies", "pme_spread",
               "pme_spread_energies", "pme_interp"},
    "rigid_grid": {"pair_column", "pair_column_energies",
                   "pme_spread_energies", "water_tail", *WINDOW_KERNELS},
    "solute_grid": {"pair_cell", "pair_cell_energies", "pme_spread_energies",
                    *WINDOW_KERNELS},
    "rigid_ljpme": {"pair_column_ljpme", "pair_column_ljpme_energies",
                    "pme_spread", "pme_spread_energies", "pme_interp",
                    *DISPERSION_KERNELS},
    "solute_ljpme": {"pair_cell_ljpme", "pair_cell_ljpme_energies",
                     "pme_spread", "pme_spread_energies", "pme_interp",
                     *DISPERSION_KERNELS},
    "ewald": {"pair_column", "pair_column_energies"},
    "getstate": {"pair_cell_energies"},
    "simple": set(),
    "sharded": {"pair_cell_energies", "pair_cell_ljpme_energies"},
    "sharded_rf": {"pair_cell_energies"},
    "slab": {"pair_column", "pair_column_energies", "pair_column_ljpme",
             "pair_column_ljpme_energies", "pair_cell", "pair_cell_energies"},
}
RUN_KERNELS["context"] = RUN_KERNELS["rigid"]
RUN_KERNELS["context_solute"] = RUN_KERNELS["solute"]
RUN_KERNELS["constrained"] = RUN_KERNELS["solute"]


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


def pair_counts(slot_pos, slot_ids, slot_excl, box, cutoff, n_real, counts,
                cells=None):
    """(pairs within the cutoff that are not excluded, excluded pairs) among
    the real slots of every 27-cell neighbourhood, each unordered pair once,
    by minimum image in the rectangular ``box``; with ``cells`` = (begin,
    end), half the pairs that the rows of those home cells take part in
    (the work of a cell kernel launched over that range)."""
    import torch
    g, _, C = slot_pos.shape
    lo, hi = cells or (0, g)
    lengths = torch.diagonal(box).reshape(1, 3, 1, 1)
    grid_pos = slot_pos.reshape(*counts, 3, C)
    grid_ids = slot_ids.reshape(*counts, C)
    real = slot_ids[lo:hi] < n_real
    eye = torch.eye(C, dtype=torch.bool, device=slot_pos.device)
    n_pair = n_excl = 0
    for o in range(27):
        roll = dict(shifts=(1 - o // 9, 1 - (o // 3) % 3, 1 - o % 3),
                    dims=(0, 1, 2))
        cand = torch.roll(grid_pos, **roll).reshape(g, 3, C)[lo:hi]
        cids = torch.roll(grid_ids, **roll).reshape(g, C)[lo:hi]
        d = slot_pos[lo:hi, :, :, None] - cand[:, :, None, :]
        d = d - lengths * torch.round(d / lengths)
        near = torch.sum(d * d, dim=1) < cutoff * cutoff
        both = real[:, :, None] & (cids < n_real)[:, None, :]
        if o == 13:
            both = both & ~eye
        excluded = torch.any(slot_excl[lo:hi, :, :, None]
                             == cids[:, None, None, :], dim=1)
        n_pair += int((both & ~excluded & near).sum())
        n_excl += int((both & excluded).sum())
    return n_pair // 2, n_excl // 2


def pair_bound(pc, energies, n_pair, n_excl, cell_kernel, out_cells=None):
    """Bound of one pair-kernel call: the pairs within the cutoff (and, for
    the cell kernel, their minimum image and the excluded pairs'
    corrections; under LJPME the dispersion terms of both), and the slot
    tensors read and the outputs (of ``out_cells`` home cells, default all)
    written once."""
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
    out = g if out_cells is None else out_cells
    nbytes = (4 * g * C * (3 + 3 + 1 + 1 + pc.emax) + 4 * 2 * nsub * nsub
              + 4 * 9 + 4 * out * 3 * C
              + (4 * out * 2 * nsub * nsub if energies else 0))
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


def water_tail_check(plan, masses, constraints, capacity, pos, vel, box,
                     gvals, data, reps):
    """Phase 17: the water tail (csrc/water_tail.cu) against its plain
    twin on the same slot forces of the benchmark state: two launches
    equal to the bit, positions within TOL_TAIL_POS and velocities within
    TOL_TAIL_VEL of the twin's; CUDA-event times of the kernel and of the
    twin, eager and captured in one CUDA graph (as the MD step's windows
    ran it before the kernel), and the kernels of one call of each."""
    import torch
    from nonbondedslicing_tpu_torch.ops.fused import make_fused_engine
    from nonbondedslicing_tpu_torch.runtime import water_tail
    from nonbondedslicing_tpu_torch.runtime.fastpath import (
        DEFAULT_SKIN, make_integrator)
    prepare, apply, _ = make_fused_engine(plan, cell_capacity=capacity,
                                          target_skin=DEFAULT_SKIN,
                                          energies=False)
    integrate = make_integrator(masses, DT_PS, torch.float32, constraints)
    tail = water_tail.make_water_tail(plan, DT_PS, integrate)
    # row-major, as the MD step's buffers are (the state file's arrays are
    # column-major, which the tail would copy first)
    pos, vel = pos.contiguous(), vel.contiguous()
    state = prepare(pos, box, gvals, data)
    _, slot_f, aux = apply(pos, box, gvals, data, state, slot_forces=True)
    args = (slot_f, pos, vel, state, aux["lam"])
    p_k, v_k = tail(*args)
    p_k2, v_k2 = tail(*args)
    p_t, v_t = tail.plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(p_k, p_k2) and torch.equal(v_k, v_k2),
          "water_tail: positions and velocities of two launches equal to "
          "the bit (no atomics)")
    dp = float((p_k - p_t).abs().max())
    dv = float((v_k - v_t).abs().max())
    same = torch.equal(p_k, p_t) and torch.equal(v_k, v_t)
    check(dp <= TOL_TAIL_POS and dv <= TOL_TAIL_VEL,
          f"water_tail: against the twin max|dx| {dp:.3e} <= {TOL_TAIL_POS} "
          f"nm, max|dv| {dv:.3e} <= {TOL_TAIL_VEL} nm/ps (equal to the "
          f"bit: {same})")
    ms, plain_ms = timed_pair(lambda: tail(*args),
                              lambda: tail.plain(*args), reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tail.plain(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tail.plain(*args)
    g1 = cuda_ms(graph.replay, reps)
    k3 = cuda_ms(lambda: tail(*args), reps)
    g2 = cuda_ms(graph.replay, reps)
    m = pos.shape[0] // 3
    bound_ms, bound_by = bound(TAIL_OPS * m, TAIL_BYTES * m)
    out = dict(max_abs_err=dp, max_abs_err_velocity=dv, equals_twin=same,
               ms=ms, ms_beside_graph=k3, plain_ms=plain_ms,
               plain_graph_ms=0.5 * (g1 + g2), bound_ms=bound_ms,
               bound_by=bound_by,
               launches_per_call=device_ops_per_call(lambda: tail(*args),
                                                     "water_tail"),
               plain_kernels_per_call=device_ops_per_call(
                   lambda: tail.plain(*args), "water_tail_plain"))
    print(f"water_tail: kernel {ms:.4f} ms ({k3:.4f} between the graph's "
          f"timings), twin {plain_ms:.4f} ms eager, "
          f"{out['plain_graph_ms']:.4f} ms as one CUDA graph of "
          f"{out['plain_kernels_per_call']} kernels; bound {bound_ms:.6f} "
          f"ms ({bound_by}, {m} waters)")
    return out


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
              slice_subset_pairs=torch.as_tensor(slice_subsets(nsub),
                                                 device=box.device),
              energies=False)
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


class Chunks:
    """make_md_step's run() over chunks of steps, with bench.py's retries:
    capacity + 8 after a cell overflow, K halved after a skin violation
    (the chunk is then run again from its start).  ``make_run(capacity,
    reuse_steps)`` builds the MD step.  Counts the steps and the run()
    calls made, and keeps the graph statistics (``run.stats``) of every
    run it built."""

    def __init__(self, make_run, capacity, guard_exc):
        self.make_run = make_run
        self.capacity = capacity
        self.guard_exc = guard_exc
        self.reuse = None
        self.run = None
        self.steps = 0
        self.calls = 0
        self.retired = dict(replays=0, replayed_launches=0)

    def __call__(self, p, v, box, gvals, data, steps):
        while True:
            if self.run is None:
                self.run = self.make_run(self.capacity, self.reuse)
                self.reuse = self.run.config["reuse_steps"]
            self.steps += steps
            self.calls += 1
            try:
                return self.run(p, v, box, gvals, data, steps)
            except self.guard_exc as exc:
                if "capacity overflow" in str(exc):
                    self.capacity += 8
                elif "skin violation" in str(exc) and self.reuse > 1:
                    self.reuse = max(1, self.reuse // 2)
                else:
                    raise
                for key in self.retired:
                    self.retired[key] += self.run.stats[key]
                self.run = None
                print(f"md: retry after guard: {exc}")

    def graph_stats(self):
        """(graph replays, kernel launches they added) over every run."""
        return tuple(self.retired[key] + self.run.stats[key]
                     for key in ("replays", "replayed_launches"))


def run_md(chunks, p, v, box, gvals, data, n_timed):
    """One warm-up chunk and ``n_timed`` timed chunks of CHUNK_STEPS steps
    through ``chunks`` (a :class:`Chunks`).  Returns (p, v, energy, seconds
    per chunk, the step's config)."""
    import torch
    chunk_s = []
    for _ in range(1 + n_timed):
        torch.cuda.synchronize()
        t0 = time.time()
        p, v, energy = chunks(p, v, box, gvals, data, CHUNK_STEPS)
        torch.cuda.synchronize()
        chunk_s.append(time.time() - t0)
    return p, v, energy, chunk_s, chunks.run.config


def launch_report(label, chunks, launches, pair, tail=False):
    """The hand-written kernels' launches per step of an MD run: those the
    card ran (the wrappers' counters, which a graph's replays add to) and
    the host's launch calls of them (graph replays, and kernels launched
    outside a graph: the warm-up windows and the final evaluations).  The
    force-only ``pair`` kernel must have run once a step and its energies
    variant once a run(); with ``tail``, the water tail once a step."""
    total = sum(launches.values())
    replays, replayed = chunks.graph_stats()
    eager = total - replayed
    print(f"{label}: {total / chunks.steps:.3f} hand-written kernels a step "
          f"on the card, {(replays + eager) / chunks.steps:.3f} host launch "
          f"calls of them a step ({replays} graph replays, {eager} kernels "
          f"launched outside a graph, {chunks.steps} steps)")
    check(launches[pair] == chunks.steps
          and launches[pair + "_energies"] == chunks.calls,
          f"{label}: {pair} launched once a step ({launches[pair]} in "
          f"{chunks.steps}), its energies variant once a run() "
          f"({launches[pair + '_energies']} in {chunks.calls})")
    if tail:
        check(launches["water_tail"] == chunks.steps,
              f"{label}: water_tail launched once a step "
              f"({launches['water_tail']} in {chunks.steps})")


def md_checks(label, p, v, energy, masses, first_water, n_dof, chunk_s,
              n_atoms, card, temp=None):
    """Energy finite, water constraints, temperature (of ``v``, or ``temp``
    where given); prints the median and range of ms/step and ns/day of the
    timed chunks and returns their sorted ms/step."""
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
    if temp is None:
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


def graph_against_eager(label, make_run, capacity, p0, v0, box, gvals,
                        data, reset_launches, card):
    """Two windows of K steps replayed from make_md_step's CUDA graph
    against the same windows through its eager body (``run.eager``), from
    the state one captured window reaches: positions, velocities and the
    energy equal to the bit, the same kernel launches counted; then
    CHUNK_STEPS-step chunks timed in turns graph, eager, eager, graph.
    Returns the run, the state after the timed chunks and their ms/step
    ({"graph": [..], "eager": [..]})."""
    import torch
    run = make_run(capacity, None)
    K = run.config["reuse_steps"]
    check(run.config["graph"], f"{label}: make_md_step graphs its windows")
    p, v, _ = run(p0, v0, box, gvals, data, K)
    check(run.stats["captures"] == 1 and run.stats["replays"] == 0,
          f"{label}: the first window runs eagerly and is captured "
          f"({run.stats})")
    made = {}
    out = {}
    for name, fn in (("graph", run), ("eager", run.eager)):
        reset_launches()
        out[name] = fn(p, v, box, gvals, data, 2 * K)
        torch.cuda.synchronize()
        made[name] = all_launches()
    check(run.stats["replays"] == 2,
          f"{label}: two windows, two replays ({run.stats})")
    check(made["graph"] == made["eager"],
          f"{label}: the graph counts the kernels the eager body launches "
          f"({sum(made['graph'].values())} in {2 * K} steps)")
    (p_g, v_g, e_g), (p_e, v_e, e_e) = out["graph"], out["eager"]
    dp = float((p_g - p_e).abs().max())
    dv = float((v_g - v_e).abs().max())
    print(f"{label}: {2 * K} steps, graph against eager: max|dx| {dp:.3e} "
          f"nm, max|dv| {dv:.3e} nm/ps, energy {float(e_g)!r} against "
          f"{float(e_e)!r} kJ/mol")
    check(torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
          and float(e_g) == float(e_e),
          f"{label}: positions, velocities and energy equal to the bit")
    ms = {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        fn = run if name == "graph" else run.eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, v, _ = fn(p, v, box, gvals, data, CHUNK_STEPS)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / CHUNK_STEPS)
    print(f"{label}: ms/step of {CHUNK_STEPS}-step chunks in turns: graph "
          f"{[round(x, 3) for x in ms['graph']]}, eager "
          f"{[round(x, 3) for x in ms['eager']]} (capacity "
          f"{capacity}; {card})")
    return run, (p, v), ms


def nve_drift(label, chunks, p, v, box, gvals, data, masses, card):
    """NVE_CHUNKS chunks of NVE_STEPS steps from the given state; the
    drift of PE + KE in kJ/mol/ps, the slope of a linear fit over the
    chunk ends (PE: each run()'s energy at its final positions; KE: the
    leapfrog half-step velocities, as tests/test_torch_md.py takes it)."""
    t, e = [], []
    m = np.asarray(masses, dtype=np.float64)[:, None]
    for i in range(NVE_CHUNKS):
        p, v, pe = chunks(p, v, box, gvals, data, NVE_STEPS)
        ke = 0.5 * float(np.sum(m * v.double().cpu().numpy() ** 2))
        t.append((i + 1) * NVE_STEPS * DT_PS)
        e.append(float(pe) + ke)
    slope = float(np.polyfit(t, e, 1)[0])
    check(all(math.isfinite(x) for x in e), f"nve {label}: energies finite")
    print(f"nve {label}: {NVE_CHUNKS} x {NVE_STEPS} steps at {DT_PS} ps, "
          f"PE + KE {e[0]:.1f} -> {e[-1]:.1f} kJ/mol, drift {slope:.2f} "
          f"kJ/mol/ps (linear fit; {p.shape[0]} atoms, {card})")
    return slope


def card_gates(label, plan, out32, out64, gvals_np, skip_atoms=None,
               names=("f32", "f64"), deriv_floor=1.0):
    """A float32 evaluation (slice energies, forces) against a reference
    (float64 on the card, named by ``names``) with phase 4's gates: total
    energy TOL_EVAL_ENERGY relative, forces TOL_EVAL_FORCE of max|F|, every
    dE/dlambda TOL_EVAL_DERIV relative (denominator clamped at
    ``deriv_floor`` kJ/mol).  ``skip_atoms`` (a bool mask) leaves atoms
    out of the force gate; the caller holds them to their own bound, which
    it is given back: their max|dF|."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    (e32, f32), (e64, f64) = out32, out64
    lam = slice_lambdas(plan.lam_source,
                        torch.as_tensor(gvals_np, dtype=torch.float64))
    E32 = float(engine_mod.contract_energy(e32.cpu(), lam))
    E64 = float(engine_mod.contract_energy(e64.cpu(), lam))
    rel_e = abs(E32 - E64) / abs(E64)
    df = (f32.double() - f64.double()).abs().max(dim=1).values
    fmax = float(f64.abs().max())
    skipped_err = 0.0
    if skip_atoms is not None and bool(skip_atoms.any()):
        skipped_err = float(df[skip_atoms].max())
        df = df[~skip_atoms]
    f_err = float(df.max()) / fmax
    d32 = engine_mod.parameter_derivatives(e32.cpu(), plan.deriv_mask)
    d64 = engine_mod.parameter_derivatives(e64.cpu(), plan.deriv_mask)
    rel_d = float(((d32 - d64).abs()
                   / d64.abs().clamp(min=deriv_floor)).max())
    a, b = names
    print(f"{label}: E {a} {E32:.6f}, {b} {E64:.6f} kJ/mol; dE/dlambda {a} "
          f"{d32.tolist()}, {b} {d64.tolist()}; max|F| {fmax:.1f}")
    check(math.isfinite(E32) and rel_e <= TOL_EVAL_ENERGY,
          f"{label}: relative energy error {rel_e:.3e} <= {TOL_EVAL_ENERGY}")
    check(f_err <= TOL_EVAL_FORCE,
          f"{label}: force error {f_err:.3e} of max|F| <= {TOL_EVAL_FORCE}"
          + ("" if skip_atoms is None else
             f" ({int(skip_atoms.sum())} atoms at the cutoff left out)"))
    check(rel_d <= TOL_EVAL_DERIV,
          f"{label}: relative dE/dlambda error {rel_d:.3e} <= "
          f"{TOL_EVAL_DERIV} (denominator at least 1 kJ/mol)")
    return skipped_err


def near_cutoff_atoms(slot_pos, slot_ids, box, cutoff, n, counts, delta):
    """(atoms with a pair whose minimum-image distance lies within
    ``delta`` of the cutoff, as a bool mask (n,), and the most such pairs
    of one atom), pairs taken over every 27-cell neighbourhood of the slot
    table in float64 (rectangular box)."""
    import torch
    g, _, C = slot_pos.shape
    pos = slot_pos.double()
    lengths = torch.diagonal(box).double().reshape(1, 3, 1, 1)
    grid_pos = pos.reshape(*counts, 3, C)
    grid_ids = slot_ids.reshape(*counts, C)
    hits = torch.zeros(n + 1, dtype=torch.int64, device=slot_pos.device)
    for o in range(27):
        roll = dict(shifts=(1 - o // 9, 1 - (o // 3) % 3, 1 - o % 3),
                    dims=(0, 1, 2))
        cand = torch.roll(grid_pos, **roll).reshape(g, 3, C)
        cids = torch.roll(grid_ids, **roll).reshape(g, C).long()
        d = pos[:, :, :, None] - cand[:, :, None, :]
        d = d - lengths * torch.round(d / lengths)
        r = torch.sqrt(torch.sum(d * d, dim=1))
        near = ((r - cutoff).abs() < delta) & (cids < n)[:, None, :]
        near &= (slot_ids < n)[:, :, None]
        rows = slot_ids.long()[:, :, None].expand_as(near)
        hits.index_add_(0, rows[near], torch.ones_like(rows[near]))
    hits = hits[:n]
    return hits > 0, int(hits.max())


def call_ms(fn, reps=GENERIC_REPS):
    """Median CUDA-event ms of one call of fn over ``reps`` calls after a
    warm-up call, each timed from an event before it to one after it:
    whatever host work the call holds the card up with counts, as its
    caller sees it."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def generic_pair_config(plan):
    """The cell kernel's configuration for ``plan`` on the generic engine's
    kernel route, made from the plan: its cell grid without skin
    (``neighbors.choose_cell_grid``), Ewald mode under Ewald, PME and LJPME,
    reaction field under CutoffPeriodic (ReferenceSlicedLJCoulombIxn.cpp:
    66-67)."""
    from nonbondedslicing_tpu_torch.models.force import NonbondedForce
    from nonbondedslicing_tpu_torch.ops import cuda_direct, neighbors
    counts, capacity = neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                                  plan.num_particles)
    eps_rf = plan.rf_dielectric
    return cuda_direct.PairConfig(
        counts=tuple(counts), capacity=capacity, nsub=plan.num_subsets,
        emax=plan.exclusion_list.shape[1],
        mode=(cuda_direct.MODE_REACTION_FIELD
              if plan.method == NonbondedForce.CutoffPeriodic
              else cuda_direct.MODE_EWALD),
        cutoff=plan.cutoff,
        krf=plan.cutoff ** -3 * (eps_rf - 1.0) / (2.0 * eps_rf + 1.0),
        crf=(1.0 / plan.cutoff) * (3.0 * eps_rf) / (2.0 * eps_rf + 1.0),
        ewald_alpha=plan.ewald_alpha, use_switch=bool(plan.use_switch),
        switch_distance=plan.switch_distance,
        exceptions_periodic=bool(plan.exceptions_periodic),
        ljpme=plan.method == NonbondedForce.LJPME,
        dispersion_alpha=plan.dispersion_alpha)


def generic_pair_check(name, plan, args32, reps, dev, cells=None):
    """``pair_cell`` with energies at the generic engine's shapes (its slot
    table of the float32 inputs ``args32``: positions, box, globals and
    data on the card) against its plain twin, with its bound; over the
    home cells ``cells`` = (begin, count) where given."""
    import functools
    import torch
    from nonbondedslicing_tpu_torch.ops import cuda_direct, kernel_direct
    from nonbondedslicing_tpu_torch.ops.cuda_direct import pair_launch_shape
    from nonbondedslicing_tpu_torch.ops import params as params_mod
    pc = generic_pair_config(plan)
    pos, box, gvals, data = args32
    charge, sig_half, eps2 = params_mod.particle_params(data, gvals)
    _, tensors, _ = kernel_direct.cell_slots(
        pos, charge, sig_half, eps2, data["subsets"], data["exclusion_list"],
        box, pc.counts, pc.capacity)
    lam = params_mod.slice_lambdas(plan.lam_source, gvals)
    sl_tab = torch.as_tensor(plan.slice_table, dtype=torch.int64, device=dev)
    args = (*tensors, lam[:, 0][sl_tab].contiguous(),
            lam[:, 1][sl_tab].contiguous(), box, pc, True, plan.num_particles)
    out = pair_kernel_check(
        name, functools.partial(cuda_direct.pair_cell, cells=cells),
        functools.partial(cuda_direct.pair_cell_plain, cells=cells), args,
        pc, reps, cell_kernel=True)
    lo, hi = cuda_direct.cell_range(pc, cells)
    if cells is not None:
        print(f"{name}: the range's {hi - lo} cells, "
              f"{(hi - lo) * pair_launch_shape(pc, True, True)['row_blocks']}"
              f" blocks")
        ms, out["whole_grid_ms"] = timed_pair(
            lambda: cuda_direct.pair_cell(*args, cells=cells),
            lambda: cuda_direct.pair_cell(*args), reps, what=None)
        print(f"{name}: {ms:.4f} ms beside the whole grid's "
              f"{out['whole_grid_ms']:.4f} ms ({ms / out['whole_grid_ms']:.3f}"
              f" of it), in turns")
    n_pair, n_excl = pair_counts(tensors[0], tensors[3], tensors[4], box,
                                 plan.cutoff, plan.num_particles, pc.counts,
                                 (lo, hi))
    out["bound_ms"], out["bound_by"] = pair_bound(
        pc, True, n_pair, n_excl, cell_kernel=True, out_cells=hi - lo)
    print(f"{name}: {n_pair} pairs within the cutoff, {n_excl} excluded "
          f"pairs; bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def gates_against_f64(label, plan, pc, args32, out32, out64):
    """``card_gates`` of a float32 evaluation through the kernel route
    (``pc``: its cell kernel's configuration, ``args32`` its inputs)
    against float64.  Under the reaction field, whose force jumps at the
    cutoff by k qi qj (1/rc^2 - 2 krf rc), atoms with a pair within 1e-6 nm
    of the cutoff (within float32's reach of it: such a pair may lie on
    either side in float32 and float64) are held to the jump instead."""
    from nonbondedslicing_tpu_torch.ops import cuda_direct, kernel_direct
    from nonbondedslicing_tpu_torch.ops import params as params_mod
    from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0
    skip = None
    if pc.mode == cuda_direct.MODE_REACTION_FIELD:
        _, tensors, _ = kernel_direct.cell_slots(
            args32[0], *params_mod.particle_params(args32[3], args32[2]),
            args32[3]["subsets"], args32[3]["exclusion_list"], args32[1],
            pc.counts, pc.capacity)
        skip, per_atom = near_cutoff_atoms(
            tensors[0], tensors[3], args32[1], plan.cutoff,
            plan.num_particles, pc.counts, 1e-6)
        qmax = float(np.abs(plan.base_params[:, 0]).max())
        jump = per_atom * ONE_4PI_EPS0 * qmax * qmax * abs(
            plan.cutoff ** -2 - 2.0 * pc.krf * plan.cutoff) + 0.1
        print(f"{label}: {int(skip.sum())} atoms with a pair within 1e-6 nm "
              f"of the cutoff (at most {per_atom} an atom); the force jump "
              f"there is at most {jump:.3f} kJ/mol/nm")
    skipped_err = card_gates(label, plan, out32, out64, plan.global_defaults,
                             skip)
    if skip is not None:
        check(skipped_err <= jump,
              f"{label}: atoms at the cutoff within the jump, max|dF| "
              f"{skipped_err:.3e} <= {jump:.3f}")


def generic_engine(dev, card, reset_launches, results, run_launches, pos_np,
                   box_len, fused, reps):
    """Phase 11: the generic engine ``make_compute`` at full width, in
    evaluations only.  ``fused``: (apply, state, config, inputs) of phase
    3's rigid PME evaluation through the fused engine."""
    import dataclasses
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import cuda_direct, kernel_direct
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import params as params_mod
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    f32, f64 = torch.float32, torch.float64

    t0 = time.time()
    configs = []
    for method in GENERIC_METHODS:
        system, force, _, _ = build_system(nbt, method)
        configs.append((f"rigid {method}", plan_mod.build_plan(force, system),
                        pos_np))
    for method in ("PME", "LJPME"):
        out = build_solute_system(nbt, pos_np, box_len, method)
        configs.append((f"solute {method}",
                        plan_mod.build_plan(out[1], out[0]), out[2]))
    print(f"generic: {len(configs)} plans built in {time.time() - t0:.1f} s")

    # ---- full width through the kernel route, against float64 on the card
    reset_launches()
    evaluated = {}
    by_mode = {run: dict.fromkeys(all_launches(), 0)
               for run in ("generic", "generic_rf")}
    for label, plan, p_np in configs:
        compute = engine_mod.make_compute(plan, True, True, with_aux=True)
        pc = generic_pair_config(plan)
        check(compute.route == "pallas",
              f"generic {label}: make_compute takes the kernel route "
              f"({compute.route}); cells {pc.counts} x {pc.capacity} "
              f"slots, nsub {pc.nsub}, emax {pc.emax}, "
              f"{'Ewald' if pc.mode else 'reaction-field'} mode"
              + (", LJPME" if pc.ljpme else ""))
        args32 = card_inputs(plan, p_np, f32, dev)
        before = all_launches()
        t0 = time.time()
        e32, g32, aux = compute(*args32)
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in all_launches().items()
                if v != before[k]}
        key = "pair_cell_ljpme_energies" if pc.ljpme else "pair_cell_energies"
        check(made == {key: 1}, f"generic {label}: one call launched {made} "
              f"({time.time() - t0:.1f} s): {key} once, nothing else")
        run = ("generic_rf" if pc.mode == cuda_direct.MODE_REACTION_FIELD
               else "generic")
        for k, v in made.items():
            by_mode[run][k] += v
        check(int(aux["overflow"]) == 0 and float(aux["excl_span"]) < 1.0,
              f"generic {label}: overflow {int(aux['overflow'])} == 0, "
              f"excluded pairs span {float(aux['excl_span']):.4f} < 1 cell")
        before = all_launches()
        t0 = time.time()
        e64, g64, _ = compute(*card_inputs(plan, p_np, f64, dev))
        torch.cuda.synchronize()
        check(all_launches() == before,
              f"generic {label}: float64 takes the cell engine and "
              f"corrections, no kernel ({time.time() - t0:.1f} s)")
        gates_against_f64(f"generic {label}", plan, pc, args32, (e32, g32),
                          (e64, g64))
        evaluated[label] = dict(compute=compute, plan=plan, pc=pc,
                                args32=args32, out32=(e32, g32))
    total = all_launches()
    check(all(total[k] == by_mode["generic"][k] + by_mode["generic_rf"][k]
              for k in total),
          "generic: every launch of the run falls to one mode")
    for run, counted in by_mode.items():
        run_launches[run] = counted
        print(f"{run}: launches "
              f"{ {k: v for k, v in counted.items() if v} }")
        check_launches(run, run, counted)

    # ---- pair_cell at the generic shapes against its plain twin
    for name, label in (("pair_cell_energies_generic_rf", "rigid CutoffPeriodic"),
                        ("pair_cell_energies_generic", "rigid PME"),
                        ("pair_cell_ljpme_energies_generic", "rigid LJPME")):
        ev = evaluated[label]
        results[name] = generic_pair_check(f"{name} ({label})", ev["plan"],
                                           ev["args32"], reps, dev)

    # ---- one make_compute call per method, and pair_cell's share of it
    for label, ev in evaluated.items():
        compute, pc, args32 = ev["compute"], ev["pc"], ev["args32"]
        ms = call_ms(lambda: compute(*args32))
        pos, box, gvals, data = args32
        charge, sig_half, eps2 = params_mod.particle_params(data, gvals)
        _, tensors, _ = kernel_direct.cell_slots(
            pos, charge, sig_half, eps2, data["subsets"],
            data["exclusion_list"], box, pc.counts, pc.capacity)
        lam_nn = torch.ones((pc.nsub, pc.nsub), device=dev)
        kernel_ms = cuda_ms(lambda: cuda_direct.pair_cell(
            *tensors, lam_nn, lam_nn, box, pc, True,
            ev["plan"].num_particles), reps)
        print(f"generic {label}: make_compute {ms:.3f} ms a call (median of "
              f"{GENERIC_REPS}, CUDA events around each call), pair_cell "
              f"{kernel_ms:.4f} ms of it ({kernel_ms / ms:.1%}) "
              f"({ev['plan'].num_particles} atoms, {card})")

    # ---- the generic engine against the fused engine (B4 against B1), on
    # the fused engine's PME grid (the plan's aligned to its bricks)
    apply, state, cfg, (pos, box, gvals, data) = fused
    e_f, f_f, _ = apply(pos, box, gvals, data, state)
    ev = evaluated["rigid PME"]
    plan_f = dataclasses.replace(ev["plan"], pme_grid=cfg["pme_grid"],
                                 pme_moduli=cfg["pme_moduli"])
    out = engine_mod.make_compute(plan_f, True, True)(pos, box, gvals, data)
    card_gates(f"generic against fused (rigid PME on the {cfg['pme_grid']} "
               f"grid, both f32)", plan_f, out, (e_f, f_f),
               plan_f.global_defaults, names=("generic", "fused"))

    # ---- split switches: direct only + reciprocal only = one call
    plan, args32 = ev["plan"], ev["args32"]
    e_d, f_d = engine_mod.make_compute(plan, True, False)(*args32)
    e_r, f_r = engine_mod.make_compute(plan, False, True)(*args32)
    e_a, f_a = ev["out32"]
    e_err = float((e_d + e_r - e_a).abs().max()) / float(e_a.abs().max())
    f_err = float((f_d + f_r - f_a).abs().max()) / float(f_a.abs().max())
    check(e_err <= TOL_SPLIT and f_err <= TOL_SPLIT,
          f"generic split switches (rigid PME): slice energies {e_err:.3e}, "
          f"forces {f_err:.3e} of their max <= {TOL_SPLIT}")

    # ---- all pairs: NoCutoff and CutoffNonPeriodic on a drop of water
    waters = cluster_waters(pos_np, box_len, CLUSTER_NM)
    reset_launches()
    for method in ("NoCutoff", "CutoffNonPeriodic"):
        out = build_solute_system(nbt, waters, box_len, method)
        plan = plan_mod.build_plan(out[1], out[0])
        compute = engine_mod.make_compute(plan, True, True, with_aux=True)
        check(compute.route == "all_pairs",
              f"generic drop {method}: {plan.num_particles} atoms (the chain "
              f"and the waters within {CLUSTER_NM} nm of it), all pairs")
        args32 = card_inputs(plan, out[2], f32, dev)
        r32 = compute(*args32)
        r64 = compute(*card_inputs(plan, out[2], f64, dev))
        skip = None
        if method == "CutoffNonPeriodic":
            # the reaction-field force jumps at the cutoff (phase 11 above)
            pos = args32[0].double()
            r = torch.cdist(pos, pos)
            skip = ((r - plan.cutoff).abs() < 1e-6).any(dim=1)
            print(f"generic drop {method}: {int(skip.sum())} atoms with a "
                  f"pair within 1e-6 nm of the cutoff")
        # the chain's dE/dlambda_elec sums some 30,000 chain-water pair
        # energies of either sign to a few kJ/mol: their float32 rounding
        # leaves 1e-5 to 1e-4 kJ/mol
        skipped_err = card_gates(f"generic drop {method}", plan, r32[:2],
                                 r64[:2], plan.global_defaults, skip,
                                 deriv_floor=DROP_DERIV_FLOOR)
        if skip is not None:
            check(skipped_err <= DROP_JUMP,
                  f"generic drop {method}: atoms at the cutoff within the "
                  f"jump, max|dF| {skipped_err:.3e} <= {DROP_JUMP}")
        ms = call_ms(lambda: compute(*args32))
        print(f"generic drop {method}: make_compute {ms:.3f} ms a call "
              f"({plan.num_particles} atoms, {card})")
    check(not any(all_launches().values()),
          "generic drop: no hand-written kernel on the all-pairs route")


def fused_kernel_checks(suffix, plan, capacity, pos, box, gvals, data, reps,
                        cell_kernel, pme=True):
    """The fused engine's pair kernel (force-only and energies) and, with
    ``pme``, its three PME kernels at ``capacity`` slots a cell against
    their plain twins, at the state ``pos`` (float32 on the card): the
    kernels-line entries ``<kernel><suffix>`` with their bounds."""
    import torch
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN
    prepare, _, cfg = fused_mod.make_fused_engine(
        plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    pc = cfg["pair"]
    st = prepare(pos, box, gvals, data)
    check(int(st["overflow"]) == 0,
          f"{suffix[1:]}: no cell overflow at {pc.capacity} slots a cell")
    n = plan.num_particles
    base = pos if cell_kernel else st["pos0w"]
    slot_pos = (torch.cat([base, base.new_zeros((1, 3))])[st["slots"]]
                .reshape(pc.n_cells, pc.capacity, 3).transpose(1, 2)
                + st["padfix3"]).contiguous()
    lam = slice_lambdas(plan.lam_source, gvals)
    sl_tab = torch.as_tensor(plan.slice_table, dtype=torch.int64,
                             device=pos.device)
    lam_c_nn = lam[:, 0][sl_tab].contiguous()
    lam_v_nn = lam[:, 1][sl_tab].contiguous()
    n_pair, n_excl = pair_counts(slot_pos, st["table"], st["sexcl"], box,
                                 plan.cutoff, n, pc.counts)
    print(f"{suffix[1:]}: cells {pc.counts} x {pc.capacity} slots, "
          f"{n_pair} pairs within the cutoff, {n_excl} excluded pairs")
    kernel = "pair_cell" if cell_kernel else "pair_column"
    out = {}
    for energies in (False, True):
        name = kernel + ("_energies" if energies else "") + suffix
        args = (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
                st["sexcl"], lam_c_nn, lam_v_nn, box, pc, energies, n)
        out[name] = pair_kernel_check(
            name, getattr(cuda_direct, kernel),
            getattr(cuda_direct, kernel + "_plain"), args, pc, reps,
            cell_kernel=cell_kernel)
        out[name]["bound_ms"], out[name]["bound_by"] = pair_bound(
            pc, energies, n_pair, n_excl if cell_kernel else 0,
            cell_kernel=cell_kernel)
    if pme:
        out.update(pme_kernel_checks(
            tuple(k + suffix for k in ("pme_spread", "pme_spread_energies",
                                       "pme_interp")),
            slot_pos, st, box, cfg, plan, lam_c_nn, reps))
    return out


def cutoff_pairs(plan, pos64, box_len, dev, delta=1e-6):
    """(atoms with a pair whose minimum-image distance lies within
    ``delta`` of the cutoff, as a bool mask, and the force jump at the
    cutoff such an atom may see): float32 and float64 may put such a pair
    on either side.  Under Ewald, PME and LJPME the real-space Coulomb
    force jumps there by k qi qj (erfc(a rc) / rc^2 + 2 a / sqrt(pi)
    exp(-(a rc)^2) / rc), 0.38 kJ/mol/nm for two water oxygens at the
    benchmark's cutoff; 0.1 kJ/mol/nm covers the Lennard-Jones jump and
    the rest of the error (phase 11's reaction-field exception, with the
    Ewald-family jump).  Cubic box, pairs in float64 on the card."""
    import torch
    from nonbondedslicing_tpu_torch.utils.constants import (ONE_4PI_EPS0,
                                                            SQRT_PI)
    pos = torch.as_tensor(np.asarray(pos64), device=dev).double()
    n = pos.shape[0]
    hits = torch.zeros(n, dtype=torch.int64, device=dev)
    for i0 in range(0, n, 1024):
        d = pos[i0:i0 + 1024, None, :] - pos[None, :, :]
        d = d - box_len * torch.round(d / box_len)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        hits[i0:i0 + 1024] = ((r - plan.cutoff).abs() < delta).sum(dim=1)
    rc, a = plan.cutoff, plan.ewald_alpha
    qmax = float(np.abs(plan.base_params[:, 0]).max())
    per_pair = ONE_4PI_EPS0 * qmax * qmax * (
        math.erfc(a * rc) / rc ** 2
        + 2.0 * a / SQRT_PI * math.exp(-(a * rc) ** 2) / rc)
    return (hits > 0).cpu().numpy(), int(hits.max()) * per_pair + 0.1


def state_gates(label, st32, st64, skip=None, jump=0.0):
    """Phase 4's gates between two Context states (getState with energy,
    forces and dE/dlambda): float32 against float64.  ``skip`` (a bool
    mask, :func:`cutoff_pairs`) holds its atoms to the force ``jump``
    instead."""
    e32, e64 = st32.getPotentialEnergy(), st64.getPotentialEnergy()
    f32 = np.asarray(st32.getForces())
    f64 = np.asarray(st64.getForces())
    d32 = st32.getEnergyParameterDerivatives()
    d64 = st64.getEnergyParameterDerivatives()
    rel_e = abs(e32 - e64) / abs(e64)
    fmax = float(np.abs(f64).max())
    df = np.abs(f32 - f64).max(axis=1)
    skipped = 0.0
    if skip is not None and skip.any():
        skipped = float(df[skip].max())
        df = np.where(skip, 0.0, df)
    f_err = float(df.max()) / fmax
    rel_d = max([abs(d32[k] - d64[k]) / max(abs(d64[k]), 1.0)
                 for k in d64] + [0.0])
    worst = int(df.argmax())
    print(f"{label}: E single {e32:.6f}, double {e64:.6f} kJ/mol; "
          f"dE/dlambda single {d32}, double {d64}; max|F| {fmax:.1f}; "
          f"largest force error on atom {worst}: {f32[worst].tolist()} "
          f"against {f64[worst].tolist()}")
    check(math.isfinite(e32) and rel_e <= TOL_EVAL_ENERGY,
          f"{label}: relative energy error {rel_e:.3e} <= {TOL_EVAL_ENERGY}")
    check(f_err <= TOL_EVAL_FORCE,
          f"{label}: force error {f_err:.3e} of max|F| <= {TOL_EVAL_FORCE}"
          + ("" if skip is None else
             f" ({int(skip.sum())} atoms with a pair within 1e-6 nm of the "
             f"cutoff left out)"))
    if skip is not None and skip.any():
        check(skipped <= jump,
              f"{label}: atoms at the cutoff within the jump, max|dF| "
              f"{skipped:.3e} <= {jump:.3f}")
    check(rel_d <= TOL_EVAL_DERIV,
          f"{label}: relative dE/dlambda error {rel_d:.3e} <= "
          f"{TOL_EVAL_DERIV} (denominator at least 1 kJ/mol)")


def ctx_arrays(ctx):
    """A Context's positions and velocities as float64 tensors."""
    import torch
    st = ctx.getState(getPositions=True, getVelocities=True)
    return (torch.as_tensor(np.asarray(st.getPositions())),
            torch.as_tensor(np.asarray(st.getVelocities())))


def full_state(ctx, **kw):
    return ctx.getState(getEnergy=True, getForces=True,
                        getParameterDerivatives=True, **kw)


def only_run(ctx, force):
    """The one make_md_step run a Context's step() calls built."""
    runs = ctx._compiled[id(force)].md[DT_PS]["runs"]
    check(len(runs) == 1, f"context: one MD step built ({list(runs)})")
    return next(iter(runs.values()))


def context_md(label, ctx, force, masses, first_water, n_waters, card,
               reset_launches, launches, other=None,
               n_timed=CONTEXT_TIMED_CHUNKS, n_dof=None):
    """A warm-up and ``n_timed`` timed step(CHUNK_STEPS) calls of a Context
    on the card, counted: its one MD step replays the graph it captured in
    the warm-up and captures none after it, the force-only pair kernel runs
    once a step and its energies variant once a call; phase 5's MD gates.
    ``other`` (a callable) runs one CHUNK_STEPS chunk of the same MD by
    another way: it follows each Context chunk, and the timed rounds run
    the two in turns, Context first in the even rounds and ``other`` first
    in the odd ones, each timed and counted apart.  ``n_dof`` (the degrees
    of freedom of the temperature) defaults to the rigid waters'.  Returns
    (its run, the Context's launches, sorted ms/step of the Context and of
    ``other``)."""
    import torch
    integrator = ctx.getIntegrator()
    n = len(masses)
    reset_launches()
    made = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    def context_chunk():
        before = launches()
        chunk_s.append(timed(lambda: integrator.step(CHUNK_STEPS)))
        for key, value in launches().items():
            made[key] = made.get(key, 0) + value - before.get(key, 0)

    chunk_s, other_s = [], []
    for i in range(1 + n_timed):
        if other is not None and i % 2 == 1:
            other_s.append(timed(other))
        context_chunk()
        if other is not None and i % 2 == 0:
            other_s.append(timed(other))
        if i == 0:
            run = only_run(ctx, force)
            captured = run.stats["captures"]
    print(f"{label}: config {run.config}; graph {run.stats}; warm-up "
          f"{chunk_s[0]:.2f} s, timed {[round(t, 3) for t in chunk_s[1:]]} "
          f"s; launches { {k: v for k, v in made.items() if v} }")
    check(only_run(ctx, force) is run and run.config["graph"]
          and run.stats["captures"] == captured,
          f"{label}: no capture after the warm-up ({captured} in it, "
          f"{run.stats['replays']} replays)")
    pair = "pair_cell" if first_water else "pair_column"
    steps = (1 + n_timed) * CHUNK_STEPS
    check(made[pair] == steps and made[pair + "_energies"] == 1 + n_timed,
          f"{label}: {pair} launched once a step ({made[pair]} in "
          f"{steps}), its energies variant once a step() call")
    p, v = ctx_arrays(ctx)
    energy = ctx.getState(getEnergy=True).getPotentialEnergy()
    ms = md_checks(label, p, v, energy, masses, first_water,
                   n_dof or 3 * n - 3 * n_waters - 3, chunk_s, n, card)
    return run, made, ms, sorted(1e3 * t / CHUNK_STEPS for t in other_s[1:])


def api_phase(dev, card, reset_launches, results, run_launches, pos_np,
              vel_np, box_len, capacity, reps):
    """Phase 12: the user API on the card (see the module docstring)."""
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import ewald
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             SIMPLE_WINDOW,
                                                             make_md_step)
    f32 = torch.float32
    cuda_platform = nbt.Platform.getPlatformByName("CUDA")
    reference = nbt.Platform.getPlatformByName("Reference")

    def launches():
        return all_launches()

    def context(system, platform, pos, vel=None, params=None):
        ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS), platform)
        ctx.setPositions(pos)
        if vel is not None:
            ctx.setVelocities(vel)
        for name, value in (params or {}).items():
            ctx.setParameter(name, value)
        return ctx

    # ---- (a) the rigid box through the Context, against make_md_step
    system, force, _, constraints = build_system(nbt)
    add_constraints(system, constraints)
    masses = np.tile(WATER_MASSES, N_MOLECULES)
    n = len(masses)
    ctx = context(system, cuda_platform, pos_np, vel_np)
    box = torch.as_tensor(np.diag([box_len] * 3), device=dev).to(f32)
    gvals = torch.ones(2, device=dev)
    direct = {"p": torch.as_tensor(pos_np, device=dev).to(f32),
              "v": torch.as_tensor(vel_np, device=dev).to(f32)}

    def direct_chunk():
        """One chunk of make_md_step at the Context's K and capacity, from
        the state the Context started from."""
        if "run" not in direct:
            config = only_run(ctx, force).config
            direct["run"] = make_md_step(
                ctx._compiled[id(force)].plan, masses, dt=DT_PS, dtype=f32,
                cell_capacity=config["capacity"],
                reuse_steps=config["reuse_steps"], constraints=constraints)
            direct["data"] = engine_mod.plan_data(
                ctx._compiled[id(force)].plan, device=dev, dtype=f32)
        direct["p"], direct["v"], _ = direct["run"](
            direct["p"], direct["v"], box, gvals, direct["data"],
            CHUNK_STEPS)

    run, made, ms_ctx, ms_direct = context_md(
        "context md", ctx, force, masses, 0, N_MOLECULES, card,
        reset_launches, launches, other=direct_chunk,
        n_timed=CONTEXT_ALTERNATED_CHUNKS)
    check_launches("context md", "context", made)
    run_launches["context"] = made
    K, cap = run.config["reuse_steps"], run.config["capacity"]
    data = direct["data"]
    p_ctx, v_ctx = ctx_arrays(ctx)
    check(torch.equal(direct["p"].double().cpu(), p_ctx)
          and torch.equal(direct["v"].double().cpu(), v_ctx),
          f"context md: {(1 + CONTEXT_ALTERNATED_CHUNKS) * CHUNK_STEPS} "
          f"steps equal to make_md_step's to the bit (K {K}, capacity {cap})")
    print(f"context md: Context {np.median(ms_ctx):.3f} ms/step (range "
          f"{ms_ctx[0]:.3f}-{ms_ctx[-1]:.3f}), make_md_step "
          f"{np.median(ms_direct):.3f} (range {ms_direct[0]:.3f}-"
          f"{ms_direct[-1]:.3f}), {CONTEXT_ALTERNATED_CHUNKS} chunks each in "
          f"turns, K {K}, capacity {cap} ({n} atoms, {card})")
    results.update(fused_kernel_checks(
        "_context", ctx._compiled[id(force)].plan, cap,
        torch.as_tensor(pos_np, device=dev).to(f32), box, gvals, data, reps,
        cell_kernel=False))

    # ---- (e) a checkpoint and the same 200 steps twice
    blob = ctx.createCheckpoint()
    ctx.getIntegrator().step(CHUNK_STEPS)
    first = ctx_arrays(ctx)
    ctx.loadCheckpoint(blob)
    ctx.getIntegrator().step(CHUNK_STEPS)
    again = ctx_arrays(ctx)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"checkpoint: {CHUNK_STEPS} steps from a loaded checkpoint equal "
          f"the steps from the saved state to the bit ({len(blob)} bytes)")

    # ---- (d) parameters without a new capture
    comp = ctx._compiled[id(force)]
    addresses = {k: t.data_ptr() for k, t in comp.data.items()}
    stats = dict(run.stats)
    ctx.setParameter("lambda01", 0.5)
    q, sig, eps = force.getParticleParameters(0)
    force.setParticleParameters(0, 0.5 * q, sig, eps)
    force.updateParametersInContext(ctx)
    saved = ctx_arrays(ctx)
    ctx.getIntegrator().step(CHUNK_STEPS)
    check(only_run(ctx, force) is run
          and run.stats["captures"] == stats["captures"]
          and run.stats["replays"] > stats["replays"]
          and {k: t.data_ptr() for k, t in comp.data.items()} == addresses,
          f"parameters: setParameter and updateParametersInContext keep the "
          f"graph and the data tensors ({stats} -> {run.stats})")
    # the graph captured before the update integrates with the new charge
    # and lambda: the same steps in a Context built with them
    rebuilt = context(system, cuda_platform, saved[0].numpy(),
                      saved[1].numpy(), params={"lambda01": 0.5})
    rebuilt.getIntegrator().step(CHUNK_STEPS)
    r_run = only_run(rebuilt, force)
    check(r_run.config["reuse_steps"] == K and r_run.config["capacity"] == cap
          and all(torch.equal(a, b) for a, b in zip(ctx_arrays(ctx),
                                                     ctx_arrays(rebuilt))),
          f"parameters: {CHUNK_STEPS} steps after the update equal to the bit "
          f"those of a Context built with the new parameters from the same "
          f"state (K {r_run.config['reuse_steps']}, capacity "
          f"{r_run.config['capacity']})")
    st_a, st_b = full_state(ctx), full_state(rebuilt)
    d_a = st_a.getEnergyParameterDerivatives()
    d_b = st_b.getEnergyParameterDerivatives()
    print(f"parameters: E {st_a.getPotentialEnergy()!r} against the "
          f"rebuilt Context's {st_b.getPotentialEnergy()!r} kJ/mol, "
          f"dE/dlambda {d_a} against {d_b}")
    check(st_a.getPotentialEnergy() == st_b.getPotentialEnergy()
          and d_a == d_b,
          "parameters: energy and dE/dlambda equal to the rebuilt "
          "Context's to the bit")

    # ---- (b) the solute box through the Context
    (s_system, s_force, s_pos_np, s_masses, s_constraints, s_bonds,
     kept) = build_solute_system(nbt, pos_np, box_len)
    add_constraints(s_system, s_constraints)
    add_bonds(nbt, s_system, s_bonds)
    n_waters = (len(s_masses) - SOLUTE_SITES) // 3
    s_ctx = context(s_system, cuda_platform, s_pos_np,
                    solute_velocities(vel_np, kept))
    s_run, made, _, _ = context_md("context solute md", s_ctx, s_force,
                                   s_masses, SOLUTE_SITES, n_waters, card,
                                   reset_launches, launches)
    check_launches("context solute md", "context_solute", made)
    run_launches["context_solute"] = made
    s_comp = s_ctx._compiled[id(s_force)]
    results.update(fused_kernel_checks(
        "_context_solute", s_comp.plan, s_run.config["capacity"],
        torch.as_tensor(s_pos_np, device=dev).to(f32), box,
        torch.as_tensor(s_comp.plan.global_defaults, device=dev).to(f32),
        s_comp.data, reps, cell_kernel=True))

    # ---- (c) getState: float32 (K3 on the kernel route) against float64,
    # with phase 11's exception: atoms with a pair at the cutoff are held
    # to the force jump there
    reset_launches()
    for label, c, f, sys_, params in (
            ("getState rigid", ctx, force, system, {"lambda01": 0.5}),
            ("getState solute", s_ctx, s_force, s_system, None)):
        p_c, _ = ctx_arrays(c)
        skip, jump = cutoff_pairs(c._compiled[id(f)].plan, p_c.numpy(),
                                  box_len, dev)
        print(f"{label}: {int(skip.sum())} atoms with a pair within 1e-6 nm "
              f"of the cutoff; the force jump there is at most {jump:.3f} "
              f"kJ/mol/nm")
        state_gates(label, full_state(c),
                    full_state(context(sys_, reference, p_c.numpy(),
                                       params=params)),
                    skip, jump)
    # the reciprocal part in its own force group
    force.setReciprocalSpaceForceGroup(1)
    ctx.reinitialize(preserveState=True)
    parts = [full_state(ctx, groups=g) for g in ({0}, {1}, None)]
    e_d, e_r, e_a = (st.getPotentialEnergy() for st in parts)
    f_d, f_r, f_a = (np.asarray(st.getForces()) for st in parts)
    e_err = abs(e_d + e_r - e_a) / abs(e_a)
    f_err = float(np.abs(f_d + f_r - f_a).max() / np.abs(f_a).max())
    print(f"getState groups: direct {e_d:.6f} + reciprocal {e_r:.6f} "
          f"against {e_a:.6f} kJ/mol")
    check(e_err <= TOL_SPLIT and f_err <= TOL_SPLIT,
          f"getState groups: direct + reciprocal = total, energy {e_err:.3e},"
          f" forces {f_err:.3e} of max|F| <= {TOL_SPLIT}")
    made = launches()
    print(f"getstate: launches { {k: v for k, v in made.items() if v} }")
    check_launches("getstate", "getstate", made)
    run_launches["getstate"] = made
    comp = ctx._compiled[id(force)]
    p_c, _ = ctx_arrays(ctx)
    results["pair_cell_energies_getstate"] = generic_pair_check(
        "pair_cell_energies_getstate", comp.plan,
        (p_c.to(dev, f32), box, ctx._gvals(comp), comp.data), reps, dev)

    # ---- (f) bare Ewald through the fused MD step
    e_system, e_force, _, _ = build_system(nbt, "Ewald")
    e_plan = plan_mod.build_plan(e_force, e_system)
    pos = torch.as_tensor(pos_np, device=dev).to(f32)
    e_data = engine_mod.plan_data(e_plan, device=dev, dtype=f32)
    prepare, apply, cfg = fused_mod.make_fused_engine(
        e_plan, cell_capacity=capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    n_kvec = len(ewald.half_space_kvectors(e_plan.ewald_kmax))
    print(f"ewald: {n_kvec} half-space k-vectors (kmax {e_plan.ewald_kmax}),"
          f" alpha {e_plan.ewald_alpha:.4f}, "
          f"cells {cfg['counts']} x {cfg['capacity']}, skin "
          f"{cfg['skin']:.4f} nm, pair kernel mode {cfg['pair'].mode}")
    out32 = apply(pos, box, gvals, e_data, prepare(pos, box, gvals, e_data))
    f64 = torch.float64
    out64 = engine_mod.make_compute(e_plan, True, True)(
        pos.to(f64), box.to(f64), gvals.to(f64),
        engine_mod.plan_data(e_plan, device=dev, dtype=f64))
    card_gates("ewald evaluation", e_plan, out32[:2], out64,
               e_plan.global_defaults, names=("fused f32", "generic f64"))
    results.update(fused_kernel_checks("_ewald", e_plan, capacity, pos, box,
                                       gvals, e_data, reps,
                                       cell_kernel=False, pme=False))

    def make_ewald_run(cap, reuse):
        return make_md_step(e_plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints)

    reset_launches()
    chunks = Chunks(make_ewald_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, pos, torch.as_tensor(vel_np, device=dev).to(f32), box, gvals,
        e_data, EWALD_TIMED_CHUNKS)
    made = launches()
    print(f"ewald md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s")
    check(config["graph"], "ewald md: the K-step windows run as CUDA graphs")
    check_launches("ewald md", "ewald", made)
    launch_report("ewald md", chunks, made, "pair_column")
    md_checks("ewald md", p, v, energy, masses, 0, 3 * n - 3 * N_MOLECULES - 3,
              chunk_s, n, card)
    run_launches["ewald"] = made
    graph_against_eager("ewald graph", make_ewald_run, capacity, pos,
                        torch.as_tensor(vel_np, device=dev).to(f32), box,
                        gvals, e_data, reset_launches, card)

    # ---- (g) the per-step rebuild: a cube of fewer than 3 cells per axis
    c_pos, c_vel, c_edge = water_cube(pos_np, vel_np, box_len, CUBE_NM)
    c_waters = len(c_pos) // 3
    c_system, c_force, c_constraints = water_system(nbt, c_waters, c_edge)
    add_constraints(c_system, c_constraints)
    c_masses = np.tile(WATER_MASSES, c_waters)
    c_plan = plan_mod.build_plan(c_force, c_system)
    check(fused_mod.fused_config(c_plan) is None,
          f"cube: {len(c_pos)} atoms ({c_waters} whole waters) in a "
          f"{c_edge:.4f} nm box ({len(c_pos) / c_edge ** 3:.1f} atoms/nm^3), "
          f"PME grid {c_plan.pme_grid}: no cell grid, so "
          f"make_md_step takes the per-step rebuild")
    c_ctx = context(c_system, cuda_platform, c_pos, c_vel)
    c_dof = 3 * len(c_pos) - 3 * c_waters - 3
    reset_launches()

    def sampled(chunks):
        """The mean temperature of ``chunks`` step() calls of one graphed
        window each, one sample after each: the cube's temperature
        fluctuates by sqrt(2 / n_dof), 7.5 K, at a sample."""
        temps = []
        for _ in range(chunks):
            c_ctx.getIntegrator().step(SIMPLE_WINDOW)
            _, v = ctx_arrays(c_ctx)
            temps.append(float(np.sum(c_masses[:, None] * v.numpy() ** 2))
                         / (KB * c_dof))
        return float(np.mean(temps))

    temps = []
    for _ in range(CUBE_EQUILIBRATION):
        # the cut's fresh surfaces relax and heat the cube: rescale the
        # velocities to 300 K by each chunk's mean, as a user equilibrates
        temp = sampled(100 // SIMPLE_WINDOW)
        temps.append(round(temp, 1))
        c_ctx.setVelocities(ctx_arrays(c_ctx)[1].numpy()
                            * np.sqrt(300.0 / temp))
    torch.cuda.synchronize()
    t0 = time.time()
    c_ctx.getIntegrator().step(CHUNK_STEPS)
    torch.cuda.synchronize()
    cube_s = time.time() - t0
    temp = sampled(CHUNK_STEPS // SIMPLE_WINDOW)
    made = launches()
    c_run = only_run(c_ctx, c_force)
    print(f"cube: mean temperatures of the equilibration chunks {temps} K, "
          f"of the {CHUNK_STEPS} steps after the timed ones {temp:.1f} K; "
          f"config {c_run.config}; graph {c_run.stats}")
    check(c_run.config["route"] == "all_pairs"
          and c_run.config["reuse_steps"] == 1 and c_run.config["graph"]
          and c_run.stats["captures"] >= 1 and c_run.stats["replays"] > 0,
          "cube: the per-step rebuild on all pairs, its windows graphed")
    check_launches("cube md", "simple", made)
    p, v = ctx_arrays(c_ctx)
    md_checks("cube md", p, v, c_ctx.getState(getEnergy=True)
              .getPotentialEnergy(), c_masses, 0, c_dof, [0.0, cube_s],
              len(c_pos), card, temp=temp)
    skip, jump = cutoff_pairs(c_plan, p.numpy(), c_edge, dev)
    state_gates("getState cube", full_state(c_ctx),
                full_state(context(c_system, reference, p.numpy())),
                skip, jump)
    # its graph against its eager body, two windows from the state reached
    for dtype in (torch.float64, f32):
        run = make_md_step(c_plan, c_masses, dt=DT_PS, dtype=dtype,
                           constraints=c_constraints)
        args = (torch.as_tensor(np.diag([c_edge] * 3), device=dev).to(dtype),
                torch.ones(2, device=dev, dtype=dtype),
                engine_mod.plan_data(c_plan, device=dev, dtype=dtype))
        p_w, v_w, _ = run(p.to(dev, dtype), v.to(dev, dtype), *args,
                          SIMPLE_WINDOW)
        (p_g, v_g, e_g), (p_e, v_e, e_e) = (
            fn(p_w, v_w, *args, 2 * SIMPLE_WINDOW)
            for fn in (run, run.eager))
        print(f"cube graph {dtype}: {2 * SIMPLE_WINDOW} steps, graph against "
              f"eager: max|dx| {float((p_g - p_e).abs().max()):.3e} nm, "
              f"energy {float(e_g)!r} against {float(e_e)!r} kJ/mol "
              f"({run.stats})")
        check(run.stats["captures"] == 1 and run.stats["replays"] == 2
              and torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
              and float(e_g) == float(e_e),
              f"cube graph {dtype}: two replayed windows, positions, "
              f"velocities and energy equal to the eager body's to the bit")


def chain_constraint_error(p):
    """Largest |distance - BOND_R0| of the chain's 1-2 pairs (nm)."""
    x = p.double().cpu().numpy()[:SOLUTE_SITES]
    return float(np.abs(np.linalg.norm(x[1:] - x[:-1], axis=1)
                        - BOND_R0).max())


def pinv_solve(self, J, b):
    """The wide clusters' solve before CGLS, ``torch.linalg.pinv``, which
    synchronizes with the host (no capture): only timed, for the record,
    in place of ``GatherConstrainer._solve`` on a system whose clusters
    are all wider than 3."""
    import torch
    return torch.einsum("...kl,...l->...k", torch.linalg.pinv(J), b)


def constrained_phase(dev, card, reset_launches, results, run_launches,
                      pos_np, vel_np, box_len, capacity, solute_ms):
    """Phase 13: the constrained solute box graphed, the native library,
    the example (see the module docstring).  ``capacity`` is phase 6's
    (the same positions give the same slot tables), ``solute_ms`` phase
    9's ms/step of the solute box's graph and eager body."""
    import importlib.util
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    from nonbondedslicing_tpu_torch.ops.dispersion import \
        calc_dispersion_corrections
    from nonbondedslicing_tpu_torch.runtime import constraints as cons_mod
    from nonbondedslicing_tpu_torch.runtime import native
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    f32 = torch.float32

    # ---- (a) the solute box with its chain rigid along its bonds
    t0 = time.time()
    (system, force, s_pos_np, masses, water_cons, bonds,
     kept) = build_solute_system(nbt, pos_np, box_len)
    triples, bonds13 = chain_constraints(water_cons, bonds)
    constraints = cons_mod.cluster_constraints(triples, len(masses))
    plan = plan_mod.build_plan(force, system)
    n = plan.num_particles
    n_waters = (n - SOLUTE_SITES) // 3
    width = constraints[0].shape[1]
    print(f"constrained: {n} atoms, {len(triples)} constraints in "
          f"{constraints[0].shape[0]} clusters of width {width} (the chain's "
          f"{SOLUTE_SITES - 1}; {n_waters} water triangles padded to it), "
          f"{cons_mod.cgls_iterations(width)} CGLS iterations a solve, "
          f"{len(bonds13)} harmonic 1-3 bonds, built in "
          f"{time.time() - t0:.1f} s")
    check(width == SOLUTE_SITES - 1 and len(triples) == 3 * n_waters
          + SOLUTE_SITES - 1, f"constrained: one {SOLUTE_SITES - 1}-wide "
          f"cluster, every water triangle padded to it")
    box = torch.as_tensor(np.diag([box_len] * 3), device=dev).to(f32)
    gvals = torch.as_tensor(plan.global_defaults, device=dev).to(f32)
    data = engine_mod.plan_data(plan, device=dev, dtype=f32)
    pos0 = torch.as_tensor(s_pos_np, device=dev).to(f32)
    vel0 = torch.as_tensor(solute_velocities(vel_np, kept), device=dev).to(f32)
    n_dof = 3 * n - len(triples) - 3

    def make_run(cap, reuse):
        return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints, bonds=bonds13)

    reset_launches()
    chunks = Chunks(make_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(chunks, pos0, vel0, box, gvals,
                                           data, SOLUTE_TIMED_CHUNKS)
    launches = all_launches()
    print(f"constrained md: config {config}; graph {chunks.run.stats}; "
          f"warm-up chunk {chunk_s[0]:.2f} s, timed chunks "
          f"{[round(t, 3) for t in chunk_s[1:]]} s; launches {launches}")
    check(config["graph"] and chunks.graph_stats()[0] > 0,
          f"constrained md: the K-step windows run as CUDA graph replays "
          f"({chunks.graph_stats()[0]}; the {width}-wide solve is "
          f"captured)")
    check_launches("constrained md", "constrained", launches)
    launch_report("constrained md", chunks, launches, "pair_cell")
    c_err = chain_constraint_error(p)
    check(c_err <= TOL_CONSTRAINT, f"constrained md: the chain's 1-2 "
          f"distances within {c_err:.3e} nm of {BOND_R0} (<= "
          f"{TOL_CONSTRAINT})")
    ms_md = md_checks("constrained md", p, v, energy, masses, SOLUTE_SITES,
                      n_dof, chunk_s, n, card)
    run_launches["constrained"] = launches
    # the kernels at this path's shapes: phase 6's checks (the same plan,
    # positions and capacity give the same slot tables)
    for k, k6 in (("pair_cell", "pair_cell"),
                  ("pair_cell_energies", "pair_cell_energies"),
                  ("pme_spread", "pme_spread_solute"),
                  ("pme_spread_energies", "pme_spread_energies_solute"),
                  ("pme_interp", "pme_interp_solute")):
        results[k + "_constrained"] = results[k6]

    # the evaluation at the state the MD reached: card f32 against the
    # same code on CPU tensors in float64
    prepare, apply, _ = fused_mod.make_fused_engine(
        plan, cell_capacity=chunks.capacity, target_skin=DEFAULT_SKIN,
        energies=True)
    evaluation_check("constrained evaluation", plan, chunks.capacity, apply,
                     prepare(p, box, gvals, data), p, box, gvals, data,
                     p.double().cpu().numpy(), np.diag([box_len] * 3),
                     plan.global_defaults)

    # the graph against its eager body, and the eager body with the
    # pseudo-inverse the wide solve replaced, in turns
    run, (p, v), ms = graph_against_eager(
        "constrained graph", make_run, chunks.capacity, pos0, vel0, box,
        gvals, data, reset_launches, card)
    cgls = cons_mod.GatherConstrainer._solve
    ms["eager (pinv)"] = []
    for name in ("eager (pinv)", "graph", "graph", "eager (pinv)"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "graph":
            p, v, _ = run(p, v, box, gvals, data, CHUNK_STEPS)
        else:
            cons_mod.GatherConstrainer._solve = pinv_solve
            try:
                p, v, _ = run.eager(p, v, box, gvals, data, CHUNK_STEPS)
                torch.cuda.synchronize()
            finally:
                cons_mod.GatherConstrainer._solve = cgls
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / CHUNK_STEPS)
    c_err = chain_constraint_error(p)
    check(c_err <= TOL_CONSTRAINT, f"constrained graph: the chain's 1-2 "
          f"distances within {c_err:.3e} nm after the timed chunks")
    med = {k: float(np.median(x)) for k, x in ms.items()}
    print(f"constrained: ms/step, {CHUNK_STEPS}-step chunks in this call: "
          f"graph {med['graph']:.3f} {[round(x, 3) for x in ms['graph']]}, "
          f"eager (CGLS) {med['eager']:.3f} "
          f"{[round(x, 3) for x in ms['eager']]}, eager (pinv) "
          f"{med['eager (pinv)']:.3f} "
          f"{[round(x, 3) for x in ms['eager (pinv)']]}; phase 9's solute "
          f"box (3-wide clusters): graph {np.median(solute_ms['graph']):.3f}"
          f", eager {np.median(solute_ms['eager']):.3f}; phase 13's MD "
          f"median {np.median(ms_md):.3f} ({n} atoms, {card})")

    # the same system through the user API
    c_system = build_solute_system(nbt, pos_np, box_len)[0]
    for i, j, d in triples:
        c_system.addConstraint(i, j, d)
    add_bonds(nbt, c_system, bonds13)
    c_force = [f for f in c_system.getForces()
               if isinstance(f, nbt.SlicedNonbondedForce)][0]
    ctx = nbt.Context(c_system, nbt.VerletIntegrator(DT_PS),
                      nbt.Platform.getPlatformByName("CUDA"))
    ctx.setPositions(s_pos_np)
    ctx.setVelocities(solute_velocities(vel_np, kept))

    def launches_now():
        return all_launches()

    c_run, made, _, _ = context_md(
        "context constrained md", ctx, c_force, masses, SOLUTE_SITES,
        n_waters, card, reset_launches, launches_now, n_dof=n_dof)
    check(c_run.config["graph"] and c_run.stats["replays"] > 0,
          f"context constrained md: graph replays ({c_run.stats})")
    check_launches("context constrained md", "constrained", made)
    c_err = chain_constraint_error(ctx_arrays(ctx)[0])
    check(c_err <= TOL_CONSTRAINT, f"context constrained md: the chain's "
          f"1-2 distances within {c_err:.3e} nm of {BOND_R0}")

    # ---- (b) the native host library
    lib = native.get_lib()
    check(lib is not None and native.LAST_BUILD["error"] is None,
          f"native: {native.LAST_BUILD['path']} built and loaded "
          f"({native.LAST_BUILD['build_seconds']:.2f} s of g++; error "
          f"{native.LAST_BUILD['error']})")
    t0 = time.perf_counter()
    nat = calc_dispersion_corrections(force)
    t_nat = time.perf_counter() - t0
    get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        t0 = time.perf_counter()
        py = calc_dispersion_corrections(force)
        t_py = time.perf_counter() - t0
    finally:
        native.get_lib = get_lib
    rel = float(np.max(np.abs(nat - py) / np.maximum(np.abs(py), 1e-300)))
    print(f"native: dispersion coefficients {nat.tolist()} kJ/mol nm^3, "
          f"the Python loop's {py.tolist()} ({n} particles; {t_nat:.3f} s "
          f"against {t_py:.3f} s on the host)")
    check(rel <= 1e-8, f"native: dispersion corrections of the solute box "
          f"match the Python class loop, {rel:.3e} relative <= 1e-8")

    # ---- (c) the example, on the card
    spec = importlib.util.spec_from_file_location(
        "lambda_sweep_torch", os.path.join(ROOT, "examples",
                                           "lambda_sweep_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.time()
    energies, derivs, e_md = example.main([])
    check(len(energies) == 5 and math.isfinite(e_md),
          f"example: examples/lambda_sweep_torch.py on the card passed its "
          f"linearity assertion and {example.MD_STEPS} MD steps "
          f"({time.time() - t0:.1f} s)")


def card_inputs(plan, p_np, dtype, dev):
    """Positions, box, globals and data of ``plan`` on ``dev`` in
    ``dtype``."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return (t(p_np), t(plan.box0), t(plan.global_defaults),
            engine_mod.plan_data(plan, device=dev, dtype=dtype))


def launch_counters():
    """The kernel wrappers' launch counters."""
    from nonbondedslicing_tpu_torch.ops import cuda_direct, cuda_pme
    from nonbondedslicing_tpu_torch.runtime import water_tail
    return (cuda_direct.LAUNCHES, cuda_pme.LAUNCHES, water_tail.LAUNCHES)


def all_launches():
    """Every hand-written kernel's launch count, by variant."""
    out = {}
    for counts in launch_counters():
        out.update(counts)
    return out


def sharded_rank(group, device, configs, md):
    """Phase 14's work in one rank of ``group`` on ``device`` (called by
    ``torch_parallel_cases.run_ranks``): each configuration (label, plan,
    positions) through ``make_sharded_compute`` in float32 once, with the
    kernels' launches of that call counted (the counts are set to 0 just
    before); then, not counted, its direct space alone, the collectives of
    one call (shape, dtype, bytes of each all_reduce; the int64 PME grids
    as the all_reduce left them) and its ms a call;
    with ``md`` (plan, positions, velocities, masses, steps, dt) the
    harness ``make_multichip_md_step`` in float64.  Returns numpy arrays
    and numbers."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.parallel import collectives, mesh
    dev = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    computes = []
    for counts in launch_counters():
        for key in counts:
            counts[key] = 0
    out = {}
    for label, plan, p_np in configs:
        compute = mesh.make_sharded_compute(plan, group)
        args = card_inputs(plan, p_np, f32, dev)
        before = all_launches()
        e, f = compute(*args)
        torch.cuda.synchronize()
        out[label] = dict(
            route=compute.route, e=e.cpu().numpy(), f=f.cpu().numpy(),
            launched={k: v - before[k] for k, v in all_launches().items()
                      if v != before[k]})
        computes.append((label, plan, compute, args))
    for label, plan, compute, args in computes:
        direct = engine_mod.make_compute(plan, True, False,
                                         neighbor=compute.route, shard=group)
        out[label]["f_direct"] = direct(*args)[1].cpu().numpy()
        reduced, grids = [], []
        real = collectives.all_reduce

        def counted(tensor, g):
            reduced.append((tuple(tensor.shape), str(tensor.dtype),
                            tensor.numel() * tensor.element_size()))
            real(tensor, g)
            if tensor.dtype == torch.int64:
                grids.append(tensor.cpu().numpy())
            return tensor

        collectives.all_reduce = counted
        try:
            compute(*args)
        finally:
            collectives.all_reduce = real
        out[label]["all_reduce"] = reduced
        out[label]["grids"] = grids
        out[label]["ms"] = call_ms(lambda: compute(*args))
    if md is not None:
        plan, p_np, v_np, masses, steps, dt = md
        step = mesh.make_multichip_md_step(plan, masses, dt, group,
                                           dtype=f64)
        pos, box, gvals, data = card_inputs(plan, p_np, f64, dev)
        vel = torch.as_tensor(v_np, device=dev).to(f64)
        energies = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            pos, vel, energy = step(pos, vel, box, gvals, data)
            energies.append(float(energy))
        out["md"] = dict(route=mesh.make_sharded_compute(plan, group).route,
                         pos=pos.cpu().numpy(), vel=vel.cpu().numpy(),
                         energies=energies,
                         ms=1e3 * (time.perf_counter() - t0) / steps)
    return out


def shard_gates(label, plan, found, single, grids1):
    """A sharded float32 evaluation ``found`` (a rank's results) against the
    single-card one ``single`` (slice energies, forces, direct-space
    forces) on the same inputs, whose int64 PME grids were ``grids1``:
    direct-space forces and the PME grids after the all_reduce equal to the
    bit, total forces within TOL_SHARD_FORCE of max|F|, the energy and
    every dE/dlambda within TOL_SHARD_ENERGY relative (denominator at least
    1 kJ/mol; the ranks' float partial sums, D10)."""
    import torch
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    e1, f1, fd1 = (x.cpu() for x in single)
    e, f = torch.as_tensor(found["e"]), torch.as_tensor(found["f"])
    check(torch.equal(torch.as_tensor(found["f_direct"]), fd1),
          f"{label}: direct-space forces equal to the single card's to the "
          f"bit")
    check(len(found["grids"]) == len(grids1) and all(
        np.array_equal(a, b) for a, b in zip(found["grids"], grids1)),
          f"{label}: the {len(grids1)} int64 PME grids of a call "
          f"({[a.shape for a in grids1]}), summed over the ranks, equal the "
          f"single card's to the bit")
    fmax = float(f1.abs().max())
    f_err = float((f - f1).abs().max()) / fmax
    print(f"{label}: equal to the single card's to the bit: total forces "
          f"{torch.equal(f, f1)}, slice energies {torch.equal(e, e1)}")
    check(f_err <= TOL_SHARD_FORCE,
          f"{label}: forces {f_err:.3e} of max|F| {fmax:.1f} from the single "
          f"card's <= {TOL_SHARD_FORCE}")
    lam = slice_lambdas(plan.lam_source,
                        torch.as_tensor(plan.global_defaults,
                                        dtype=torch.float64))
    E, E1 = (float(engine_mod.contract_energy(x, lam)) for x in (e, e1))
    d, d1 = (engine_mod.parameter_derivatives(x, plan.deriv_mask)
             for x in (e, e1))
    rel_e = abs(E - E1) / abs(E1)
    rel_d = float(((d - d1).abs() / d1.abs().clamp(min=1.0)).max()
                  if d.numel() else 0.0)
    check(rel_e <= TOL_SHARD_ENERGY and rel_d <= TOL_SHARD_ENERGY,
          f"{label}: energy {rel_e:.3e}, dE/dlambda {rel_d:.3e} relative "
          f"from the single card's <= {TOL_SHARD_ENERGY}")


def sharded_phase(dev, card, results, run_launches, pos_np, vel_np, box_len,
                  reps):
    """Phase 14: ``parallel/mesh.make_sharded_compute`` at full width in
    spawned ranks (see the module docstring): (a) two ranks on this card
    over gloo, with (c) the MD harness; (b) a rank per card over NCCL."""
    import tempfile
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_parallel_cases
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    f32, f64 = torch.float32, torch.float64

    t0 = time.time()
    configs = []
    for method in ("PME", "CutoffPeriodic", "LJPME"):
        system, force, _, _ = build_system(nbt, method)
        configs.append((f"rigid {method}", plan_mod.build_plan(force, system),
                        pos_np))
    out = build_solute_system(nbt, pos_np, box_len)
    configs.append(("solute PME", plan_mod.build_plan(out[1], out[0]),
                    out[2]))
    # the single card's evaluations of the same inputs (with the int64
    # grids they spread), and float64
    single = {}
    spread_fixed = pme_mod.spread_fixed
    for label, plan, p_np in configs:
        args32 = card_inputs(plan, p_np, f32, dev)
        compute = engine_mod.make_compute(plan, True, True, with_aux=True)
        grids1 = []

        def recorded(*a, **kw):
            grids1.append(spread_fixed(*a, **kw))
            return grids1[-1]

        pme_mod.spread_fixed = recorded
        try:
            e1, f1, aux = compute(*args32)
        finally:
            pme_mod.spread_fixed = spread_fixed
        check(compute.route == "pallas" and int(aux["overflow"]) == 0
              and float(aux["excl_span"]) < 1.0,
              f"sharded {label}: the single card's make_compute takes the "
              f"kernel route, overflow {int(aux['overflow'])}, excluded "
              f"pairs span {float(aux['excl_span']):.4f} < 1 cell")
        fd1 = engine_mod.make_compute(plan, True, False)(*args32)[1]
        e64, f64_ = compute(*card_inputs(plan, p_np, f64, dev))[:2]
        single[label] = dict(
            out=(e1, f1, fd1), f64=(e64, f64_), args32=args32,
            grids=[g.cpu().numpy() for g in grids1],
            pc=generic_pair_config(plan),
            ms=call_ms(lambda: compute(*args32)))
    # the MD harness's system: the per-step rebuild's cube, all pairs
    c_pos, c_vel, c_edge = water_cube(pos_np, vel_np, box_len, CUBE_NM)
    c_system, c_force, _ = water_system(nbt, len(c_pos) // 3, c_edge)
    c_plan = plan_mod.build_plan(c_force, c_system)
    c_masses = np.tile(WATER_MASSES, len(c_pos) // 3)
    md = (c_plan, c_pos, c_vel, c_masses, SHARD_MD_STEPS, SHARD_MD_DT)
    print(f"sharded: {len(configs)} plans, their single-card evaluations "
          f"in float32 and float64, in {time.time() - t0:.1f} s")

    # ---- pair_cell over the first rank's range at world 2 against its
    # plain twin, and beside the whole grid
    plans = {label: plan for label, plan, _ in configs}
    for name, label in (("pair_cell_energies_sharded", "rigid PME"),
                        ("pair_cell_energies_sharded_rf",
                         "rigid CutoffPeriodic"),
                        ("pair_cell_ljpme_energies_sharded", "rigid LJPME")):
        s = single[label]
        half = -(-s["pc"].n_cells // 2)
        results[name] = generic_pair_check(
            f"{name} ({label}, cells [0, {half}) of {s['pc'].n_cells})",
            plans[label], s["args32"], reps, dev, cells=(0, half))

    def gates(tag, ranks):
        """The gates of (a) and (b) over every rank's results."""
        world = len(ranks)
        for label, plan, _ in configs:
            found = [r["eval"][label] for r in ranks]
            for r, x in enumerate(found[1:], 1):
                check(all(np.array_equal(x[k], found[0][k])
                          for k in ("e", "f", "f_direct"))
                  and all(np.array_equal(a, b) for a, b in
                          zip(x["grids"], found[0]["grids"])),
                      f"{tag} {label}: rank {r} returned rank 0's result to "
                      f"the bit")
            check(found[0]["route"] == "pallas",
                  f"{tag} {label}: make_sharded_compute takes the kernel "
                  f"route ({found[0]['route']}) on {world} ranks")
            s = single[label]
            shard_gates(f"{tag} {label}", plan, found[0], s["out"],
                        s["grids"])
            gates_against_f64(f"{tag} {label} against f64", plan, s["pc"],
                              s["args32"],
                              (torch.as_tensor(found[0]["e"], device=dev),
                               torch.as_tensor(found[0]["f"], device=dev)),
                              s["f64"])
            reduced = [f"{shape} {dtype}: {nbytes}"
                       for shape, dtype, nbytes in found[0]["all_reduce"]]
            total = sum(x[2] for x in found[0]["all_reduce"])
            print(f"{tag} {label}: {[round(r['ms'], 3) for r in found]} ms a "
                  f"call on ranks 0..{world - 1} (median of {GENERIC_REPS}, "
                  f"CUDA events), single card {s['ms']:.3f} ms ({card}); "
                  f"{len(reduced)} all_reduce a call, {total} bytes: "
                  f"{reduced}")

    def launched(tag, ranks):
        """The launches of the counted run, summed over the ranks, by run:
        'sharded' (Ewald mode), 'sharded_rf' (reaction field)."""
        runs = {run: dict.fromkeys(all_launches(), 0)
                for run in ("sharded", "sharded_rf")}
        for label, _, _ in configs:
            run = "sharded_rf" if "CutoffPeriodic" in label else "sharded"
            per_rank = [r["eval"][label]["launched"] for r in ranks]
            key = ("pair_cell_ljpme_energies" if "LJPME" in label
                   else "pair_cell_energies")
            check(all(x == {key: 1} for x in per_rank),
                  f"{tag} {label}: each rank's call launched {per_rank}: "
                  f"{key} once (over its range of cells), nothing else")
            for x in per_rank:
                for k, v in x.items():
                    runs[run][k] += v
        for run, counted in runs.items():
            check_launches(f"{tag} {run}", run, counted)
        return runs

    # ---- (a) two ranks on this card over gloo, and (c) the MD harness
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = torch_parallel_cases.run_ranks(
            2, tmp, [("eval", "chip_smoke:sharded_rank",
                      dict(configs=configs, md=md))],
            backend="gloo", devices=[str(dev)] * 2, timeout=SHARD_TIMEOUT)
    print(f"sharded (a): 2 ranks over gloo on {dev} in "
          f"{time.time() - t0:.1f} s")
    gates("sharded (a) gloo", ranks)
    for run, counted in launched("sharded (a) gloo", ranks).items():
        run_launches[run] = counted

    # (c): against the single card's loop of make_compute, same leapfrog
    found = [r["eval"]["md"] for r in ranks]
    check(found[0]["route"] == "all_pairs" and all(
        np.array_equal(x["pos"], found[0]["pos"]) for x in found),
        f"sharded (c): {c_plan.num_particles} atoms in a {c_edge:.4f} nm box, "
        f"all-pairs rows over 2 ranks, both ranks at the same positions")
    compute = engine_mod.make_compute(c_plan, True, True)
    p, box, gvals, data = card_inputs(c_plan, c_pos, f64, dev)
    v = torch.as_tensor(c_vel, device=dev).to(f64)
    inv_m = torch.as_tensor(1.0 / c_masses, device=dev).to(f64)[:, None]
    for _ in range(SHARD_MD_STEPS):
        v = v + SHARD_MD_DT * compute(p, box, gvals, data)[1] * inv_m
        p = p + SHARD_MD_DT * v
    err = float((torch.as_tensor(found[0]["pos"]) - p.cpu()).abs().max())
    check(err <= TOL_SHARD_MD and all(map(math.isfinite,
                                          found[0]["energies"])),
          f"sharded (c): make_multichip_md_step, {SHARD_MD_STEPS} steps of "
          f"{SHARD_MD_DT} ps in float64 ({found[0]['ms']:.2f} ms a step), "
          f"positions {err:.3e} nm from the single card's loop <= "
          f"{TOL_SHARD_MD}")

    # ---- (b) a rank per card over NCCL
    world = torch.cuda.device_count()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = torch_parallel_cases.run_ranks(
            world, tmp, [("eval", "chip_smoke:sharded_rank",
                          dict(configs=configs, md=None))],
            backend="nccl", devices=[f"cuda:{r}" for r in range(world)],
            timeout=SHARD_TIMEOUT)
    print(f"sharded (b): {world} rank(s) over NCCL, one a card, in "
          f"{time.time() - t0:.1f} s")
    gates("sharded (b) nccl", ranks)
    launched("sharded (b) nccl", ranks)


def slab_md_tolerance(grid_df, m_min, dt=DT_PS):
    """nm: how far SLAB_CHECK_STEPS steps of the slab step and of the
    single card's make_md_step may end apart (see SLAB_ROUNDING_NM):
    reciprocal forces ``grid_df`` apart from their two PME grids, float32
    rounding, the lightest mass ``m_min``."""
    n = SLAB_CHECK_STEPS
    return (n * (n + 1) / 2 * dt * dt * (grid_df + SLAB_ROUNDING_FORCE)
            / m_min + SLAB_ROUNDING_NM)


def grid_force_difference(plan, fused_cfg, p_np, dev):
    """The largest difference of the reciprocal forces (kJ/mol/nm) on the
    plan's PME grid (and dispersion grid) and on the fused engine's grids
    aligned to its bricks (``fused_cfg``), at ``p_np``, in float64 on the
    card: the atom-space PME of ``ops/pme.py`` on both."""
    import torch
    from nonbondedslicing_tpu_torch.ops import pme as pme_mod
    from nonbondedslicing_tpu_torch.ops import params as params_mod
    from nonbondedslicing_tpu_torch.utils.indexing import slice_subsets
    pos, box, gvals, data = card_inputs(plan, p_np, torch.float64, dev)
    charge, sig_half, eps2 = params_mod.particle_params(data, gvals)
    lam = params_mod.slice_lambdas(plan.lam_source, gvals)
    tables = dict(
        num_subsets=plan.num_subsets,
        slice_subset_pairs=torch.as_tensor(
            np.asarray(slice_subsets(plan.num_subsets)), device=dev),
        slice_table=torch.as_tensor(np.asarray(plan.slice_table),
                                    dtype=torch.int64, device=dev))
    terms = [(charge, lam[:, 0], plan.ewald_alpha, False,
              (plan.pme_grid, plan.pme_moduli),
              (fused_cfg["pme_grid"], fused_cfg["pme_moduli"]))]
    if "dispersion_grid" in fused_cfg:
        terms.append((8.0 * sig_half ** 3 * eps2, lam[:, 1],
                      plan.dispersion_alpha, True,
                      (plan.dispersion_grid, plan.dpme_moduli),
                      (fused_cfg["dispersion_grid"],
                       fused_cfg["dpme_moduli"])))
    df = torch.zeros_like(pos)
    for weight, lam_s, alpha, dispersion, *grids in terms:
        f = [pme_mod.pme_reciprocal(
            pos, box, weight, data["subsets"], lam_s, alpha=alpha,
            grid_shape=tuple(grid),
            moduli=tuple(torch.as_tensor(np.asarray(m), device=dev)
                         for m in moduli),
            dispersion=dispersion, energies=False, **tables)[1]
            for grid, moduli in grids]
        df += f[0] - f[1]
    return float(df.abs().max())


def slab_rank(group, device, configs, timed_chunks):
    """Phase 15's work in one rank of ``group`` on ``device`` (called by
    ``torch_parallel_cases.run_ranks``): for each configuration (label,
    plan, positions, velocities, masses, constraints, capacity),
    ``make_sharded_md_step`` in float32: SLAB_CHECK_STEPS steps from the
    given state (against the single card's, in the parent), then the
    counted run (the launch counts set to 0 just before it): a warm-up
    chunk and ``timed_chunks`` timed chunks of CHUNK_STEPS steps through
    :class:`Chunks` (bench.py's retries); where the windows replay CUDA
    graphs, two windows of the graph against two of the eager body from
    the state reached, and whether a capture followed the warm-up chunk.
    Returns numpy arrays and numbers."""
    import torch
    from nonbondedslicing_tpu_torch.models.force import OpenMMException
    from nonbondedslicing_tpu_torch.parallel import collectives, fused_shard
    dev = torch.device(device)
    f32 = torch.float32
    out = {}
    for label, plan, p_np, v_np, masses, cons, capacity in configs:
        def make_run(cap, reuse, plan=plan, masses=masses, cons=cons):
            return fused_shard.make_sharded_md_step(
                plan, masses, DT_PS, group, dtype=f32, constraints=cons,
                reuse_steps=reuse, cell_capacity=cap)

        pos, box, gvals, data = card_inputs(plan, p_np, f32, dev)
        vel = torch.as_tensor(v_np, device=dev).to(f32)
        run = make_run(capacity, None)
        p10, v10, e10 = run(pos, vel, box, gvals, data, SLAB_CHECK_STEPS)
        chunks = Chunks(make_run, capacity, OpenMMException)
        for counts in launch_counters():
            for key in counts:
                counts[key] = 0
        p, v = pos, vel
        chunk_s = []
        for i in range(1 + timed_chunks):
            torch.cuda.synchronize()
            t0 = time.time()
            p, v, energy = chunks(p, v, box, gvals, data, CHUNK_STEPS)
            torch.cuda.synchronize()
            chunk_s.append(time.time() - t0)
            if i == 0:
                warm = (chunks.run, chunks.run.stats["captures"])
        launched = {k: n for k, n in all_launches().items() if n}
        config = chunks.run.config
        ncx, ncy, ncz = config["counts"]
        found = dict(
            config=config,
            cells=collectives.share(ncx * ncy * ncz, group,
                                    quantum=ncy * ncz),
            check=(p10.cpu().numpy(), v10.cpu().numpy(),
                                  float(e10)),
            pos=p.cpu().numpy(), vel=v.cpu().numpy(), energy=float(energy),
            chunk_s=chunk_s, steps=chunks.steps, calls=chunks.calls,
            capacity=chunks.capacity, launched=launched,
            captures_after_warm_up=(
                None if warm[0] is not chunks.run
                else chunks.run.stats["captures"] - warm[1]))
        if config["graph"]:
            k2 = 2 * config["reuse_steps"]
            g = chunks.run(p, v, box, gvals, data, k2)
            e = chunks.run.eager(p, v, box, gvals, data, k2)
            found["graph"] = dict(pos=[x[0].cpu().numpy() for x in (g, e)],
                                  vel=[x[1].cpu().numpy() for x in (g, e)],
                                  energy=[float(x[2]) for x in (g, e)],
                                  steps=k2)
        out[label] = found
    return out


def slab_phase(dev, card, results, run_launches, pos_np, vel_np, box_len,
               reps):
    """Phase 15: ``parallel/fused_shard.make_sharded_md_step`` at full
    width in spawned ranks (see the module docstring): K4 alone, then (a)
    two ranks on this card over gloo and (b) a rank per card over NCCL,
    each against the single card's ``make_md_step``."""
    import functools
    import tempfile
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import neighbors
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_parallel_cases
    f32 = torch.float32

    # ---- the systems: the rigid box under PME and LJPME (pair_column,
    # SETTLE), the solute box under PME (pair_cell) with phase 13's
    # clusters: make_sharded_md_step takes no bonds (as the JAX package's),
    # so the chain is held by its 1-2 pairs as constraints (one 11-wide
    # cluster, CGLS); without them its excluded pairs drift beyond a cell
    # width and the span guard raises
    from nonbondedslicing_tpu_torch.runtime import constraints as cons_mod
    t0 = time.time()
    s_system, s_force, s_pos, s_masses, water_cons, bonds, kept = \
        build_solute_system(nbt, pos_np, box_len)
    triples, _ = chain_constraints(water_cons, bonds)
    s_cons = cons_mod.cluster_constraints(triples, len(s_masses))
    systems = []
    for method in ("PME", "LJPME"):
        system, force, _, cons = build_system(nbt, method)
        systems.append((f"rigid {method}", plan_mod.build_plan(force, system),
                        pos_np, vel_np, np.tile(WATER_MASSES, N_MOLECULES),
                        cons))
    systems.append(("solute PME", plan_mod.build_plan(s_force, s_system),
                    s_pos, solute_velocities(vel_np, kept), s_masses, s_cons))
    configs = []
    for label, plan, p_np, v_np, masses, cons in systems:
        counts = neighbors.choose_cell_grid(plan.box0, plan.cutoff,
                                            plan.num_particles,
                                            target_skin=0.1)[0]
        occ = max_cell_occupancy(p_np, plan.box0, counts)
        # the capacity of phases 5 and 6 (the most atoms in a cell + 8),
        # not choose_cell_grid's 220: the pair kernels' time grows with it,
        # and the single card runs at this one; an overflow rebuilds the
        # run with 8 more (Chunks)
        capacity = max(8, int(np.ceil((occ + 8) / 4) * 4))
        configs.append((label, plan, p_np, v_np, masses, cons, capacity))
    print(f"slab: {len(configs)} systems built in {time.time() - t0:.1f} s; "
          f"capacities {[c[-1] for c in configs]}; the solute's chain held "
          f"by its 1-2 pairs as constraints, its 1-3 bonds left out "
          f"(make_sharded_md_step takes no bonds)")

    # ---- K4: pair_column over the first rank's slab at world 2 against
    # its plain twin, the two slabs against the whole grid, timed beside it
    for label, plan, p_np, _, _, _, capacity in configs[:2]:
        prepare, _, cfg = fused_mod.make_fused_engine(
            plan, cell_capacity=capacity, target_skin=0.1, energies=True)
        pc = cfg["pair"]
        pos, box, gvals, data = card_inputs(plan, p_np, f32, dev)
        st = prepare(pos, box, gvals, data)
        slot_pos = fused_mod.slot_positions(pos, st, False)
        lam = slice_lambdas(plan.lam_source, gvals)
        sl_tab = torch.as_tensor(plan.slice_table, dtype=torch.int64,
                                 device=dev)
        planes = pc.counts[1] * pc.counts[2]
        half = -(-pc.counts[0] // 2) * planes
        slabs = [(0, half), (half, pc.n_cells - half)]
        n_pair, _ = pair_counts(slot_pos, st["table"], st["sexcl"], box,
                                plan.cutoff, plan.num_particles, pc.counts,
                                (0, half))
        variants = ((("pair_column_sharded", False),
                     ("pair_column_energies_sharded", True))
                    if not pc.ljpme else (("pair_column_ljpme_sharded",
                                           False),))
        for name, energies in variants:
            args = (slot_pos, st["slot_par"], st["slot_sub"], st["table"],
                    st["sexcl"], lam[:, 0][sl_tab].contiguous(),
                    lam[:, 1][sl_tab].contiguous(), box, pc, energies,
                    plan.num_particles)
            tag = f"{name} ({label}, cells [0, {half}) of {pc.n_cells})"
            out = pair_kernel_check(
                tag, functools.partial(cuda_direct.pair_column,
                                       cells=slabs[0]),
                functools.partial(cuda_direct.pair_column_plain,
                                  cells=slabs[0]), args, pc, reps,
                cell_kernel=False)
            whole = cuda_direct.pair_column(*args)
            parts = [cuda_direct.pair_column(*args, cells=c) for c in slabs]
            torch.cuda.synchronize()
            check(torch.equal(torch.cat([x[0] for x in parts]), whole[0])
                  and (not energies or torch.equal(
                      torch.cat([x[1] for x in parts]), whole[1])),
                  f"{tag}: the two slabs concatenated equal the whole grid "
                  f"to the bit, forces" + (" and moments" if energies
                                           else ""))
            ms, out["whole_grid_ms"] = timed_pair(
                lambda: cuda_direct.pair_column(*args, cells=slabs[0]),
                lambda: cuda_direct.pair_column(*args), reps, what=None)
            out["bound_ms"], out["bound_by"] = pair_bound(
                pc, energies, n_pair, 0, cell_kernel=False, out_cells=half)
            print(f"{tag}: {ms:.4f} ms beside the whole grid's "
                  f"{out['whole_grid_ms']:.4f} ms ({ms / out['whole_grid_ms']:.3f}"
                  f" of it), in turns; {n_pair} pairs within the cutoff, "
                  f"bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
            results[name] = out

    single = {}

    def gates(tag, ranks):
        """(a)'s and (b)'s gates over every rank's results; returns the
        counted launches summed over the ranks and systems."""
        world = len(ranks)
        counted = dict.fromkeys(all_launches(), 0)
        for label, plan, p_np, v_np, masses, cons, capacity in configs:
            found = [r["slab"][label] for r in ranks]
            for r, x in enumerate(found[1:], 1):
                check(np.array_equal(x["pos"], found[0]["pos"])
                      and np.array_equal(x["vel"], found[0]["vel"])
                      and x["energy"] == found[0]["energy"],
                      f"{tag} {label}: rank {r} ends with rank 0's positions, "
                      f"velocities and energy to the bit")
            f0, config = found[0], found[0]["config"]
            solute = "solute" in label
            n_cons = (int(np.sum(cons[2])) if len(cons) > 2
                      else int(np.asarray(cons[1]).size))
            print(f"{tag} {label}: config {config}; {f0['steps']} steps in "
                  f"{f0['calls']} run() calls, capacity {f0['capacity']}")
            md_checks(f"{tag} {label}", torch.as_tensor(f0["pos"]),
                      torch.as_tensor(f0["vel"]), f0["energy"], masses,
                      SOLUTE_SITES if solute else 0,
                      3 * plan.num_particles - n_cons - 3, f0["chunk_s"],
                      plan.num_particles, card)
            if solute:
                err = chain_constraint_error(torch.as_tensor(f0["pos"]))
                check(err <= TOL_CONSTRAINT,
                      f"{tag} {label}: the chain's 1-2 distances within "
                      f"{err:.3e} nm of {BOND_R0} <= {TOL_CONSTRAINT}")
            # the energy at the positions reached, against CPU float64
            counts = neighbors.choose_cell_grid(
                plan.box0, plan.cutoff, plan.num_particles,
                target_skin=DEFAULT_SKIN)[0]
            occ = max_cell_occupancy(f0["pos"].astype(np.float64),
                                     plan.box0, counts)
            E_c = cpu_evaluation(plan, int(np.ceil((occ + 4) / 4) * 4),
                                 f0["pos"].astype(np.float64), plan.box0,
                                 plan.global_defaults)[0]
            rel_e = abs(f0["energy"] - E_c) / abs(E_c)
            check(math.isfinite(f0["energy"]) and rel_e <= TOL_EVAL_ENERGY,
                  f"{tag} {label}: energy {f0['energy']:.6f} at the state "
                  f"reached, CPU f64 {E_c:.6f} kJ/mol, {rel_e:.3e} relative "
                  f"<= {TOL_EVAL_ENERGY}")
            # SLAB_CHECK_STEPS steps against the single card's
            s = single.get(label)
            if s is None:
                s = single[label] = single_card(label, plan, p_np, v_np,
                                                masses, cons, capacity,
                                                config["reuse_steps"])
            err = float(np.abs(f0["check"][0] - s["check"][0]).max())
            rel = abs(f0["check"][2] - s["check"][2]) / abs(s["check"][2])
            check(err <= s["tol"] and rel <= TOL_EVAL_ENERGY,
                  f"{tag} {label}: {SLAB_CHECK_STEPS} steps from the "
                  f"starting state, positions {err:.3e} nm from the single "
                  f"card's make_md_step (K {config['reuse_steps']}, capacity "
                  f"{capacity}, cells {config['counts']}; {s['grids']}) <= "
                  f"{s['tol']:.3e} (slab_md_tolerance), energy {rel:.3e} "
                  f"relative <= {TOL_EVAL_ENERGY}")
            pair = ("pair_cell" if config["pair"] == "pair_cell"
                    else "pair_column_ljpme" if "LJPME" in label
                    else "pair_column")
            for r, x in enumerate(found):
                begin, end = x["cells"]
                want = ({pair: x["steps"], pair + "_energies": x["calls"]}
                        if end > begin else {})
                check(x["launched"] == want,
                      f"{tag} {label}: rank {r} (cells [{begin}, {end})) "
                      f"launched {x['launched']} in its run: {pair} once a "
                      f"step, its energies variant once a run()"
                      if want else f"{tag} {label}: rank {r} owns no cell "
                      f"and launched {x['launched']}: no kernel")
                for k, n in x["launched"].items():
                    counted[k] += n
            check(all(x["captures_after_warm_up"] in (None, 0)
                      for x in found),
                  f"{tag} {label}: no capture after the warm-up chunk "
                  f"({[x['captures_after_warm_up'] for x in found]}; None: "
                  f"a guard rebuilt the run)")
            if config["graph"]:
                g = f0["graph"]
                err = float(np.abs(g["pos"][0] - g["pos"][1]).max())
                rel = abs(g["energy"][0] - g["energy"][1]) / abs(
                    g["energy"][1])
                bitwise = (all(np.array_equal(*g[k]) for k in ("pos", "vel"))
                           and g["energy"][0] == g["energy"][1])
                print(f"{tag} {label}: {g['steps']} steps of the graph "
                      f"against the eager body on {world} rank(s): equal to "
                      f"the bit {bitwise}, positions {err:.3e} nm, energy "
                      f"{rel:.3e} relative")
                # the same ranks add their float32 partial forces in the
                # same order in the graph and eagerly, and the PME grids
                # are int64 (measured equal on four NCCL ranks, an H100
                # each)
                check(bitwise, f"{tag} {label}: the graph equals the eager "
                      f"body to the bit on {world} rank(s)")
            per_rank = [round(float(np.median(
                [1e3 * t / CHUNK_STEPS for t in x["chunk_s"][1:]])), 3)
                for x in found]
            print(f"{tag} {label}: {per_rank} ms/step on ranks 0..{world - 1}"
                  f" (median of {len(f0['chunk_s']) - 1} x {CHUNK_STEPS} "
                  f"steps, graph {config['graph']}), single card "
                  f"make_md_step {s['ms']:.3f} ms/step at the same K and "
                  f"capacity ({card})")
        return counted

    def single_card(label, plan, p_np, v_np, masses, cons, capacity, K):
        """The single card's make_md_step at the slab step's cells (target
        skin 0.1), K and capacity: SLAB_CHECK_STEPS steps from the given
        state and the ms/step of a warm-up and SLAB_TIMED_CHUNKS chunks."""
        def make_run(cap, reuse):
            return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                                cell_capacity=cap, reuse_steps=reuse,
                                constraints=cons, target_skin=0.1)

        pos, box, gvals, data = card_inputs(plan, p_np, f32, dev)
        vel = torch.as_tensor(v_np, device=dev).to(f32)
        run = make_run(capacity, K)
        p10, v10, e10 = run(pos, vel, box, gvals, data, SLAB_CHECK_STEPS)
        chunks = Chunks(make_run, capacity, nbt.OpenMMException)
        chunks.reuse = K
        *_, chunk_s, _ = run_md(chunks, pos, vel, box, gvals, data,
                                SLAB_TIMED_CHUNKS)
        grids = [f"PME grid {tuple(plan.pme_grid)} against "
                 f"{run.config['pme_grid']}"]
        if "dispersion_grid" in run.config:
            grids.append(f"dispersion grid {tuple(plan.dispersion_grid)} "
                         f"against {run.config['dispersion_grid']}")
        df = grid_force_difference(
            plan, fused_mod.fused_config(plan, capacity, target_skin=0.1),
            p_np, dev)
        tol = slab_md_tolerance(df, float(np.min(masses[masses > 0])))
        return dict(check=(p10.cpu().numpy(), v10.cpu().numpy(), float(e10)),
                    ms=float(np.median([1e3 * t / CHUNK_STEPS
                                        for t in chunk_s[1:]])),
                    grids=(", ".join(grids) + f" (aligned to the bricks): "
                           f"reciprocal forces {df:.3e} kJ/mol/nm apart"),
                    tol=tol)

    # ---- (a) two ranks on this card over gloo
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = torch_parallel_cases.run_ranks(
            2, tmp, [("slab", "chip_smoke:slab_rank",
                      dict(configs=configs,
                           timed_chunks=SLAB_GLOO_TIMED_CHUNKS))],
            backend="gloo", devices=[str(dev)] * 2, timeout=SHARD_TIMEOUT)
    print(f"slab (a): 2 ranks over gloo on {dev} in {time.time() - t0:.1f} s")
    counted = gates("slab (a) gloo", ranks)
    check_launches("slab (a) gloo", "slab", counted)
    run_launches["slab"] = counted

    # ---- (b) a rank per card over NCCL
    world = torch.cuda.device_count()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = torch_parallel_cases.run_ranks(
            world, tmp, [("slab", "chip_smoke:slab_rank",
                          dict(configs=configs,
                               timed_chunks=SLAB_TIMED_CHUNKS))],
            backend="nccl", devices=[f"cuda:{r}" for r in range(world)],
            timeout=SHARD_TIMEOUT)
    print(f"slab (b): {world} rank(s) over NCCL, one a card, in "
          f"{time.time() - t0:.1f} s")
    check(all(r["slab"][label]["config"]["graph"] for r in ranks
              for label, *_ in configs),
          "slab (b) nccl: the windows replay CUDA graphs, the force "
          "all_reduce captured")
    check_launches("slab (b) nccl", "slab", gates("slab (b) nccl", ranks))


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
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    from nonbondedslicing_tpu_torch.ops import engine as engine_mod
    from nonbondedslicing_tpu_torch.ops import fused as fused_mod
    from nonbondedslicing_tpu_torch.ops import neighbors, plan as plan_mod
    from nonbondedslicing_tpu_torch.ops.params import slice_lambdas
    from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                             make_md_step)
    from nonbondedslicing_tpu_torch.runtime import native
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
    native.get_lib()
    print(f"native: {native.LAST_BUILD['path']}, g++ "
          f"{native.LAST_BUILD['build_seconds']:.2f} s, error "
          f"{native.LAST_BUILD['error']}")
    parent = load_parent(parent_procs)
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip())

    def reset_launches():
        for counts in launch_counters():
            for key in counts:
                counts[key] = 0

    if "--sharded" in sys.argv[1:]:
        # ---- 14 alone
        _, _, box_len, _ = build_system(nbt)
        blob = np.load(STATE_FILE)
        results, run_launches = {}, {}
        state = (np.asarray(blob["positions"], dtype=np.float64),
                 np.asarray(blob["velocities"], dtype=np.float64))
        t0 = time.time()
        sharded_phase(dev, card, results, run_launches, *state, box_len, 20)
        print(f"sharded: {time.time() - t0:.1f} s")
        # ---- 15 alone
        t0 = time.time()
        slab_phase(dev, card, results, run_launches, *state, box_len, 20)
        print(f"slab: {time.time() - t0:.1f} s")
        print(f"total: {time.time() - t_start:.1f} s")
        print_last_lines(kind, results, run_launches,
                         [e for e in ENTRIES if e[2] in ("sharded", "slab")])
        return 0

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

    # ---- 17. the water tail against its twin
    results["water_tail"] = water_tail_check(
        plan, masses, constraints, capacity, pos,
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data, reps)

    # ---- 4. whole evaluation: card f32 vs CPU f64 (plain twins)
    reference = evaluation_check("evaluation", plan, capacity, apply, st, pos,
                                 box, gvals, data, pos_np, box_np, np.ones(2))

    # ---- 5. MD: the benchmark path, counted
    def make_bench_run(cap, reuse):
        return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints)

    reset_launches()
    chunks = Chunks(make_bench_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        TIMED_CHUNKS)
    launches = all_launches()
    print(f"md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, timed "
          f"chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check(config["graph"], "md: the K-step windows run as CUDA graphs")
    check_launches("md", "rigid", launches)
    launch_report("md", chunks, launches, "pair_column", tail=True)
    ms_stencil = md_checks("md", p, v, energy, masses, 0,
                           3 * n - 3 * N_MOLECULES - 3, chunk_s, n, card)
    run_launches = {"rigid": launches}
    # the capacity the run settled on (a chunk that overflowed the cells
    # is run again with 8 more slots a cell), for phase 9's graphs of the
    # same step, whose timed chunks take it some 800 steps from the state
    md_capacity = chunks.capacity

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
    chunks = Chunks(make_solute_run, s_capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, s_pos, torch.as_tensor(s_vel_np, device=dev).to(f32), box,
        s_gvals, s_data, SOLUTE_TIMED_CHUNKS)
    launches = all_launches()
    print(f"solute md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check(config["graph"], "solute md: the K-step windows run as CUDA "
          "graphs (the gather constrainer's clusters are 3 wide)")
    check_launches("solute md", "solute", launches)
    launch_report("solute md", chunks, launches, "pair_cell")
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
    chunks = Chunks(make_grid_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        GRID_TIMED_CHUNKS)
    launches = all_launches()
    print(f"grid md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("grid md", "rigid_grid", launches)
    launch_report("grid md", chunks, launches, "pair_column", tail=True)
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
    launches = all_launches()
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
    chunks = Chunks(make_ljpme_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, l_data,
        LJPME_TIMED_CHUNKS)
    launches = all_launches()
    print(f"ljpme md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s; launches "
          f"{launches}")
    check_launches("ljpme md", "rigid_ljpme", launches)
    launch_report("ljpme md", chunks, launches, "pair_column_ljpme")
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
    launches = all_launches()
    print(f"solute ljpme evaluation: launches {launches}")
    check_launches("solute ljpme evaluation", "solute_ljpme", launches)
    run_launches["solute_ljpme"] = launches

    # ---- 9. the CUDA graph against the eager body
    graph_against_eager(
        "graph", make_bench_run, md_capacity,
        torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        reset_launches, card)
    solute_ms = graph_against_eager(
        "solute graph", make_solute_run, s_capacity, s_pos,
        torch.as_tensor(s_vel_np, device=dev).to(f32), box, s_gvals, s_data,
        reset_launches, card)[2]
    # the paths that only LJPME (the C6 pass) and the window pipeline
    # (brick-major slots, the window kernels) run, to the bit
    graph_against_eager(
        "ljpme graph", make_ljpme_run, capacity,
        torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, l_data,
        reset_launches, card)
    graph_against_eager(
        "grid graph", make_grid_run, md_capacity,
        torch.as_tensor(pos_np, device=dev).to(f32),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        reset_launches, card)

    # ---- 10. mixed precision at full width, and the NVE pair
    def make_mixed_run(cap, reuse, mixed=True):
        return make_md_step(plan, masses, dt=DT_PS, dtype=f32,
                            cell_capacity=cap, reuse_steps=reuse,
                            constraints=constraints, mixed_precision=mixed)

    reset_launches()
    chunks = Chunks(make_mixed_run, capacity, nbt.OpenMMException)
    p, v, energy, chunk_s, config = run_md(
        chunks, torch.as_tensor(pos_np, device=dev),
        torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
        MIXED_TIMED_CHUNKS)
    launches = all_launches()
    print(f"mixed md: config {config}; warm-up chunk {chunk_s[0]:.2f} s, "
          f"timed chunks {[round(t, 3) for t in chunk_s[1:]]} s")
    check(config["mixed_precision"] and config["graph"]
          and p.dtype == torch.float64 and v.dtype == f32,
          f"mixed md: float64 positions ({p.dtype}), float32 velocities "
          f"({v.dtype}), graphed")
    check_launches("mixed md", "rigid_mixed", launches)
    launch_report("mixed md", chunks, launches, "pair_column")
    ms_mixed = md_checks("mixed md", p, v, energy, masses, 0,
                         3 * n - 3 * N_MOLECULES - 3, chunk_s, n, card)
    print(f"mixed: {np.median(ms_mixed):.3f} ms/step against single's "
          f"{np.median(ms_stencil):.3f} in this run ({n} atoms, {card})")
    drift = {}
    for precision in ("single", "mixed"):
        drift[precision] = nve_drift(
            precision, Chunks(lambda cap, reuse, m=precision == "mixed":
                              make_mixed_run(cap, reuse, m), capacity,
                              nbt.OpenMMException),
            torch.as_tensor(pos_np, device=dev),
            torch.as_tensor(vel_np, device=dev).to(f32), box, gvals, data,
            masses, card)
    check(abs(drift["mixed"]) < abs(drift["single"]),
          f"nve: mixed drifts less than single ({drift['mixed']:.2f} "
          f"against {drift['single']:.2f} kJ/mol/ps)")

    # ---- 11. the generic engine: make_compute at full width
    t0 = time.time()
    generic_engine(dev, card, reset_launches, results, run_launches, pos_np,
                   box_len, (apply, st, cfg, (pos, box, gvals, data)), reps)
    print(f"generic engine: {time.time() - t0:.1f} s")

    # ---- 12. the user API: Context, checkpoints, bare Ewald, the per-step
    # rebuild
    t0 = time.time()
    api_phase(dev, card, reset_launches, results, run_launches, pos_np,
              vel_np, box_len, capacity, reps)
    print(f"api: {time.time() - t0:.1f} s")

    # ---- 13. the constrained solute graphed, the native library, the
    # example
    t0 = time.time()
    constrained_phase(dev, card, reset_launches, results, run_launches,
                      pos_np, vel_np, box_len, s_capacity, solute_ms)
    print(f"constrained: {time.time() - t0:.1f} s")

    # ---- 14. the sharded evaluation in spawned ranks
    t0 = time.time()
    sharded_phase(dev, card, results, run_launches, pos_np, vel_np, box_len,
                  reps)
    print(f"sharded: {time.time() - t0:.1f} s")

    # ---- 15. the slab-decomposed MD step in spawned ranks
    t0 = time.time()
    slab_phase(dev, card, results, run_launches, pos_np, vel_np, box_len,
               reps)
    print(f"slab: {time.time() - t0:.1f} s")

    # ---- 16. bitwise repeatability of the evaluations
    determinism_phase(dev, pos_np, box_len)
    print(f"total: {time.time() - t_start:.1f} s")
    print_last_lines(kind, results, run_launches, ENTRIES)
    return 0


def determinism_phase(dev, pos_np, box_len):
    """Phase 16: bitwise repeatability (see the module docstring)."""
    import torch
    import nonbondedslicing_tpu_torch as nbt
    from nonbondedslicing_tpu_torch.ops import params, pme
    from nonbondedslicing_tpu_torch.ops import plan as plan_mod
    from nonbondedslicing_tpu_torch.utils.indexing import slice_subsets
    t0 = time.time()
    compared = 0
    for method in ("PME", "LJPME"):
        rigid, _, _, _ = build_system(nbt, method)
        solute, _, s_pos, *_ = build_solute_system(nbt, pos_np, box_len,
                                                   method=method)
        for label, system, p in (("rigid", rigid, pos_np),
                                 ("solute", solute, s_pos)):
            for platform in ("CUDA", "Reference"):
                ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS),
                                  nbt.Platform.getPlatformByName(platform))
                states = []
                for _ in range(2):
                    ctx.setPositions(p)
                    states.append(full_state(ctx))
                a, b = states
                check(np.array_equal(np.asarray(a.getForces()),
                                     np.asarray(b.getForces()))
                      and a.getPotentialEnergy() == b.getPotentialEnergy()
                      and (a.getEnergyParameterDerivatives()
                           == b.getEnergyParameterDerivatives()),
                      f"determinism {label} {method} {platform}: two "
                      f"getState calls with setPositions between, forces, "
                      f"energy ({a.getPotentialEnergy()!r} kJ/mol) and "
                      f"dE/dlambda equal to the bit")
                compared += 2
    # the atom-space PME of the rigid box on its atoms in another order
    for method in ("PME", "LJPME"):
        system, force, _, _ = build_system(nbt, method)
        plan = plan_mod.build_plan(force, system)
        perm = torch.as_tensor(
            np.random.default_rng(7).permutation(plan.num_particles),
            device=dev)
        tables = dict(
            num_subsets=plan.num_subsets,
            slice_subset_pairs=torch.as_tensor(
                slice_subsets(plan.num_subsets), device=dev),
            slice_table=torch.as_tensor(np.asarray(plan.slice_table),
                                        dtype=torch.int64, device=dev))
        for dtype in (torch.float32, torch.float64):
            pos, box, gvals, data = card_inputs(plan, pos_np, dtype, dev)
            charge, sig_half, eps2 = params.particle_params(data, gvals)
            lam = params.slice_lambdas(
                torch.as_tensor(np.asarray(plan.lam_source), device=dev),
                gvals)
            terms = [("charges", charge, lam[:, 0], plan.ewald_alpha,
                      plan.pme_grid, plan.pme_moduli, False)]
            if method == "LJPME":
                terms.append(("C6", 8.0 * sig_half ** 3 * eps2, lam[:, 1],
                              plan.dispersion_alpha, plan.dispersion_grid,
                              plan.dpme_moduli, True))
            subsets = data["subsets"]
            for name, w, lam_s, alpha, grid, moduli, dispersion in terms:
                kw = dict(tables, alpha=alpha, grid_shape=grid,
                          moduli=tuple(torch.as_tensor(np.asarray(m),
                                                       device=dev)
                                       for m in moduli),
                          dispersion=dispersion)
                e1, f1 = pme.pme_reciprocal(pos, box, w, subsets, lam_s,
                                            **kw)
                e2, f2 = pme.pme_reciprocal(pos[perm], box, w[perm],
                                            subsets[perm], lam_s, **kw)
                check(torch.equal(e1, e2) and torch.equal(f1[perm], f2),
                      f"determinism rigid {method} {dtype}: pme_reciprocal "
                      f"of the {name} on {plan.num_particles} atoms and on "
                      f"them permuted, slice energies equal and forces "
                      f"permuted to the bit")
                compared += 2
    print(f"determinism: {compared} evaluations compared, each pair equal "
          f"to the bit, in {time.time() - t0:.1f} s")


def print_last_lines(kind, results, run_launches, entries):
    """The kernels line of ``entries`` and the last line."""
    import torch
    print(json.dumps({"kernels": [
        dict(name=name, path=path, route="cuda",
             source="nonbondedslicing_tpu_torch/" + KERNELS[kernel][0],
             replaces=KERNELS[kernel][1],
             launches=run_launches[run][kernel],
             **{"library_ms": None, **results[name]})
        for name, kernel, path, run in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
