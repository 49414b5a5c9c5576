"""The rigid-water tail kernel (csrc/water_tail.cu) on the card, at the
benchmark's shapes (7,763 waters, 23,289 atoms, cells (6, 6, 6) of 144
slots, PME, SETTLE, 2 fs, from the benchmark state).

* The kernel against its plain twin (the PyTorch sequence it replaced) on
  the same slot forces: positions within TOL_POS_NM and velocities within
  TOL_VEL, two launches equal to the bit.
* make_md_step through it: the graph's replays equal the eager body to the
  bit, and the kernel is launched once an inner step;
  ``Context.step`` equals make_md_step to the bit and launches it once a
  step; a solute Context (cell kernel, M-SHAKE, bonds) never launches it.
* 50 steps through the kernel stay within the benchmark's water23k-pme
  trajectory limits (benchmark/limits/water23k-pme.dhdl500.json) of 50
  steps through the twin's sequence (the engine's atom forces and
  make_integrator's step) from the same state.

Marked ``gpu``; they skip (from inside the fixture) where no CUDA device
is present.  On a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_water_tail.py
"""

import json
import os

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops.fused import make_fused_engine
from nonbondedslicing_tpu_torch.runtime import water_tail
from nonbondedslicing_tpu_torch.runtime.fastpath import (DEFAULT_SKIN,
                                                         make_integrator,
                                                         make_md_step)

from port_systems import (DT_PS, N_MOLECULES, STATE_FILE, WATER_MASSES,
                          add_bonds, add_constraints, build_solute_system,
                          build_system, solute_velocities)

pytestmark = pytest.mark.gpu

CAPACITY = 144            # tests/test_torch_gpu_graph.py's
K = 4
# Kernel against twin, one step.  Both round every operation to float32
# in the same order, with CUDA's erff, expf, sqrt and rsqrtf; PyTorch's
# kernels may order a three-term sum (torch.sum over the coordinates)
# otherwise, or contract a cross product's terms into an FMA, each an ulp
# of an intermediate.  SETTLE carries inputs an ulp apart to outputs up to
# 8 ulps apart (chip_smoke.py's SLAB_ROUNDING_NM note): 8 ulps of a
# coordinate below 8 nm (4.8e-7 nm) is 3.8e-6 nm.  The velocity is
# (x_new - x0) / dt: 3.8e-6 nm / 2 fs = 1.9e-3 nm/ps, which RATTLE's
# projection does not enlarge.
TOL_POS_NM = 3.8e-6
TOL_VEL = 1.9e-3
LIMITS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "limits",
    "water23k-pme.dhdl500.json")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def rigid(cuda):
    system, force, box_len, constraints = build_system(nbt)
    plan = tplan.build_plan(force, system)
    blob = np.load(STATE_FILE)
    return dict(plan=plan, constraints=constraints,
                masses=np.tile(WATER_MASSES, N_MOLECULES),
                pos_np=np.asarray(blob["positions"], dtype=np.float64),
                vel_np=np.asarray(blob["velocities"], dtype=np.float64),
                pos=torch.as_tensor(blob["positions"], device=cuda).float(),
                vel=torch.as_tensor(blob["velocities"], device=cuda).float(),
                box=torch.as_tensor(np.diag([box_len] * 3), device=cuda
                                    ).float(),
                gvals=torch.ones(2, device=cuda),
                data=tengine.plan_data(plan, device=cuda,
                                       dtype=torch.float32))


def _args(r):
    return (r["box"], r["gvals"], r["data"])


def _run(r):
    return make_md_step(r["plan"], r["masses"], dt=DT_PS,
                        cell_capacity=CAPACITY, reuse_steps=K,
                        constraints=r["constraints"])


def test_kernel_against_twin(rigid):
    prepare, apply, _ = make_fused_engine(rigid["plan"], energies=False,
                                          cell_capacity=CAPACITY,
                                          target_skin=DEFAULT_SKIN)
    integrate = make_integrator(rigid["masses"], DT_PS, torch.float32,
                                rigid["constraints"])
    tail = water_tail.make_water_tail(rigid["plan"], DT_PS, integrate)
    pos, vel = rigid["pos"], rigid["vel"]
    state = prepare(pos, *_args(rigid))
    _, slot_f, aux = apply(pos, *_args(rigid), state, slot_forces=True)
    before = water_tail.LAUNCHES["water_tail"]
    p_k, v_k = tail(slot_f, pos, vel, state, aux["lam"])
    p_k2, v_k2 = tail(slot_f, pos, vel, state, aux["lam"])
    p_t, v_t = tail.plain(slot_f, pos, vel, state, aux["lam"])
    torch.cuda.synchronize()
    assert water_tail.LAUNCHES["water_tail"] == before + 2
    assert torch.equal(p_k, p_k2) and torch.equal(v_k, v_k2)
    dp = float((p_k - p_t).abs().max())
    dv = float((v_k - v_t).abs().max())
    print(f"kernel - twin: positions {dp:.3e} nm, velocities {dv:.3e} "
          f"nm/ps; equal to the bit: {torch.equal(p_k, p_t)}, "
          f"{torch.equal(v_k, v_t)}")
    assert dp <= TOL_POS_NM and dv <= TOL_VEL
    assert float((p_k - pos).abs().max()) > 100 * TOL_POS_NM


def test_graph_equals_eager_and_counts(rigid):
    run = _run(rigid)
    assert run.config["water_tail"] and run.config["graph"]
    before = water_tail.LAUNCHES["water_tail"]
    p, v, _ = run(rigid["pos"], rigid["vel"], *_args(rigid), K)
    assert water_tail.LAUNCHES["water_tail"] == before + K
    p_g, v_g, e_g = run(p, v, *_args(rigid), 3 * K + 2)
    assert water_tail.LAUNCHES["water_tail"] == before + 4 * K + 2
    p_e, v_e, e_e = run.eager(p, v, *_args(rigid), 3 * K + 2)
    assert water_tail.LAUNCHES["water_tail"] == before + 7 * K + 4
    assert run.stats["replays"] >= 3
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)


def test_context_equals_make_md_step_and_counts(rigid, cuda):
    system, force, _, constraints = build_system(nbt)
    add_constraints(system, constraints)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS))
    ctx.setPositions(rigid["pos_np"])
    ctx.setVelocities(rigid["vel_np"])
    before = water_tail.LAUNCHES["water_tail"]
    for _ in range(3):
        ctx.getIntegrator().step(20)
    assert water_tail.LAUNCHES["water_tail"] == before + 60
    compiled = ctx._compiled[id(force)]
    runs = compiled.md[DT_PS]["runs"]
    run = next(iter(runs.values()))
    assert len(runs) == 1 and run.config["water_tail"]
    direct = make_md_step(compiled.plan, rigid["masses"], dt=DT_PS,
                          cell_capacity=run.config["capacity"],
                          reuse_steps=run.config["reuse_steps"],
                          constraints=constraints)
    data = tengine.plan_data(compiled.plan, device=cuda, dtype=torch.float32)
    p = torch.as_tensor(rigid["pos_np"], device=cuda).float()
    v = torch.as_tensor(rigid["vel_np"], device=cuda).float()
    for _ in range(3):
        p, v, _ = direct(p, v, rigid["box"], rigid["gvals"], data, 20)
    st = ctx.getState(getPositions=True, getVelocities=True)
    np.testing.assert_array_equal(np.asarray(st.getPositions()),
                                  p.double().cpu().numpy())
    np.testing.assert_array_equal(np.asarray(st.getVelocities()),
                                  v.double().cpu().numpy())


def test_solute_context_never_launches(rigid):
    system, force, pos, _, constraints, bonds, kept = build_solute_system(
        nbt, rigid["pos_np"], float(rigid["box"][0, 0]))
    add_constraints(system, constraints)
    add_bonds(nbt, system, bonds)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS))
    ctx.setPositions(pos)
    ctx.setVelocities(solute_velocities(rigid["vel_np"], kept))
    before = water_tail.LAUNCHES["water_tail"]
    ctx.getIntegrator().step(20)
    assert water_tail.LAUNCHES["water_tail"] == before
    runs = ctx._compiled[id(force)].md[DT_PS]["runs"]
    assert not next(iter(runs.values())).config["water_tail"]


def test_trajectory_within_benchmark_limits(rigid):
    """50 steps (12 windows of 4 and one of 2) through the kernel and
    through the twin's sequence, from the benchmark state: the benchmark's
    trajectory numbers of the first against the second within the
    cell's limits."""
    steps = 50
    p_k, v_k, _ = _run(rigid)(rigid["pos"], rigid["vel"], *_args(rigid),
                              steps)
    prepare, apply, _ = make_fused_engine(rigid["plan"], energies=False,
                                          cell_capacity=CAPACITY,
                                          target_skin=DEFAULT_SKIN)
    integrate = make_integrator(rigid["masses"], DT_PS, torch.float32,
                                rigid["constraints"])
    p, v = rigid["pos"], rigid["vel"]
    for start in range(0, steps, K):
        state = prepare(p, *_args(rigid))
        for _ in range(min(K, steps - start)):
            _, forces, _ = apply(p, *_args(rigid), state)
            p, v = integrate(p, v, forces)
    x, x_ref = p_k.double().cpu().numpy(), p.double().cpu().numpy()
    u, u_ref = v_k.double().cpu().numpy(), v.double().cpu().numpy()
    dist = np.sqrt(np.sum((x - x_ref) ** 2, axis=1))
    numbers = dict(
        traj_pos_rms_nm=float(np.sqrt(np.mean(dist ** 2))),
        traj_pos_max_nm=float(np.max(dist)),
        traj_vel_rms_rel=float(np.sqrt(np.mean(np.sum((u - u_ref) ** 2, 1))
                                       / np.mean(np.sum(u_ref ** 2, 1)))))
    with open(LIMITS) as fh:
        limits = json.load(fh)
    print(f"kernel path against the twin's after {steps} steps: {numbers}")
    for name, value in numbers.items():
        assert value <= limits[name], (name, value, limits[name])
