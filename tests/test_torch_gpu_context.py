"""The user API and the two fallbacks on the card.

* ``Context.step`` on the benchmark's rigid-water box (23,289 atoms) is
  ``make_md_step`` with the Context's K and capacity: equal to the bit
  over step() calls, the graph captured once.
* Bare Ewald through the fused MD step: the CUDA graph of its window
  equals the eager body to the bit over two windows (the k-sum of
  ``ops/ewald.py`` in the graph beside the column kernel in Ewald mode).
* The per-step rebuild (``make_md_step`` below 3 cells per axis): a
  cube of the benchmark state's waters at its density (2.52 nm, 1,596
  atoms) through the Context (all
  pairs and the atom-space PME, graphed windows), constraints kept and
  energies finite; its graph against its eager body over two windows,
  in float64 and in float32: positions, velocities and energy equal to
  the bit (the atom-space PME spreads in int64 fixed point).
* getState twice on the card, with setPositions between, on the rigid
  box under PME and LJPME, on both platforms: forces, energy and
  dE/dlambda equal to the bit.

Marked ``gpu``; they skip (from inside the fixture) where no CUDA device
is present.  On a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_context.py
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime.fastpath import (SIMPLE_WINDOW,
                                                         make_md_step)

from port_systems import (D_HH, D_OH, DT_PS, N_MOLECULES, STATE_FILE,
                          WATER_MASSES, add_constraints, build_system,
                          water_cube, water_system)

pytestmark = pytest.mark.gpu

CAPACITY = 144            # tests/test_torch_gpu_graph.py's


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state(cuda):
    blob = np.load(STATE_FILE)
    return (np.asarray(blob["positions"], dtype=np.float64),
            np.asarray(blob["velocities"], dtype=np.float64))


def _max_constraint_error(pos):
    w = np.asarray(pos).reshape(-1, 3, 3)
    return max(float(np.abs(np.linalg.norm(w[:, a] - w[:, b], axis=-1)
                            - d).max())
               for (a, b), d in (((0, 1), D_OH), ((0, 2), D_OH),
                                 ((1, 2), D_HH)))


def test_context_equals_make_md_step(cuda, state):
    pos_np, vel_np = state
    system, force, box_len, constraints = build_system(nbt)
    add_constraints(system, constraints)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS))
    ctx.setPositions(pos_np)
    ctx.setVelocities(vel_np)
    for _ in range(3):
        ctx.getIntegrator().step(20)
    runs = ctx._compiled[id(force)].md[DT_PS]["runs"]
    assert len(runs) == 1
    run = next(iter(runs.values()))
    assert run.config["graph"] and run.stats["captures"] == 1
    direct = make_md_step(ctx._compiled[id(force)].plan,
                          np.tile(WATER_MASSES, N_MOLECULES), dt=DT_PS,
                          cell_capacity=run.config["capacity"],
                          reuse_steps=run.config["reuse_steps"],
                          constraints=constraints)
    data = tengine.plan_data(ctx._compiled[id(force)].plan, device=cuda,
                             dtype=torch.float32)
    p = torch.as_tensor(pos_np, device=cuda).float()
    v = torch.as_tensor(vel_np, device=cuda).float()
    box = torch.as_tensor(np.diag([box_len] * 3), device=cuda).float()
    for _ in range(3):
        p, v, _ = direct(p, v, box, torch.ones(2, device=cuda), data, 20)
    st = ctx.getState(getPositions=True, getVelocities=True)
    np.testing.assert_array_equal(np.asarray(st.getPositions()),
                                  p.double().cpu().numpy())
    np.testing.assert_array_equal(np.asarray(st.getVelocities()),
                                  v.double().cpu().numpy())


def test_ewald_graph_equals_eager(cuda, state):
    pos_np, vel_np = state
    system, force, box_len, constraints = build_system(nbt, "Ewald")
    plan = tplan.build_plan(force, system)
    run = make_md_step(plan, np.tile(WATER_MASSES, N_MOLECULES), dt=DT_PS,
                       cell_capacity=CAPACITY, constraints=constraints)
    assert run.config["graph"]
    K = run.config["reuse_steps"]
    data = tengine.plan_data(plan, device=cuda, dtype=torch.float32)
    args = (torch.as_tensor(np.diag([box_len] * 3), device=cuda).float(),
            torch.ones(2, device=cuda), data)
    p, v, _ = run(torch.as_tensor(pos_np, device=cuda).float(),
                  torch.as_tensor(vel_np, device=cuda).float(), *args, K)
    p_g, v_g, e_g = run(p, v, *args, 2 * K)
    p_e, v_e, e_e = run.eager(p, v, *args, 2 * K)
    assert run.stats["captures"] == 1 and run.stats["replays"] == 2
    assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
    assert float(e_g) == float(e_e)


@pytest.mark.parametrize("method", ["PME", "LJPME"])
@pytest.mark.parametrize("platform", ["CUDA", "Reference"])
def test_get_state_repeats_to_the_bit(cuda, state, platform, method):
    """The port's counterpart on the card of the JAX package's
    ``test_two_forces.py::test_deterministic_forces``: the rigid box
    through a Context on ``platform`` (CUDA: float32, Reference:
    float64), getState twice with setPositions between."""
    pos_np, _ = state
    system, force, _, _ = build_system(nbt, method)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS),
                      nbt.Platform.getPlatformByName(platform))
    states = []
    for _ in range(2):
        ctx.setPositions(pos_np)
        states.append(ctx.getState(getForces=True, getEnergy=True,
                                   getParameterDerivatives=True))
    a, b = states
    np.testing.assert_array_equal(np.asarray(a.getForces()),
                                  np.asarray(b.getForces()))
    assert a.getPotentialEnergy() == b.getPotentialEnergy()
    assert (a.getEnergyParameterDerivatives()
            == b.getEnergyParameterDerivatives())


def test_per_step_rebuild_cube(cuda, state):
    pos_np, vel_np = state
    box_len = float(np.cbrt(3 * N_MOLECULES / 100.2))
    c_pos, c_vel, edge = water_cube(pos_np, vel_np, box_len, 2.6)
    n_w = len(c_pos) // 3
    system, force, constraints = water_system(nbt, n_w, edge)
    add_constraints(system, constraints)
    plan = tplan.build_plan(force, system)
    assert tfused.fused_config(plan) is None
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS))
    ctx.setPositions(c_pos)
    ctx.setVelocities(c_vel)
    ctx.getIntegrator().step(2 * SIMPLE_WINDOW + 10)
    run = next(iter(ctx._compiled[id(force)].md[DT_PS]["runs"].values()))
    assert run.config["route"] == "all_pairs"
    assert run.config["reuse_steps"] == 1 and run.config["graph"]
    assert run.stats["captures"] == 2 and run.stats["replays"] == 1
    st = ctx.getState(getPositions=True, getEnergy=True)
    assert np.isfinite(st.getPotentialEnergy())
    assert _max_constraint_error(st.getPositions()) <= 1e-5
    # graph against eager in float64 and in float32 over two windows from
    # the Context's state
    vel = np.asarray(ctx.getState(getVelocities=True).getVelocities())
    for dtype in (torch.float64, torch.float32):
        run = make_md_step(plan, np.tile(WATER_MASSES, n_w), dt=DT_PS,
                           dtype=dtype, constraints=constraints)
        args = (torch.as_tensor(np.diag([edge] * 3), device=cuda).to(dtype),
                torch.ones(2, device=cuda, dtype=dtype),
                tengine.plan_data(plan, device=cuda, dtype=dtype))
        p = torch.as_tensor(np.asarray(st.getPositions()),
                            device=cuda).to(dtype)
        v = torch.as_tensor(vel, device=cuda).to(dtype)
        p, v, _ = run(p, v, *args, SIMPLE_WINDOW)
        p_g, v_g, e_g = run(p, v, *args, 2 * SIMPLE_WINDOW)
        p_e, v_e, e_e = run.eager(p, v, *args, 2 * SIMPLE_WINDOW)
        assert run.stats["captures"] == 1 and run.stats["replays"] == 2
        assert torch.equal(p_g, p_e) and torch.equal(v_g, v_e)
        assert float(e_g) == float(e_e)
