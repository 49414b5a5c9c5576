"""``integrator.step`` through the port's Context on the CPU.

* The fast path: on the 512-water box of tests/test_torch_md.py (SETTLE,
  PME, float32) ``Context.step`` is ``make_md_step`` with the mass-aware
  K, and equals it to the bit over two windows split across two ``step``
  calls (tests/test_torch_md.py holds ``make_md_step`` to the JAX
  package's).
* The host loop: under ``Precision`` double the per-step loop against the
  JAX Context's on a small NoCutoff system with constraints, to 1e-10.
* The retries: a capacity overflow doubles the cell capacity, a skin
  violation halves K, and a tripped attempt leaves the positions as they
  were: the result equals ``make_md_step`` with the final capacity or K
  from the same state.
* ``mixed``: the Context keeps float64 positions between ``step`` calls.
  The JAX Context casts them to float32 before every run
  (``nonbondedslicing_tpu/models/context.py:650``), which drops their low
  bits at each call; here two calls equal one run of the same length to
  the bit, and the cast would not.
"""

import numpy as np
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from tests.test_torch_plan import water_box

torch.set_num_threads(2)

DT = 0.001
CPU = {"Device": "cpu"}


def _water_context(precision="single", n_mol=512):
    """The rigid-water box with its SETTLE triangles as System
    constraints, through the port's Context on the CPU, at 300 K."""
    system, force, positions, masses, (pairs, dists), box = water_box(
        nbt, n_mol=n_mol)
    for tri, d in zip(pairs, dists):
        for (i, j), dist in zip(tri, d):
            system.addConstraint(i, j, dist)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT),
                      nbt.Platform.getPlatformByName("CUDA"),
                      dict(CPU, Precision=precision))
    ctx.setPositions(positions)
    ctx.setVelocitiesToTemperature(300.0, seed=5)
    plan = tplan.build_plan(force, system)
    return ctx, force, plan, masses, (pairs, dists), box


def _state(ctx):
    st = ctx.getState(getPositions=True, getVelocities=True)
    return np.asarray(st.getPositions()), np.asarray(st.getVelocities())


def _direct_run(plan, masses, constraints, box, pos, vel, steps, **kw):
    run = make_md_step(plan, masses, dt=DT, constraints=constraints, **kw)
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float32)
    p, v, _ = run(pos, vel, np.diag([box] * 3), np.array([1.0]), data, steps)
    return run, p, v


def test_step_equals_make_md_step():
    ctx, force, plan, masses, cons, box = _water_context()
    pos0, vel0 = _state(ctx)
    K = make_md_step(plan, masses, dt=DT,
                     constraints=cons).config["reuse_steps"]
    assert K > 1
    ctx.getIntegrator().step(K)
    ctx.getIntegrator().step(K)
    runs = ctx._compiled[id(force)].md[DT]["runs"]
    assert list(runs) == [(None, None)]
    assert runs[(None, None)].config["reuse_steps"] == K
    p_ctx, v_ctx = _state(ctx)
    _, p, v = _direct_run(plan, masses, cons, box, pos0, vel0, 2 * K)
    np.testing.assert_array_equal(p_ctx, p.double().numpy())
    np.testing.assert_array_equal(v_ctx, v.double().numpy())


def _constrained_drop(api):
    """27 rigid waters of the water box, NoCutoff, their SETTLE triangles
    as System constraints."""
    system, force, positions, _, (pairs, dists), _ = water_box(
        api, n_mol=27)
    force.setNonbondedMethod(api.SlicedNonbondedForce.NoCutoff)
    for tri, d in zip(pairs, dists):
        for (i, j), dist in zip(tri, d):
            system.addConstraint(i, j, dist)
    return system, positions


def test_host_loop_double_matches_jax():
    """Ten steps of one step each: the JAX host loop keeps the constrained
    velocities as a read-only array (``np.asarray`` of a JAX array,
    ``nonbondedslicing_tpu/models/context.py:735``), so its next step's
    in-place kick raises; a writable copy is set back between the steps,
    on both sides."""
    states = []
    for api in (nbs, nbt):
        system, positions = _constrained_drop(api)
        ctx = api.Context(system, api.VerletIntegrator(0.002),
                          api.Platform.getPlatformByName("Reference"),
                          CPU if api is nbt else None)
        ctx.setPositions(positions)
        ctx.setVelocitiesToTemperature(300.0, seed=2)
        for _ in range(10):
            ctx.getIntegrator().step(1)
            ctx.setVelocities(np.array(ctx.getState(
                getVelocities=True).getVelocities()))
        st = ctx.getState(getPositions=True, getVelocities=True,
                          getEnergy=True)
        states.append((np.asarray(st.getPositions()),
                       np.asarray(st.getVelocities()),
                       st.getPotentialEnergy()))
    (p_j, v_j, e_j), (p_t, v_t, e_t) = states
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(v_t, v_j, rtol=0,
                               atol=1e-10 * np.abs(v_j).max())
    assert abs(e_t - e_j) <= 1e-10 * abs(e_j)


def test_capacity_overflow_doubles_the_capacity():
    ctx, force, plan, masses, cons, box = _water_context()
    pos0, vel0 = _state(ctx)
    md = ctx._compiled[id(force)].md.setdefault(
        DT, dict(reuse=None, cap=None, runs={}))
    md["cap"] = 8
    ctx.getIntegrator().step(4)
    assert md["cap"] in (64, 128) and md["reuse"] is None
    assert list(md["runs"]) == [(None, md["cap"])]
    _, p, v = _direct_run(plan, masses, cons, box, pos0, vel0, 4,
                          cell_capacity=md["cap"])
    p_ctx, v_ctx = _state(ctx)
    np.testing.assert_array_equal(p_ctx, p.double().numpy())
    np.testing.assert_array_equal(v_ctx, v.double().numpy())


def test_skin_violation_halves_k():
    """Every atom at 60 nm/ps (the box translates as a whole, 0.06 nm a
    step): K halves until 1, where no skin is needed."""
    ctx, force, plan, masses, cons, box = _water_context()
    pos0, _ = _state(ctx)
    fast = np.full_like(pos0, 60.0)
    ctx.setVelocities(fast)
    ctx.getIntegrator().step(4)
    md = ctx._compiled[id(force)].md[DT]
    assert md["reuse"] == 1 and list(md["runs"]) == [(1, None)]
    _, p, v = _direct_run(plan, masses, cons, box, pos0, fast, 4,
                          reuse_steps=1)
    p_ctx, v_ctx = _state(ctx)
    np.testing.assert_array_equal(p_ctx, p.double().numpy())
    np.testing.assert_array_equal(v_ctx, v.double().numpy())


def test_mixed_keeps_float64_positions():
    ctx, _, plan, masses, cons, box = _water_context("mixed")
    pos0, vel0 = _state(ctx)
    ctx.getIntegrator().step(5)
    ctx.getIntegrator().step(5)
    p_ctx, v_ctx = _state(ctx)
    run = make_md_step(plan, masses, dt=DT, constraints=cons,
                       mixed_precision=True)
    assert run.config["mixed_precision"] and run.config["reuse_steps"] == 5
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float32)
    args = (np.diag([box] * 3), np.array([1.0]), data, 5)
    p5, v5, _ = run(pos0, vel0, *args)
    p, v, _ = run(p5, v5, *args)
    assert p.dtype == torch.float64
    np.testing.assert_array_equal(p_ctx, p.numpy())
    np.testing.assert_array_equal(v_ctx, v.double().numpy())
    # the JAX Context's cast between the calls changes the trajectory
    p_cast, _, _ = run(p5.float().double(), v5, *args)
    assert not np.array_equal(p_cast.numpy(), p.numpy())
