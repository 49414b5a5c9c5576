"""The rigid-water tail of make_md_step's force-only steps on the CPU
(runtime/water_tail.py): its plain twin, the route that chooses it, and
make_md_step's trajectory through it.

On CPU tensors the tail runs its twin, which is the sequence every other
plan runs (the engine's slot->atom unsort, the exclusion rows' forces,
the kick, SETTLE and RATTLE), so the steps through it equal the steps
through the engine's atom forces and make_integrator to the bit.
tests/test_torch_gpu_water_tail.py holds the CUDA kernel against the twin
on the card.  The box is tests/test_torch_md.py's 512 waters (3 cells of
its 0.75 nm cutoff per axis)."""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops.fused import make_fused_engine
from nonbondedslicing_tpu_torch.runtime import profiling, water_tail
from nonbondedslicing_tpu_torch.runtime.constraints import \
    cluster_constraints
from nonbondedslicing_tpu_torch.runtime.fastpath import (make_integrator,
                                                         make_md_step)

from port_systems import KB, build_solute_system
from tests.test_torch_plan import water_box

torch.set_num_threads(2)

N_MOL = 512
DT = 0.001
K = 4


def _water(method=None):
    """(plan, positions, velocities (100 K, seeded), masses, constraints,
    box matrix) of the 512-water box."""
    system, force, positions, masses, constraints, box = water_box(
        nbt, n_mol=N_MOL, method=method)
    rng = np.random.default_rng(7)
    vel = rng.normal(size=positions.shape) * np.sqrt(KB * 100.0
                                                     / masses)[:, None]
    return (tplan.build_plan(force, system), positions, vel, masses,
            constraints, np.diag([box] * 3))


@pytest.fixture(scope="module")
def water():
    plan, pos, vel, masses, constraints, box = _water()
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float32)
    return dict(plan=plan, masses=masses, constraints=constraints, data=data,
                pos=torch.as_tensor(pos, dtype=torch.float32),
                vel=torch.as_tensor(vel, dtype=torch.float32),
                box=torch.as_tensor(box, dtype=torch.float32),
                gvals=torch.as_tensor(plan.global_defaults,
                                      dtype=torch.float32))


def _windows(w, windows, tail):
    """``windows`` windows of K steps as make_md_step's body runs them:
    the engine's atom forces and make_integrator's step, or, with
    ``tail``, the slot forces handed to the tail's plain twin."""
    prepare, apply, _ = make_fused_engine(w["plan"], energies=False,
                                          target_skin=0.09)
    integrate = make_integrator(w["masses"], DT, torch.float32,
                                w["constraints"])
    plain = water_tail.make_water_tail(w["plan"], DT, integrate).plain
    pos, vel, args = w["pos"], w["vel"], (w["box"], w["gvals"], w["data"])
    for _ in range(windows):
        state = prepare(pos, *args)
        for _ in range(K):
            if tail:
                _, slot_f, aux = apply(pos, *args, state, slot_forces=True)
                pos, vel = plain(slot_f, pos, vel, state, aux["lam"])
            else:
                _, forces, _ = apply(pos, *args, state)
                pos, vel = integrate(pos, vel, forces)
    return pos, vel


def test_twin_equals_the_engine_and_integrator(water):
    """One window of K steps: the slot forces through the twin give the
    positions and velocities of the engine's atom forces through
    make_integrator, to the bit."""
    p_ref, v_ref = _windows(water, 1, tail=False)
    p_tail, v_tail = _windows(water, 1, tail=True)
    assert torch.equal(p_tail, p_ref) and torch.equal(v_tail, v_ref)
    assert not torch.equal(p_ref, water["pos"])


def test_make_md_step_unchanged_on_cpu(water):
    """make_md_step takes the tail on the water box and its two windows
    give the positions and velocities of the engine-and-integrator
    composition to the bit; the CPU twin launches nothing."""
    run = make_md_step(water["plan"], water["masses"], DT,
                       constraints=water["constraints"], reuse_steps=K)
    assert run.config["water_tail"] and run.config["reuse_steps"] == K
    before = dict(water_tail.LAUNCHES)
    pos, vel, _ = run(water["pos"], water["vel"], water["box"],
                      water["gvals"], water["data"], 2 * K)
    assert water_tail.LAUNCHES == before
    p_ref, v_ref = _windows(water, 2, tail=False)
    assert torch.equal(pos, p_ref) and torch.equal(vel, v_ref)


def test_slot_forces_refused_off_the_route():
    """apply(slot_forces=True) raises where the tail does not apply: under
    LJPME (the rows' dispersion back-out) and with energies."""
    plan, pos, _, _, _, box = _water(nbt.SlicedNonbondedForce.LJPME)
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float32)
    args = (torch.as_tensor(pos, dtype=torch.float32),
            torch.as_tensor(box, dtype=torch.float32),
            torch.as_tensor(plan.global_defaults, dtype=torch.float32), data)
    prepare, apply, _ = make_fused_engine(plan, energies=False)
    with pytest.raises(ValueError, match="slot_forces"):
        apply(*args, prepare(*args), slot_forces=True)
    plan = _water()[0]
    data = tengine.plan_data(plan, device="cpu", dtype=torch.float32)
    args = args[:3] + (data,)
    prepare, apply, _ = make_fused_engine(plan, energies=True)
    with pytest.raises(ValueError, match="slot_forces"):
        apply(*args, prepare(*args), slot_forces=True)


def _solute():
    """tests/test_torch_md.py's solute box: the 12-site chain (bonds, 1-4s,
    exclusions that are not water triangles) in 216 waters over 3 nm."""
    _, _, positions, _, _, box = water_box(nbt, n_mol=216, seed=5)
    waters = positions.reshape(-1, 3, 3)
    waters = waters + waters[:, :1] * (3.0 / box - 1.0)
    system, force, _, masses, constraints, bonds, _ = build_solute_system(
        nbt, waters.reshape(-1, 3), 3.0)
    return tplan.build_plan(force, system), masses, constraints, bonds


def _route(case):
    """(plan, masses, constraints, make_md_step keywords) of a route case."""
    method = dict(ljpme=nbt.SlicedNonbondedForce.LJPME,
                  ewald=nbt.SlicedNonbondedForce.Ewald).get(case)
    if case == "solute":
        plan, masses, constraints, bonds = _solute()
        return plan, masses, constraints, dict(bonds=bonds)
    plan, _, _, masses, (pairs, dists), _ = _water(method)
    kw = dict(mixed=dict(mixed_precision=True), float64=dict(
        dtype=torch.float64)).get(case, {})
    if case == "bond":
        kw = dict(bonds=[(0, 3, 0.3, 1000.0)])
    if case == "oh_bonds":
        # the two O-H bonds of each water, not its rigid triangle
        oh = [(i, j, d) for tri, ds in zip(pairs, dists)
              for (i, j), d in zip(tri[:2], ds[:2])]
        return plan, masses, cluster_constraints(oh, len(masses)), kw
    return plan, masses, (pairs, dists), kw


ROUTES = {"pme_water": True, "mixed": False, "float64": False,
          "bond": False, "ljpme": False, "ewald": False, "solute": False,
          "oh_bonds": False}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route(case):
    """The tail takes float32 PME water with SETTLE alone: not mixed
    precision, not float64, no bonds, not LJPME or bare Ewald, not the
    solute's cell-kernel plan with its gather (M-SHAKE) constrainer, not
    constraints that are not rigid triangles; make_md_step's config says
    the same as the predicate."""
    plan, masses, constraints, kw = _route(case)
    integrate = make_integrator(masses, DT, kw.get("dtype", torch.float32),
                                constraints)
    _, _, cfg = make_fused_engine(plan, energies=False)
    takes = water_tail.uses_water_tail(
        cfg, integrate.constrainer, dtype=kw.get("dtype", torch.float32),
        mixed_precision=kw.get("mixed_precision", False),
        bonds=kw.get("bonds"))
    assert takes is ROUTES[case]
    run = make_md_step(plan, masses, DT, constraints=constraints, **kw)
    assert run.config["water_tail"] is ROUTES[case]


def test_launch_counter_is_read():
    """profiling.counters() reads the kernel's launches as
    ``launch.water_tail``."""
    assert profiling.counters()["launch.water_tail"] == \
        water_tail.LAUNCHES["water_tail"]
