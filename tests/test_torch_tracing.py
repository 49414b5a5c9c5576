"""The port's spans and counters (``runtime/profiling.py``) through its
Context, on the CPU.

Each profiled call runs under ``profiling.trace`` (``torch.profiler``,
CPU activity) on small rigid-water PME boxes: 216 waters at a 0.5 nm
cutoff, three cells a side, take the fused MD step; 125 waters at 0.75 nm
take the per-step path over the generic engine.  Checked: the span tree of one
``step()`` and one ``getState`` (names, parents, each child inside its
parent), that nothing is recorded without a profiler, that a new session
clears the records, that the spans are plain host events of the profiler
(no user annotations), that ``bus.*_bytes`` are the bytes of the arrays
copied, that ``counters()`` holds the launch counters, that retries are
counted, and that the records are bounded.
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import cuda_direct, cuda_pme
from nonbondedslicing_tpu_torch.runtime import profiling

from tests.test_torch_plan import water_box

torch.set_num_threads(2)

DT = 0.001
STEP_CHILDREN = ["nbs.step.copy_in", "nbs.step.replay", "nbs.step.energy",
                 "nbs.step.guard", "nbs.step.copy_out"]
EVAL_CHILDREN = ["nbs.eval.copy_in", "nbs.eval.engine", "nbs.eval.guard",
                 "nbs.eval.reduce", "nbs.eval.copy_out"]
STAGES = {"nbs.engine.self_plasma", "nbs.engine.reciprocal",
          "nbs.engine.direct", "nbs.engine.exclusions", "nbs.engine.nb14"}


def _context(n_mol, cutoff):
    system, force, positions, _, (pairs, dists), _ = water_box(
        nbt, n_mol=n_mol)
    force.setCutoffDistance(cutoff)
    for tri, d in zip(pairs, dists):
        for (i, j), dist in zip(tri, d):
            system.addConstraint(i, j, dist)
    force.addEnergyParameterDerivative("lam")
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT),
                      nbt.Platform.getPlatformByName("CUDA"),
                      {"Device": "cpu"})
    ctx.setPositions(positions)
    ctx.setVelocitiesToTemperature(300.0, seed=5)
    return ctx, force


def _warm(ctx):
    ctx.getIntegrator().step(4)
    ctx.getState(getEnergy=True, getParameterDerivatives=True)
    return ctx


@pytest.fixture(scope="module")
def fused():
    ctx, force = _context(216, 0.5)
    _warm(ctx)
    assert ctx._compiled[id(force)].md[DT]["runs"][(None, None)].config[
        "reuse_steps"] > 1
    return ctx


@pytest.fixture(scope="module")
def per_step():
    ctx, force = _context(125, 0.75)
    _warm(ctx)
    assert ctx._compiled[id(force)].md[DT]["runs"][(None, None)].config[
        "reuse_steps"] == 1
    return ctx


def _profiled(fn, log_dir):
    """``fn()`` under ``profiling.trace`` (a new session, CPU activity on
    the CPU); returns (profiler, the session's records)."""
    with profiling.trace(log_dir) as prof:
        fn()
    return prof, profiling.spans()


def _sample(ctx):
    ctx.getIntegrator().step(4)
    ctx.getState(getEnergy=True, getParameterDerivatives=True)


def _children(records, parent):
    return [r for r in records if r.parent is parent]


@pytest.mark.parametrize("path", ["fused", "per_step"])
def test_span_tree_of_step_and_getState(request, path, tmp_path):
    ctx = request.getfixturevalue(path)
    _, records = _profiled(lambda: _sample(ctx), tmp_path)
    for r in records:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns
            assert r.end_ns <= r.parent.end_ns
            assert r.call == r.parent.call
    top = _children(records, None)
    assert [(r.name, r.call) for r in top] == [("nbs.step", 1),
                                              ("nbs.getState", 2)]
    step, state = top
    kids = _children(records, step)
    assert [r.name for r in kids] == STEP_CHILDREN
    # the steps' evaluations (eager on the CPU) and the final one with
    # energies, stage by stage
    for r in kids[1:3]:
        names = {c.name for c in _children(records, r)}
        assert "nbs.engine.direct" in names and names <= STAGES
    for earlier, later in zip(kids, kids[1:]):
        assert earlier.end_ns <= later.start_ns
    (evaluation,) = _children(records, state)
    assert evaluation.name == "nbs.eval"
    kids = _children(records, evaluation)
    assert [r.name for r in kids] == EVAL_CHILDREN
    stages = [r.name for r in _children(records, kids[1])]
    assert stages == ["nbs.engine.self_plasma", "nbs.engine.reciprocal",
                      "nbs.engine.direct", "nbs.engine.exclusions",
                      "nbs.engine.nb14"]


def test_nothing_recorded_without_a_profiler(fused):
    assert profiling.span("nbs.a") is profiling.span("nbs.b")
    before = profiling.spans()
    bytes_before = profiling.counters().get("bus.h2d_bytes", 0)
    _sample(fused)
    fused.createCheckpoint()
    assert profiling.spans() == before
    # counters are always on
    assert profiling.counters()["bus.h2d_bytes"] > bytes_before


def test_a_new_session_clears_the_records(fused, tmp_path):
    cpu = [torch.profiler.ProfilerActivity.CPU]
    fused.createCheckpoint()
    with torch.profiler.profile(activities=cpu):
        fused.getIntegrator().step(2)
    assert [r.name for r in _children(profiling.spans(), None)] == [
        "nbs.step"]
    # a span with no profiler sees the session end; the next session's
    # first span starts a new list
    fused.createCheckpoint()
    with torch.profiler.profile(activities=cpu):
        fused.createCheckpoint()
    assert [(r.name, r.call, r.parent) for r in profiling.spans()] == [
        ("nbs.checkpoint", 1, None)]
    # trace() starts a new list, even straight after another session
    with profiling.trace(tmp_path):
        fused.getState(getEnergy=True)
    assert [(r.name, r.call) for r in _children(profiling.spans(), None)] \
        == [("nbs.getState", 1)]
    assert (tmp_path / "trace.json").exists()


def test_spans_are_host_events_not_user_annotations(fused, tmp_path):
    prof, records = _profiled(lambda: _sample(fused), tmp_path)
    events = [e for e in prof.events() if e.name.startswith("nbs.")]
    assert sorted(e.name for e in events) == sorted(r.name for r in records)
    for e in events:
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU


def test_bus_bytes_are_the_bytes_copied(fused, tmp_path):
    force = fused.getSystem().getForce(0)
    plan = fused._compiled[id(force)].plan
    n, g = plan.num_particles, len(plan.global_names)
    s, d = plan.num_slices, len(plan.deriv_names)
    before = profiling.counters()
    _, records = _profiled(lambda: _sample(fused), tmp_path)
    after = profiling.counters()
    credited = {}
    for r in records:
        for key, value in r.counts.items():
            credited[(r.name, key)] = credited.get((r.name, key), 0) + value
    coords = n * 3 * 8                              # float64 (N, 3)
    assert credited == {
        # positions, velocities, box, gvals in; the guard maxima and the
        # positions and velocities out
        ("nbs.step.copy_in", "bus.h2d_bytes"): 2 * coords + 72 + 8 * g,
        ("nbs.step.guard", "bus.d2h_bytes"): 3 * 8,
        ("nbs.step.copy_out", "bus.d2h_bytes"): 2 * coords,
        # positions, box, gvals in; overflow and span, the energy and the
        # derivatives, the forces out; the lambda sources and the
        # derivative mask in
        ("nbs.eval.copy_in", "bus.h2d_bytes"): coords + 72 + 8 * g,
        ("nbs.eval.guard", "bus.d2h_bytes"): 2 * 8,
        ("nbs.eval.reduce", "bus.h2d_bytes"): s * 2 * 8 + d * s * 2 * 8,
        ("nbs.eval.reduce", "bus.d2h_bytes"): 8 + 8 * d,
        ("nbs.eval.copy_out", "bus.d2h_bytes"): coords}
    for key in ("bus.h2d_bytes", "bus.d2h_bytes"):
        assert after[key] - before[key] == sum(
            v for (_, k), v in credited.items() if k == key)


def test_counters_include_the_launch_counters(fused):
    _sample(fused)
    table = profiling.counters()
    for launches in (cuda_direct.LAUNCHES, cuda_pme.LAUNCHES):
        for name, n in launches.items():
            assert table["launch." + name] == n
    assert {"bus.h2d_bytes", "bus.d2h_bytes"} <= set(table)


def test_a_retry_is_counted_in_its_step(tmp_path):
    """A cell capacity of 8 overflows: each doubling is a retry, counted
    in ``md.retries`` and credited to the step that made it."""
    ctx, force = _context(216, 0.5)
    md = ctx._compiled[id(force)].md.setdefault(
        DT, dict(reuse=None, cap=None, runs={}))
    md["cap"] = 8
    before = profiling.counters().get("md.retries", 0)
    _, records = _profiled(lambda: ctx.getIntegrator().step(2), tmp_path)
    retries = profiling.counters()["md.retries"] - before
    assert retries >= 1 and md["cap"] == 8 * 2 ** retries
    step = _children(records, None)[0]
    assert step.name == "nbs.step" and step.counts["md.retries"] == retries
    # each attempt ran its copy-in, windows and guard; only the last its
    # copy-out
    names = [r.name for r in _children(records, step)]
    assert names.count("nbs.step.guard") == retries + 1
    assert names.count("nbs.step.copy_out") == 1


def test_records_are_bounded(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    before = profiling.counters().get("spans.dropped", 0)

    def nest():
        with profiling.span("nbs.a"):
            for _ in range(4):
                with profiling.span("nbs.b"):
                    profiling.count("test.events")

    _, records = _profiled(nest, tmp_path)
    assert [r.name for r in records] == ["nbs.a", "nbs.b", "nbs.b"]
    assert all(r.counts == {"test.events": 1} for r in records[1:])
    assert profiling.counters()["spans.dropped"] - before == 2
    np.testing.assert_array_equal([r.call for r in records], [1, 1, 1])
