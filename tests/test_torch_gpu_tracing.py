"""The port's spans on the card: a graphed ``step()`` and a ``getState``
of the benchmark's rigid-water box (23,289 atoms) through the Context,
profiled with CUDA activity.

* No event on the device's timeline carries a span's name: the spans
  are host events (``runtime/profiling.py``), not user annotations.
* ``graph.replays`` counts what ``_WindowGraphs.stats`` counts.
* The profiled replays still equal the eager body to the bit.

Marked ``gpu``; it skips (from inside the fixture) where no CUDA device
is present.  On a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_tracing.py
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.runtime import profiling

from port_systems import (DT_PS, STATE_FILE, add_constraints,
                          build_system)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 machine)")
    return torch.device("cuda")


def test_spans_leave_no_device_mark_and_replays_stay_bitwise(cuda):
    blob = np.load(STATE_FILE)
    system, force, _, constraints = build_system(nbt)
    add_constraints(system, constraints)
    ctx = nbt.Context(system, nbt.VerletIntegrator(DT_PS))
    ctx.setPositions(np.asarray(blob["positions"], dtype=np.float64))
    ctx.setVelocities(np.asarray(blob["velocities"], dtype=np.float64))
    ctx.getIntegrator().step(20)                  # captures the window
    ctx.getState(getEnergy=True, getParameterDerivatives=True)
    comp = ctx._compiled[id(force)]
    (run,) = comp.md[DT_PS]["runs"].values()
    K = run.config["reuse_steps"]
    pos0, vel0 = ctx._positions.copy(), ctx._velocities.copy()
    replays0 = run.stats["replays"]
    before = profiling.counters()
    kinds = [torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=kinds) as prof:
        ctx.getIntegrator().step(2 * K)
        ctx.getState(getEnergy=True, getParameterDerivatives=True)
        torch.cuda.synchronize()
    after = profiling.counters()
    records = profiling.spans()
    names = {r.name for r in records}
    assert {"nbs.step", "nbs.step.replay", "nbs.getState",
            "nbs.eval.engine", "nbs.engine.direct"} <= names
    assert "nbs.step.capture" not in names
    events = prof.events()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert on_card and not [e.name for e in on_card
                            if e.name.startswith("nbs.")]
    host = [e for e in events if e.name.startswith("nbs.")]
    assert len(host) == len(records)
    assert not any(e.is_user_annotation for e in host)
    replays = run.stats["replays"] - replays0
    assert replays == 2
    assert after["graph.replays"] - before["graph.replays"] == replays
    assert sum(r.counts.get("graph.replays", 0) for r in records) == replays
    assert after.get("graph.captures", 0) == before.get("graph.captures", 0)
    # the profiled replays against the eager body from the same state
    gvals = np.ones(len(comp.plan.global_names))
    p_e, v_e, _ = run.eager(pos0, vel0, ctx._box, gvals, comp.data, 2 * K)
    np.testing.assert_array_equal(ctx._positions, p_e.double().cpu().numpy())
    np.testing.assert_array_equal(ctx._velocities,
                                  v_e.double().cpu().numpy())
