"""The control, the reference computed in TF32 in the program's place, comes
out not correct under each cell's limits (at the tiny box; calibrate.py
reads it on the card at the cells' own size)."""

import pytest

from harness import catalog
from harness.check import Judge, StandIn, judge_window, split_index, verdict
from harness.client import run_window
from harness.spec import build, spec_of

from conftest import tiny_overrides

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import nonbondedslicing_tpu_torch as nbt
    entry = catalog.cell(catalog.benchmark(), cell)
    over = tiny_overrides(cell)
    config = dict(catalog.config(entry["config"]), **over["config"])
    traffic = dict(catalog.traffic(entry["traffic"]), **over["traffic"])
    limits = catalog.limits(cell)
    system, pos = build(config, nbt)
    ctx = nbt.Context(system, nbt.VerletIntegrator(config["dt_ps"]),
                      nbt.Platform.getPlatformByName("CUDA"),
                      {"Precision": "single", "Device": "cpu"})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, 21)
    ctx.getIntegrator().step(traffic["steps_per_sample"])
    start = ctx.createCheckpoint()
    split = split_index(traffic, 21)
    samples = []
    for k in range(3):
        samples += run_window(
            ctx, traffic["steps_per_sample"], 0.0, 300.0, 11,
            split=(0, split[1]) if split and split[0] == k else None)[0]
    spec = spec_of(config)
    judge = Judge(spec, config, "cpu")
    control = Judge(spec, config, "cpu", mode="tf32")
    _, program = judge_window(judge, samples, start, traffic, 21)
    assert verdict(program, limits)[0] is True
    numbers = judge_window(judge, samples, start, traffic, 21,
                           StandIn(control))[1]
    correct, table = verdict(numbers, limits)
    assert correct is False
    # the control's energies fail on their own
    assert table["energy_rel"]["value"] > table["energy_rel"]["limit"]
