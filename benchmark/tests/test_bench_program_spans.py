"""The program's own spans and counters (``metrics/`` readers on
``harness/program_spans.py``): a traced run of the tiny box on the CPU
reports every one of them in the cells that list it; where the program
keeps no records (its ``runtime/profiling.py`` without ``spans``, as a
program from before the spans, or no traced slice) they read None and
the result line leaves them out."""

import importlib
import sys
import types

import numpy as np
import pytest

from harness import catalog, program_spans

BENCH = catalog.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = ("step_replay_ms", "step_energy_ms", "step_wait_ms",
       "getstate_engine_ms", "getstate_wait_ms", "bus_kib_per_step",
       "rebuilds_per_sample")
ENTRIES = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}


def _listed(cell):
    return {name for name, m in ENTRIES.items() if cell in m["workloads"]}


def test_the_entries_read_the_program():
    assert set(ENTRIES) == set(NEW)
    for m in ENTRIES.values():
        assert m["source"] == "program_span" and m["moves"] == "ns_day"
    assert _listed("water23k-pme.dhdl500") == set(NEW)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_them(tiny_run, cell):
    """Each metric a cell lists reads a number; of those, every traced
    slice replays and copies something."""
    code, result = tiny_run(cell, seconds=1.0, trace=1)
    assert code == 0 and result["correct"] is True
    metrics = result["metrics"]
    listed = _listed(cell)
    assert listed <= set(metrics)
    for name in listed:
        assert np.isfinite(metrics[name]["value"])
        assert metrics[name]["value"] >= 0.0
    for name in listed & {"step_replay_ms", "bus_kib_per_step"}:
        assert metrics[name]["value"] > 0.0


def test_without_the_programs_records_they_read_none(tiny_run, monkeypatch):
    """A stand-in for the program's profiling module as it was before the
    spans (``trace`` and ``time_fn`` only): the run reports none of
    these."""
    # the program binds its own module first; the stand-in takes only the
    # entry that the readers look up
    importlib.import_module(program_spans.MODULE)
    stand_in = types.ModuleType(program_spans.MODULE)
    stand_in.trace = stand_in.time_fn = None
    monkeypatch.setitem(sys.modules, program_spans.MODULE, stand_in)
    code, result = tiny_run("water23k-pme.dhdl500", seconds=0.5, trace=1)
    assert code == 0
    assert not set(NEW) & set(result["metrics"])


def test_an_untraced_run_has_no_slice():
    run = types.SimpleNamespace(trace=None, samples=[])
    for name in NEW:
        assert catalog.reader(name)(run) is None
