"""Shared set-up of the benchmark's tests: the benchmark's folder and the
checkout's root on the import path, and tiny cells that run on the CPU.

Run them with ``python -m pytest benchmark/tests`` from the root of the
checkout; the tests marked ``gpu`` skip where there is no CUDA device."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

# a few steps a sample; the configuration is cut to the cube its file
# states (tiny_cube_edge_nm)
TINY_TRAFFIC = {"steps_per_sample": 8, "check_energies": 2,
                "check_intervals": 1, "trace_skip_samples": 0,
                "trace_samples": 1}
# a mix that splits a sample splits the tiny one after 4 of its 8 steps
TINY_SPLIT = {"check_split_steps": 4, "check_split_within": 2}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skipped without one")


def tiny_overrides(cell):
    """The overrides of ``cell``'s configuration and traffic at the tiny
    size."""
    from harness import catalog
    entry = catalog.cell(catalog.benchmark(), cell)
    traffic = dict(TINY_TRAFFIC)
    if "check_split_steps" in catalog.traffic(entry["traffic"]):
        traffic.update(TINY_SPLIT)
    edge = catalog.config(entry["config"])["tiny_cube_edge_nm"]
    return {"config": {"cube_edge_nm": edge, "stated": {}},
            "traffic": traffic}


@pytest.fixture
def tiny_run():
    """tiny_run(cell, seconds=1.0, trace=0, program=None, device="cpu")
    -> (exit code, result) of one run of ``cell`` at the tiny size."""
    import run as run_mod

    def go(cell, seconds=1.0, trace=0, program=None, device="cpu",
           seed=3000000011):
        args = run_mod.parse(["--workload", cell, "--seed", str(seed),
                              "--seconds", str(seconds),
                              "--trace", str(trace)])
        return run_mod.run_cell(args, device=device,
                                overrides=tiny_overrides(cell),
                                program=program)

    return go
