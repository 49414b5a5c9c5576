"""Every configuration, traffic mix, limit file and metric reader is
found by its name, and BENCHMARK.json keeps to the benchmark's form."""

import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import catalog, spec

BENCH = catalog.benchmark()
# the checkout's root, which holds the port (the tests below point
# ``catalog`` at copies)
REPO = catalog.ROOT
ADDED_CONFIG = "water-copy"
ADDED_CELL = f"{ADDED_CONFIG}.dhdl500"
OWN_METRIC = f"md_step_ms.{ADDED_CONFIG}"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cells_find_their_files(entry):
    assert NAME.match(entry["name"]) and entry["chips"] == 1
    config = catalog.config(entry["config"])
    traffic = catalog.traffic(entry["traffic"])
    limits = catalog.limits(entry["name"])
    assert config["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    assert limits and all(v > 0 for v in limits.values())
    for traced in (False, True):
        assert catalog.metrics_of(BENCH, entry["name"], traced)


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configurations_build_what_they_state(entry):
    path = os.path.join(catalog.ROOT, entry["file"])
    assert os.path.exists(path)
    built = spec.spec_of(catalog.config(entry["name"]))
    assert built.n_atoms == catalog.config(entry["name"])["stated"]["atoms"]


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configurations_state_their_tiny_size_and_reference(entry):
    config = catalog.config(entry["name"])
    assert "tiny_cube_edge_nm" in config, "no tiny_cube_edge_nm"
    assert 0 < config["tiny_cube_edge_nm"] < config["state_box_nm"]
    assert os.path.isfile(os.path.join(
        catalog.BENCH_DIR, "reference", f"{config['method'].lower()}.py"))
    model = catalog.reference(config)
    assert list(inspect.signature(model).parameters) == [
        "spec", "device", "mode", "skin"]


def test_a_wrong_statement_is_refused():
    config = dict(catalog.config("water23k-pme"))
    config["stated"] = dict(config["stated"], atoms=23290)
    with pytest.raises(ValueError):
        spec.spec_of(config)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_find_their_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(catalog.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m


def test_per_layer_metrics_name_their_cells():
    """A per-layer metric goes to the cells its ``workloads`` list names,
    each a cell that reports the end-to-end metric it moves."""
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m.get("workloads"), f"{m['name']} names no cells"
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))


def test_an_added_cell_needs_no_edit(tmp_path, monkeypatch):
    """A cell is an entry and files: a new metric reader in a file of its
    own is found by name."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "steps_total.py").write_text(
        "def read(run):\n    return sum(s.steps for s in run.samples)\n")
    monkeypatch.setattr(catalog, "BENCH_DIR", str(tmp_path))

    class Run:
        samples = [type("S", (), {"steps": 50})(), type("S", (), {
            "steps": 50})()]

    assert catalog.reader("steps_total")(Run) == 100


# a reference module that loads JAX as it is imported
LOADS_JAX = """import sys, types
sys.modules["jax"] = types.ModuleType("jax")
from reference.pme import model  # noqa: E402,F401
"""


def _add_configuration(tmp_path, monkeypatch, method="PME", module=None,
                       listed=False):
    """A copy of the benchmark (its folder and BENCHMARK.json) under
    ``tmp_path``, with a copy of water23k-pme named water-copy (its own
    tiny size, the nonbonded method ``method``), its limits file and its
    entries in BENCHMARK.json, and ``module`` as the text of
    ``reference/pme.py``; ``catalog`` reads the copy.  The new cell
    reports a per-layer metric of its own, ``md_step_ms.water-copy`` (a
    copy of ``md_step_ms``'s reader); ``listed`` adds it to every other
    per-layer metric's list as well.  Returns the new cell's name."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(catalog.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if module is not None:
        (bench_dir / "reference" / "pme.py").write_text(module)
    config = dict(catalog.config("water23k-pme"), name=ADDED_CONFIG,
                  tiny_cube_edge_nm=2.4, method=method)
    (bench_dir / "configs" / f"{ADDED_CONFIG}.json").write_text(
        json.dumps(config))
    shutil.copy(bench_dir / "limits" / "water23k-pme.dhdl500.json",
                bench_dir / "limits" / f"{ADDED_CELL}.json")
    shutil.copy(bench_dir / "metrics" / "md_step_ms.py",
                bench_dir / "metrics" / f"{OWN_METRIC}.py")
    bench = catalog.benchmark()
    bench["configs"].append(dict(
        BENCH["configs"][0], name=ADDED_CONFIG,
        file=f"benchmark/configs/{ADDED_CONFIG}.json"))
    bench["workloads"].append(dict(
        catalog.cell(BENCH, "water23k-pme.dhdl500"),
        name=ADDED_CELL, config=ADDED_CONFIG))
    if listed:
        for m in bench["per_layer"]:
            m["workloads"].append(ADDED_CELL)
    own = next(m for m in BENCH["per_layer"] if m["name"] == "md_step_ms")
    bench["per_layer"].append(dict(own, name=OWN_METRIC,
                                   workloads=[ADDED_CELL]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(catalog, "ROOT", str(tmp_path))
    monkeypatch.setattr(catalog, "BENCH_DIR", str(bench_dir))
    return ADDED_CELL


@pytest.mark.parametrize("listed", [False, True],
                         ids=["in_no_list", "in_every_list"])
def test_an_added_cell_passes_the_per_cell_tests(tmp_path, monkeypatch,
                                                 tiny_run, listed):
    """A cell is files and one new entry of each kind: a copy of
    water23k-pme under a new name, with its own tiny size, its limits
    file, a per-layer metric of its own and its entries in BENCHMARK.json,
    passes every per-cell and per-configuration test of the copy's
    ``benchmark/tests``, whether it is in no existing per-layer metric's
    list or in every one.  A traced run reports its own metric and, where
    it is listed, every program span's metric (those of the device trace
    read only on a card)."""
    cell = _add_configuration(tmp_path, monkeypatch, listed=listed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", str(tmp_path / "benchmark" / "tests"),
         "-k", ADDED_CONFIG, "-p", "no:cacheprovider", "-q"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = re.search(r"(\d+) passed", summary)
    # 3 catalog, 1 control, 4 faults, 1 spans, 2 reference cases, and
    # its own metric's reader
    assert passed and int(passed.group(1)) >= 12, summary

    from conftest import tiny_overrides
    assert tiny_overrides(cell)["config"]["cube_edge_nm"] == 2.4
    bench = catalog.benchmark()
    assert {m["name"] for m in catalog.metrics_of(bench, cell, False)} == {
        "ns_day", "setup_s"}
    offered = {m["name"] for m in catalog.metrics_of(bench, cell, True)}
    every = {m["name"] for m in bench["per_layer"]}
    assert offered == (every if listed else {OWN_METRIC})
    code, result = tiny_run(cell, seconds=1.0, trace=1)
    assert code == 0 and result["correct"] is True
    spans = {m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span"}
    assert (spans if listed else {OWN_METRIC}) <= set(result["metrics"])
    assert set(result["metrics"]) <= offered


def test_a_method_with_no_reference_fails_before_set_up(tmp_path,
                                                        monkeypatch,
                                                        tiny_run):
    """A configuration whose method has no reference module fails the run
    with the configuration's and the module's names, before anything is
    built: the stand-in program here cannot build."""
    cell = _add_configuration(tmp_path, monkeypatch, method="LJPME")
    with pytest.raises(FileNotFoundError,
                       match="water-copy.*reference/ljpme.py"):
        tiny_run(cell, seconds=0.0, program=object())


def test_a_reference_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                                    tiny_run):
    """A reference module that loads JAX is caught by the run's look at
    its modules: a non-zero exit and no result."""
    import sys
    assert "jax" not in sys.modules
    cell = _add_configuration(tmp_path, monkeypatch, module=LOADS_JAX)
    try:
        code, result = tiny_run(cell, seconds=0.0)
    finally:
        sys.modules.pop("jax", None)
    assert code != 0 and result is None
