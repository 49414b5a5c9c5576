"""Every configuration, traffic mix, limit file and metric reader is
found by its name, and BENCHMARK.json keeps to the benchmark's form."""

import inspect
import json
import os
import re
import shutil

import pytest

from harness import catalog, spec

BENCH = catalog.benchmark()
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


def _add_configuration(tmp_path, monkeypatch, method="PME", module=None):
    """A copy of the benchmark's folders under ``tmp_path``, with a copy of
    water23k-pme named water-copy (its own tiny size, the nonbonded method
    ``method``), its limits file and its entries in BENCHMARK.json, and
    ``module`` as the text of ``reference/pme.py``; ``catalog`` reads the
    copy.  Returns the new cell's name."""
    bench_dir = tmp_path / "benchmark"
    bench_dir.mkdir()
    for name in os.listdir(catalog.BENCH_DIR):
        src = os.path.join(catalog.BENCH_DIR, name)
        if name in ("configs", "limits"):
            shutil.copytree(src, bench_dir / name)
        elif name == "reference":
            (bench_dir / name).mkdir()
            for file in os.listdir(src):
                os.symlink(os.path.join(src, file), bench_dir / name / file)
        else:
            os.symlink(src, bench_dir / name)
    if module is not None:
        (bench_dir / "reference" / "pme.py").unlink()
        (bench_dir / "reference" / "pme.py").write_text(module)
    config = dict(catalog.config("water23k-pme"), name="water-copy",
                  tiny_cube_edge_nm=2.4, method=method)
    (bench_dir / "configs" / "water-copy.json").write_text(json.dumps(config))
    shutil.copy(bench_dir / "limits" / "water23k-pme.dhdl500.json",
                bench_dir / "limits" / "water-copy.dhdl500.json")
    bench = catalog.benchmark()
    bench["configs"].append(dict(BENCH["configs"][0], name="water-copy",
                                 file="benchmark/configs/water-copy.json"))
    bench["workloads"].append(dict(
        catalog.cell(BENCH, "water23k-pme.dhdl500"),
        name="water-copy.dhdl500", config="water-copy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(catalog, "ROOT", str(tmp_path))
    monkeypatch.setattr(catalog, "BENCH_DIR", str(bench_dir))
    return "water-copy.dhdl500"


def test_an_added_configuration_needs_no_edit(tmp_path, monkeypatch,
                                              tiny_run):
    """A configuration is files and entries: a copy of water23k-pme under a
    new name, with its own tiny size, its limits file and its entries in
    BENCHMARK.json, runs at its tiny size and is checked against the
    reference its method names; it reports every per-layer metric that
    lists no cells."""
    from conftest import tiny_overrides
    cell = _add_configuration(tmp_path, monkeypatch)
    assert tiny_overrides(cell)["config"]["cube_edge_nm"] == 2.4
    code, result = tiny_run(cell, seconds=0.5)
    assert code == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"ns_day", "setup_s"}
    traced = {m["name"] for m in catalog.metrics_of(catalog.benchmark(), cell,
                                                    True)}
    assert traced == {m["name"] for m in BENCH["per_layer"]
                      if "workloads" not in m}


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
