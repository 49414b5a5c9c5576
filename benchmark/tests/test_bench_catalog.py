"""Every configuration, traffic mix, limit file and metric reader is
found by its name, and BENCHMARK.json keeps to the benchmark's form."""

import os
import re

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
