"""What the benchmark runs, found by name.

* ``BENCHMARK.json`` at the root of the checkout lists the cells and the
  metrics; each per-layer metric names the cells that report it in its
  ``workloads`` list (:func:`metrics_of`);
* ``benchmark/configs/<name>.json``: a configuration (its keys:
  :mod:`harness.spec`), with its own tiny size for the tests
  (``"tiny_cube_edge_nm"``);
* ``benchmark/reference/<method>.py``: the plain reference of the
  configurations whose ``"method"`` is ``<method>`` in lower case, a
  function ``model(spec, device, mode, skin)`` (:func:`reference`; what
  it returns: :mod:`reference`);
* ``benchmark/traffic/<name>.json``: a traffic mix;
* ``benchmark/limits/<cell>.json``: the limits of a cell's comparison;
* ``benchmark/metrics/<name>.py``: a metric's reader, a function
  ``read(run)`` that returns a number or None.

A configuration, a cell, a mix or a metric is added by adding files and
entries; nothing here names one.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark():
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name):
    return _json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name):
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell):
    return _json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))


def cell(bench, name):
    """The workload entry ``name`` of ``bench``; KeyError if none."""
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference(config):
    """The ``model`` function of ``reference/<method>.py``, the plain
    reference of ``config``, whose ``"method"`` names it in lower case
    (what it must give: :mod:`reference`); FileNotFoundError, naming the
    configuration and the module, if there is no such module."""
    name = config["method"].lower()
    path = os.path.join(BENCH_DIR, "reference", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {config['name']}: its method "
            f"{config['method']!r} has no reference module "
            f"{os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.model


def metrics_of(bench, cell_name, traced):
    """The metric entries a run of ``cell_name`` reports.  Traced: the
    per-layer metrics whose ``workloads`` list names the cell; every
    per-layer metric has one, so a new cell reports what it is listed
    for and nothing else.  Untraced: the end-to-end metrics, each where
    its ``workloads`` list names the cell or it has none."""
    if traced:
        return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]
