#!/usr/bin/env python3
"""The benchmark of nonbondedslicing_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Runs the cell named in BENCHMARK.json: builds its configuration's System
(``configs/<name>.json``), makes a Context on the CUDA platform, draws the
velocities at the configuration's temperature from ``--seed``, warms up
one sample of the cell's traffic (``traffic/<name>.json``), then drives
the Context as one closed-loop client for ``--seconds`` seconds
(``harness/client.py``).  After the window it checks the outputs against
the plain float64 reference (``harness/check.py``, ``reference/``,
``limits/<cell>.json``) and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit.  The numbers and
limits are also the last lines of standard error.

Exits with 2, and prints no result, where there is no CUDA device or too
few of them, and with 3 where JAX, jaxlib, flax or the JAX package
nonbondedslicing_tpu is loaded once the window has closed.  The program's
kernel library, and any other build or kernel cache, go under the
checkout's build/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build")
CACHES = {
    "NBS_TORCH_BUILD_DIR": os.path.join(BUILD, "nonbondedslicing_tpu_torch"),
    "TORCH_EXTENSIONS_DIR": os.path.join(BUILD, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(BUILD, "triton"),
    "CUDA_CACHE_PATH": os.path.join(BUILD, "cuda_cache"),
}


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True,
                        help="a workload name of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True,
                        help="draws the velocities and the checked samples")
    parser.add_argument("--seconds", type=float, required=True,
                        help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: per-layer metrics from a profiled slice")
    return parser.parse_args(argv)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def sample_times(samples, np):
    """A line on the samples outside the profiled slice: ms per sample,
    ms per step of step(), ms of getState."""
    plain = [s for s in samples if not s.profiled] or samples
    total = [1e3 * s.total_s for s in plain]
    step = np.median([1e3 * s.step_s / s.steps for s in plain])
    state = np.median([1e3 * s.getstate_s for s in plain])
    return (f"run.py: ms per sample (min, median, max) {min(total):.3f}, "
            f"{float(np.median(total)):.3f}, {max(total):.3f}; ms/step of "
            f"step() {step:.4f}; getState ms {state:.3f}")


class Run:
    """What a metric reader reads (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(args, device="cuda", overrides=None, program=None):
    """One run of the cell ``args.workload``; returns (exit code, result
    dict or None).  ``device`` "cpu" and ``overrides`` ({"config": {...},
    "traffic": {...}, "limits": {...}} merged into the files' contents)
    serve the tests; ``program`` stands in for the package under test."""
    from harness import catalog, guard
    from harness.check import (Judge, failed_samples, judge_window,
                               split_index, verdict)
    from harness.client import run_sample, run_window, state_of
    from harness.spec import build, spec_of
    from harness.trace import Tracer, csrc_kernels
    from reference.ewald import eval_grid
    from reference.pairs import count_within
    import numpy as np
    import torch

    overrides = overrides or {}
    bench = catalog.benchmark()
    cell = catalog.cell(bench, args.workload)
    config = {**catalog.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**catalog.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    limits = {**catalog.limits(cell["name"]), **overrides.get("limits", {})}
    # loaded before anything is built, so that a missing module costs no
    # set-up and whatever it loads is in sys.modules for the guard
    model = catalog.reference(config)
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError(f"traffic {traffic['name']}: the client is one "
                         "closed loop")
    if device == "cuda":
        problem = guard.card_problem(torch, int(cell["chips"]))
        if problem:
            log(f"run.py: {problem}")
            return 2, None
    if program is None:
        import nonbondedslicing_tpu_torch as program
    dev = torch.device(device)
    phases = [("imports", time.perf_counter())]

    # ---- set-up: the System, the Context, one sample of warm-up
    system, positions = build(config, program)
    phases.append(("system", time.perf_counter()))
    platform = program.Platform.getPlatformByName(config["platform"])
    props = {"Precision": config["precision"]}
    if device == "cpu":
        props["Device"] = "cpu"
    context = program.Context(system, program.VerletIntegrator(
        float(config["dt_ps"])), platform, props)
    context.setPositions(positions)
    context.setVelocitiesToTemperature(float(config["temperature_k"]),
                                       args.seed)
    phases.append(("context", time.perf_counter()))
    steps = int(traffic["steps_per_sample"])
    split = split_index(traffic, args.seed)
    # the window's shapes: whole samples, and the split one's two calls
    warm = int(traffic["warmup_samples"])
    for k in range(warm + bool(split)):
        run_sample(context, steps, split[1] if k == warm else None)
        context.getState(getEnergy=True, getParameterDerivatives=True)
        context.createCheckpoint()
    if device == "cuda":
        torch.cuda.synchronize()
    start = context.createCheckpoint()
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - T_START

    # ---- the window
    tracer = None
    if args.trace:
        tracer = Tracer(torch, int(traffic["trace_skip_samples"]),
                        int(traffic["trace_samples"]), steps,
                        cuda=device == "cuda")
    samples, window_s = run_window(
        context, steps, args.seconds, float(config["temperature_k"]),
        int(traffic["lambda_states"]), tracer=tracer, split=split)
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    t_window = time.perf_counter()
    summary = None
    if tracer is not None:
        tracer.close(len(samples))
        pkg = os.path.dirname(os.path.abspath(program.__file__))
        summary = tracer.summarize(csrc_kernels(pkg))
    t_trace = time.perf_counter()
    del context, system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the check, against the plain reference
    spec = spec_of(config)
    judge = Judge(spec, config, dev, model=model)
    per, numbers = judge_window(judge, samples, start, traffic, args.seed)
    correct, checks = verdict(numbers, limits)
    failed = failed_samples(per, limits)
    log(f"run.py: set-up {setup_s:.3f} s, window {window_s:.3f} s "
        f"({len(samples)} samples), trace {t_trace - t_window:.3f} s, "
        f"check {time.perf_counter() - t_trace:.3f} s")
    log(sample_times(samples, np))
    log("run.py: set-up phases (s) " + ", ".join(
        f"{name} {t - t0:.3f}" for (name, t), t0 in
        zip(phases, [T_START] + [t for _, t in phases[:-1]])))

    # ---- the metrics
    work = {}
    if summary is not None:
        last = samples[min(len(samples), tracer.first + tracer.count) - 1]
        pos, _ = state_of(last.checkpoint)
        work = dict(
            pairs_within_cutoff=count_within(
                torch.as_tensor(pos, device=dev), judge.evaluator.box64,
                spec.cutoff, judge.evaluator.excluded_keys),
            atoms=spec.n_atoms, subsets=spec.n_subsets,
            grid_points=int(np.prod(eval_grid(spec.box, spec.cutoff,
                                              spec.tolerance))))
    run = Run(cell=cell["name"], config=config, traffic=traffic,
              setup_s=setup_s, window_s=window_s, samples=samples,
              dt_ps=float(config["dt_ps"]), trace=summary, work=work)
    metrics = {}
    for entry in catalog.metrics_of(bench, cell["name"], bool(args.trace)):
        value = catalog.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(cell["chips"]), "memory_peak_bytes": peak,
                "power_limit_w": guard.power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    # the last look at the process, after the reference and the readers
    found = guard.forbidden_modules()
    if found:
        log("run.py: modules of JAX or the JAX package are loaded: "
            + ", ".join(found))
        return 3, None
    result = {"correct": bool(correct), "attempted": len(samples),
              "failed": int(failed), "metrics": metrics, "device": info}
    if summary is not None:
        info["busy_s"] = summary.busy_us * 1e-6
        info["window_s"] = summary.window_us * 1e-6
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return 0, result


def main(argv=None):
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = path
    sys.path[:0] = [HERE, ROOT]
    code, result = run_cell(args)
    if result is None:
        return code
    for name, check in result["checks"].items():
        log(f"check {name} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
