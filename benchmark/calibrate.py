#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on one NVIDIA GPU.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--samples N] [--out FILE]

In one process, for each seed: the velocities drawn from the seed, one
warm-up sample, then ``--samples`` samples of the cell's traffic through
the Context as a run's window drives it, and the run's comparison with the
float64 reference (``harness/check.py``): the program's numbers.  For each
control seed the same window, then the control in the program's place: the
reference computed in TF32 (``reference/precision.py``), its energies at
the window's positions and its MD step from the window's states, judged
against the float64 reference by the run's own comparison
(``judge_window``).  Prints one JSON line per seed and writes them all to
``--out``.  The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--samples", type=int, default=0,
                        help="samples a window (default: the traffic's "
                             "check_energies + 1)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path[:0] = [HERE, ROOT]
    import torch
    from harness import catalog
    from harness.check import Judge, StandIn, judge_window, split_index
    from harness.client import run_window
    from harness.spec import build, spec_of
    import nonbondedslicing_tpu_torch as program

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    bench = catalog.benchmark()
    cell = catalog.cell(bench, args.workload)
    config = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    steps = int(traffic["steps_per_sample"])
    n = args.samples or int(traffic["check_energies"]) + 1
    system, positions = build(config, program)
    context = program.Context(
        system, program.VerletIntegrator(float(config["dt_ps"])),
        program.Platform.getPlatformByName(config["platform"]),
        {"Precision": config["precision"]})
    spec = spec_of(config)
    dev = torch.device("cuda")
    judge = Judge(spec, config, dev)
    control = Judge(spec, config, dev, mode="tf32")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in seeds + controls:
        context.setPositions(positions)
        context.setVelocitiesToTemperature(float(config["temperature_k"]),
                                           seed)
        context.getIntegrator().step(steps)
        start = context.createCheckpoint()
        t0 = time.perf_counter()
        # a window of a fixed number of samples: a very short time limit
        # ends it after the first, so it is run a sample at a time
        split = split_index(traffic, seed)
        samples = []
        for k in range(max(n, split[0] + 1 if split else 0)):
            samples += run_window(
                context, steps, 0.0, float(config["temperature_k"]),
                int(traffic["lambda_states"]),
                split=(0, split[1]) if split and split[0] == k else None)[0]
        t1 = time.perf_counter()
        _, numbers = judge_window(judge, samples, start, traffic, seed)
        t2 = time.perf_counter()
        line = dict(cell=cell["name"], seed=seed, kind="program",
                    numbers=numbers, window_s=t1 - t0, reference_s=t2 - t1)
        if seed in controls:
            line = dict(line, kind="control",
                        numbers=judge_window(judge, samples, start, traffic,
                                             seed, StandIn(control))[1],
                        program_numbers=numbers,
                        reference_s=time.perf_counter() - t1)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
