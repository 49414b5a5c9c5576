"""pair_roofline_pct: the pair stage's least time (work/pair_roofline_pct)
over the device time of the pair kernels (csrc/pair_column.cu,
csrc/pair_cell.cu) inside the integrator.step spans of the profiled
slice, in percent."""

from work.pair_roofline_pct import least_seconds

STEMS = ("pair_column", "pair_cell")


def read(run):
    trace = run.trace
    pairs = run.work.get("pairs_within_cutoff")
    if trace is None or not pairs:
        return None
    ops = [op for op in trace.ops
           if op.span == "bench.step" and op.stem in STEMS]
    if not ops:
        return None
    device_s = sum(op.end_us - op.start_us for op in ops) * 1e-6
    return 100.0 * least_seconds(pairs, len(ops)) / device_s
