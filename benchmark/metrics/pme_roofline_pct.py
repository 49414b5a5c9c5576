"""pme_roofline_pct: the least time of the PME spread and interpolation
(work/pme_roofline_pct) over the device time of those kernels
(csrc/pme_spread*.cu, csrc/pme_interp*.cu) inside the integrator.step
spans of the profiled slice, in percent.  The grid is the one that the
cutoff and the error tolerance give, whatever grid the program pads it to."""

from work.pme_roofline_pct import least_seconds


def read(run):
    trace = run.trace
    work = run.work
    if trace is None or "grid_points" not in work:
        return None
    ops = [op for op in trace.ops if op.span == "bench.step"
           and op.stem and op.stem.startswith(("pme_spread", "pme_interp"))]
    if not ops:
        return None
    spreads = sum(op.stem.startswith("pme_spread") for op in ops)
    device_s = sum(op.end_us - op.start_us for op in ops) * 1e-6
    least = least_seconds(work["atoms"], work["subsets"],
                          work["grid_points"], spreads,
                          len(ops) - spreads)
    return 100.0 * least / device_s
