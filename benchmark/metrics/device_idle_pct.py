"""device_idle_pct: the share of the profiled slice in which no operation
runs on the card, in percent.  The profiler's own host work widens the
gaps, so it reads above an unprofiled run's idle share."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_us <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
