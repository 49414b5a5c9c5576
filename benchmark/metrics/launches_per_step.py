"""launches_per_step: the host's kernel and graph launch calls inside the
integrator.step spans of the profiled slice, per step."""


def read(run):
    trace = run.trace
    if trace is None or not trace.steps or not trace.ops:
        return None
    return trace.launches.get("bench.step", 0) / trace.steps
