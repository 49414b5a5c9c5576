"""md_step_ms: the host spans of integrator.step over the window, the
profiled slice left out, summed, over the steps they ran (the MD loop
through the Context)."""


def read(run):
    kept = [s for s in run.samples if not s.profiled]
    steps = sum(s.steps for s in kept)
    if not steps:
        return None
    return 1e3 * sum(s.step_s for s in kept) / steps
