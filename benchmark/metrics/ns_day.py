"""ns_day: every step completed in the window times the time step, over
the window's whole wall time, scaled to a day (host clock)."""


def read(run):
    steps = sum(s.steps for s in run.samples)
    return steps * run.dt_ps * 1e-3 * 86400.0 / run.window_s
