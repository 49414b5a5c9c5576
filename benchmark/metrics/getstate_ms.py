"""getstate_ms: the mean host span of getState(getEnergy,
getParameterDerivatives) over the window, the profiled slice left out (the
user API and the generic engine)."""


def read(run):
    spans = [s.getstate_s for s in run.samples if not s.profiled]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
