"""getstate_engine_ms: host ms per getState in the program's
``nbs.eval.engine`` spans over the profiled slice: the generic engine's
evaluation (make_compute), its launches and host work."""

from harness import program_spans


def read(run):
    return program_spans.per_getstate(run, ("nbs.eval.engine",))
