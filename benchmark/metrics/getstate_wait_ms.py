"""getstate_wait_ms: host ms per getState in the program's
``nbs.eval.copy_in``, ``nbs.eval.guard``, ``nbs.eval.reduce`` and
``nbs.eval.copy_out`` spans over the profiled slice: the copies in, the
guard read, the energy and dE/dlambda reads, the forces copied back."""

from harness import program_spans


def read(run):
    return program_spans.per_getstate(
        run, ("nbs.eval.copy_in", "nbs.eval.guard", "nbs.eval.reduce",
              "nbs.eval.copy_out"))
