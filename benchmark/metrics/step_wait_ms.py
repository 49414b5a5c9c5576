"""step_wait_ms: host ms per step in the program's ``nbs.step.copy_in``,
``nbs.step.guard`` and ``nbs.step.copy_out`` spans over the profiled
slice: the state copied to the card, the guard read (where the host waits
for every queued window) and the float64 copy back."""

from harness import program_spans


def read(run):
    return program_spans.per_step(
        run, ("nbs.step.copy_in", "nbs.step.guard", "nbs.step.copy_out"))
