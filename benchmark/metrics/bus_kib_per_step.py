"""bus_kib_per_step: KiB copied between host and card per step over the
profiled slice: the program's ``bus.h2d_bytes`` and ``bus.d2h_bytes``
credited to its spans (step(), getState, checkpoint)."""

from harness import program_spans


def read(run):
    found = program_spans.records(run)
    if found is None:
        return None
    moved = program_spans.credited(found, ("bus.h2d_bytes",
                                           "bus.d2h_bytes"))
    return moved / 1024.0 / run.trace.steps
