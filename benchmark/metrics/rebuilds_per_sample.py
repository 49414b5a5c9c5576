"""rebuilds_per_sample: CUDA graph captures, MD retries (a skin violation
or a cell overflow) and getState capacity growths in the profiled slice,
per sample: the program's ``graph.captures``, ``md.retries`` and
``eval.capacity_grows`` credited to its spans.  A steady run reads 0."""

from harness import program_spans


def read(run):
    found = program_spans.records(run)
    if found is None:
        return None
    rebuilds = program_spans.credited(
        found, ("graph.captures", "md.retries", "eval.capacity_grows"))
    return rebuilds / len(program_spans.top_level(found, "nbs.getState"))
