"""The program's own spans and counters over the profiled slice of a
traced run, as the program's ``runtime/profiling.py`` keeps them
(``spans()``: records with a ``name``, a ``parent``, ``start_ns`` and
``end_ns`` on ``time.perf_counter_ns``, and the ``counts`` credited to
them).  A profiler session starts the program's list anew, so after the
window it holds the slice's records, the same samples the device-trace
metrics read.

Found through ``sys.modules``: nothing here imports the program.  Where
the program keeps no such records (one without them, or a stand-in), or
they are not the slice's (one ``nbs.getState`` per profiled sample), the
functions return None.
"""

import sys

MODULE = "nonbondedslicing_tpu_torch.runtime.profiling"


def records(run):
    """The slice's records, or None."""
    if run.trace is None or not run.trace.steps:
        return None
    read = getattr(sys.modules.get(MODULE), "spans", None)
    if read is None:
        return None
    found = read()
    profiled = sum(1 for s in run.samples if s.profiled)
    if not profiled or len(top_level(found, "nbs.getState")) != profiled:
        return None
    return found


def top_level(found, name):
    return [r for r in found if r.name == name and r.parent is None]


def host_ms(found, names):
    """Host milliseconds in the records named in ``names``."""
    return 1e-6 * sum(r.end_ns - r.start_ns for r in found
                      if r.name in names)


def credited(found, keys):
    """The counts of ``keys`` credited to the records."""
    return sum(r.counts.get(key, 0) for r in found for key in keys)


def per_step(run, names):
    """Host ms per step of the slice in the spans ``names``, or None where
    the slice has no ``nbs.step``."""
    found = records(run)
    if found is None or not top_level(found, "nbs.step"):
        return None
    return host_ms(found, names) / run.trace.steps


def per_getstate(run, names):
    """Host ms per getState of the slice in the spans ``names``."""
    found = records(run)
    if found is None:
        return None
    return host_ms(found, names) / len(top_level(found, "nbs.getState"))
