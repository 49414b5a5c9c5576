"""step_energy_ms: host ms per step in the program's ``nbs.step.energy``
spans over the profiled slice: the eager evaluation with energies that
ends each step() call, and its energy contraction."""

from harness import program_spans


def read(run):
    return program_spans.per_step(run, ("nbs.step.energy",))
