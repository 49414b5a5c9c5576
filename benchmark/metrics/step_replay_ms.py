"""step_replay_ms: host ms per step in the program's ``nbs.step.replay``
spans over the profiled slice: each step() call's copies into the CUDA
graphs' buffers and the replays of its windows (a first capture, if one
ran, under ``nbs.step.capture``)."""

from harness import program_spans


def read(run):
    return program_spans.per_step(run, ("nbs.step.replay",))
