"""The closed-loop client of a run: one alchemical free-energy driver.

Each sample is ``integrator.step(n)``, then ``getState(getEnergy=True,
getParameterDerivatives=True)``; from the energy and the per-parameter
dE/dlambda the client works out on the host the reduced energy of the
current configuration at ``lambda_states`` values of each scaling
parameter (E is linear in each lambda), the row a multistate analysis
(MBAR) reads, and keeps a checkpoint of the state (``createCheckpoint``),
as a driver that can restart keeps one.  The next sample starts when this
one has ended.  One sample, where the check asks for it, runs its steps in
two calls with a checkpoint between them (``split``): the state that the
reference follows over a stretch shorter than a whole sample.
"""

import contextlib
import io
import time
from dataclasses import dataclass

import numpy as np

KB = 8.31446261815324e-3      # kJ/mol/K


@dataclass
class Sample:
    steps: int
    step_s: float                 # integrator.step
    getstate_s: float             # getState
    total_s: float                # the whole sample
    energy: float
    derivatives: dict
    reduced: np.ndarray           # (parameters, lambda_states)
    checkpoint: bytes
    profiled: bool = False        # ran under the profiler
    split_checkpoint: bytes = None  # the state after its first part


def reduced_row(energy, derivatives, values, temperature, n_states):
    """u(lambda_p = x) / kT for x in linspace(0, 1, n_states), each scaling
    parameter p at a time (the others at their values)."""
    kT = KB * temperature
    x = np.linspace(0.0, 1.0, n_states)
    return np.array([(energy + (x - values[p]) * derivatives[p]) / kT
                     for p in sorted(derivatives)])


def state_of(checkpoint):
    """(positions, velocities) float64 of a ``createCheckpoint`` blob (an
    ``.npz`` archive of named arrays)."""
    with np.load(io.BytesIO(checkpoint), allow_pickle=False) as blob:
        return (np.array(blob["positions"], dtype=np.float64),
                np.array(blob["velocities"], dtype=np.float64))


def run_sample(context, steps, split=None):
    """``integrator.step(steps)``, or with ``split`` steps first
    ``integrator.step(split)``, a checkpoint, and the rest; returns that
    checkpoint or None."""
    integrator = context.getIntegrator()
    if not split:
        integrator.step(steps)
        return None
    integrator.step(split)
    blob = context.createCheckpoint()
    integrator.step(steps - split)
    return blob


def run_window(context, steps, seconds, temperature, n_states,
               tracer=None, clock=time.perf_counter, split=None):
    """Samples of ``steps`` steps until ``seconds`` have passed and the
    sample that ``split`` = (index, steps) names has run split; returns
    (samples, wall seconds from the first sample's start to the last's
    end).  ``tracer(index)`` gives the context manager a sample runs in
    (the profiler's slice), and ``tracer.span(name)`` the spans inside it."""
    values = dict(context.getParameters())
    samples = []
    start = clock()
    while True:
        index = len(samples)
        scope = tracer.sample(index) if tracer else contextlib.nullcontext()
        span = tracer.span if tracer else (lambda name:
                                           contextlib.nullcontext())
        with scope:
            t0 = clock()
            with span("bench.step"):
                mid = run_sample(context, steps, split[1] if split
                                 and split[0] == index else None)
            t1 = clock()
            with span("bench.getState"):
                state = context.getState(getEnergy=True,
                                         getParameterDerivatives=True)
            t2 = clock()
            energy = state.getPotentialEnergy()
            derivs = state.getEnergyParameterDerivatives()
            row = reduced_row(energy, derivs, values, temperature, n_states)
            blob = context.createCheckpoint()
            t3 = clock()
        samples.append(Sample(steps, t1 - t0, t2 - t1, t3 - t0, energy,
                              dict(derivs), row, blob,
                              bool(tracer and tracer.active(index)), mid))
        if t3 - start >= seconds and (not split or index >= split[0]):
            return samples, t3 - start
