"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at the tiny
box, once for each fault a cell can have.  The cells run on one card, so
there is no exchange between cards to leave out."""

import types

import numpy as np
import pytest

import nonbondedslicing_tpu_torch as nbt
from harness import catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


class Unchanged(nbt.Context):
    """A step that returns its state unchanged."""

    def _integrate(self, steps, dt):
        pass


class HalfLeftOut(nbt.Context):
    """Half of the atoms left out of the step: they keep their state."""

    def _integrate(self, steps, dt):
        x, v = self._positions.copy(), self._velocities.copy()
        super()._integrate(steps, dt)
        half = len(x) // 2
        self._positions[half:] = x[half:]
        self._velocities[half:] = v[half:]


class FewAtomsMoved(nbt.Context):
    """A fault local to a few atoms: the first 12 (the solute's chain, or
    four waters) moved 0.25 nm after each step, too few to move a root
    mean square over the system."""

    def _integrate(self, steps, dt):
        super()._integrate(steps, dt)
        self._positions[:12, 0] += 0.25


class AlteredAnswer(nbt.Context):
    """getState's energy altered where it is produced."""

    def getState(self, *args, **kw):
        state = super().getState(*args, **kw)
        if state._energy is not None:
            state._energy *= 1.0 + 1e-4
        return state


def program_with(context_class):
    names = ("Platform", "VerletIntegrator", "System", "SlicedNonbondedForce",
             "HarmonicBondForce")
    return types.SimpleNamespace(
        Context=context_class, __file__=nbt.__file__,
        **{name: getattr(nbt, name) for name in names})


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, FewAtomsMoved,
                                   AlteredAnswer],
                         ids=lambda c: c.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(tiny_run, cell, fault):
    code, result = tiny_run(cell, seconds=0.5, program=program_with(fault))
    assert code == 0
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert any(c["value"] > c["limit"] or not np.isfinite(c["value"])
               for c in result["checks"].values())
    if fault is FewAtomsMoved:
        moved = result["checks"]["traj_pos_max_nm"]
        assert not moved["value"] <= moved["limit"]
