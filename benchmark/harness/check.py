"""Whether what the window produced is right, against the plain reference.

Once the window has closed, samples are drawn from the seed:

* ``check_energies`` samples, the last one always among them: the energy
  and every dE/dlambda that the sample's getState returned, against the
  reference's at the positions of that sample's checkpoint (the positions
  the MD loop had produced), on the evaluation's PME grid;
* ``check_intervals`` samples: the positions and velocities of the
  sample's checkpoint, against the reference's MD step run for the
  sample's steps from the checkpoint before it (the state before the
  window for the first);
* where the traffic has ``check_split_steps``, the sample the client split
  (:func:`split_index`): the state of its checkpoint after that many
  steps, against the reference's steps from the checkpoint before it.

Both sides evaluate on the PME grid that the cutoff and the tolerance
give.  The numbers compared, each against its limit in
``limits/<cell>.json``:

* ``energy_rel``: the largest |E - E_ref| / |E_ref|;
* ``dedl_rel``: the largest |dE/dl - ref| / max(|ref|, 1 kJ/mol);
* ``traj_pos_rms_nm``: the largest root mean square over atoms of the
  distance between the positions and the reference's;
* ``traj_pos_max_nm``: the largest distance of one atom from its place in
  the reference's state (a fault local to a few atoms, such as a slice's
  forces on a solute, shows here and not in the mean);
* ``traj_vel_rms_rel``: the largest root mean square of the velocity
  difference over the reference's root mean square velocity.

MD is chaotic, so the reference can only follow the program from the
program's own state, over a stretch shorter than the time in which
float32 and float64 trajectories part.
"""

import numpy as np
import torch

from reference.md import Integrator, NotConverged, bond_terms
from . import catalog
from .client import state_of

NUMBERS = ("energy_rel", "dedl_rel", "traj_pos_rms_nm", "traj_pos_max_nm",
           "traj_vel_rms_rel")
DEDL_FLOOR = 1.0          # kJ/mol
REFERENCE_SKIN = 0.1      # nm, the reference's Verlet-list skin
# nm/ps: no atom of a sound trajectory at 300 K moves this fast; the
# control's MD stops there (its numbers are then far over every limit)
BLOWN_UP_SPEED = 100.0


def _rng(seed, stream):
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  stream])


def split_index(traffic, seed):
    """(index, steps) of the sample that the client runs as ``steps`` steps,
    a checkpoint, then the rest, drawn from the seed among the first
    ``check_split_within``; None where the traffic splits none."""
    steps = int(traffic.get("check_split_steps", 0))
    if not steps:
        return None
    within = int(traffic["check_split_within"])
    return int(_rng(seed, 0x5B17).integers(within)), steps


def draw(n_samples, traffic, seed):
    """(energy sample indices, interval sample indices) drawn from the seed,
    the last sample always among the first."""
    rng = _rng(seed, 0xC4EC)
    k = min(n_samples, int(traffic["check_energies"]))
    rest = rng.permutation(n_samples - 1)[:k - 1]
    energies = sorted({n_samples - 1, *map(int, rest)})
    m = min(n_samples, int(traffic["check_intervals"]))
    intervals = sorted(int(i) for i in rng.permutation(n_samples)[:m])
    return energies, intervals


class Judge:
    """The reference of one system on ``device``, ``model`` or else the
    one that the configuration's method names
    (:func:`harness.catalog.reference`): ``answer(pos)`` gives (energy,
    derivatives) and ``follow(x, v, steps)`` the MD step's state, in the
    arithmetic ``mode`` (``"f64"``, or ``"tf32"`` for the control)."""

    def __init__(self, spec, config, device, mode="f64", model=None):
        model = model or catalog.reference(config)
        self.spec = spec
        self.evaluator = model(spec, device, mode)
        self.md = Integrator(spec, model(spec, device, mode,
                                         skin=REFERENCE_SKIN),
                             float(config["dt_ps"]))

    def answer(self, pos):
        slice_e, _ = self.evaluator.evaluate(pos)
        pos64 = torch.as_tensor(pos, dtype=torch.float64,
                                device=self.evaluator.device)
        bonds = bond_terms(self.spec, pos64)[0]
        return (self.evaluator.energy(slice_e) + bonds,
                self.evaluator.derivatives(slice_e))

    def follow(self, x, v, steps):
        """The state after ``steps`` steps from (x, v); NaN where the
        reference cannot take them (SHAKE does not converge from a state
        no sound step leaves), which fails every limit."""
        stop = BLOWN_UP_SPEED if self.evaluator.mode != "f64" else None
        try:
            xr, vr = self.md.steps(x, v, steps, stop_speed=stop)
        except NotConverged:
            nan = np.full(np.shape(x), np.nan)
            return nan, nan.copy()
        return (xr.to("cpu", torch.float64).numpy(),
                vr.to("cpu", torch.float64).numpy())


def energy_numbers(answers, references):
    """(energy_rel, dedl_rel) over pairs of (energy, derivatives)."""
    e_rel, d_rel = 0.0, 0.0
    for (e, d), (e_ref, d_ref) in zip(answers, references):
        e_rel = max(e_rel, abs(e - e_ref) / abs(e_ref))
        for name, value in d_ref.items():
            d_rel = max(d_rel, abs(d[name] - value)
                        / max(abs(value), DEDL_FLOOR))
    return e_rel, d_rel


def trajectory_numbers(x, v, x_ref, v_ref):
    """The trajectory's numbers of one stretch: the state (x, v) against
    the reference's (x_ref, v_ref)."""
    dist = np.sqrt(np.sum((x - x_ref) ** 2, axis=1))
    return dict(
        traj_pos_rms_nm=float(np.sqrt(np.mean(dist ** 2))),
        traj_pos_max_nm=float(np.max(dist)),
        traj_vel_rms_rel=float(np.sqrt(np.mean(np.sum((v - v_ref) ** 2,
                                                      axis=1))
                                       / np.mean(np.sum(v_ref ** 2,
                                                        axis=1)))))


class Program:
    """The answers the program gave in the window: the energies its
    getState calls returned and the states of its checkpoints."""

    def energy(self, sample):
        return sample.energy, sample.derivatives

    def state(self, x0, v0, steps, checkpoint):
        return state_of(checkpoint)


class StandIn:
    """The answers of a :class:`Judge` put in the program's place (the
    control): its energies at the window's positions, its steps from the
    window's states."""

    def __init__(self, judge):
        self.judge = judge

    def energy(self, sample):
        return self.judge.answer(state_of(sample.checkpoint)[0])

    def state(self, x0, v0, steps, checkpoint):
        return self.judge.follow(x0, v0, steps)


def stretches(samples, start, traffic, seed):
    """(sample index, checkpoint before, steps, checkpoint after) of every
    stretch of the trajectory to compare: the drawn whole samples and the
    first part of the split sample."""
    _, intervals = draw(len(samples), traffic, seed)
    out = []
    for i in intervals:
        before = start if i == 0 else samples[i - 1].checkpoint
        out.append((i, before, samples[i].steps, samples[i].checkpoint))
    split = split_index(traffic, seed)
    if split is not None:
        i, steps = split
        if i >= len(samples) or samples[i].split_checkpoint is None:
            raise RuntimeError(f"sample {i} was not split")
        before = start if i == 0 else samples[i - 1].checkpoint
        out.append((i, before, steps, samples[i].split_checkpoint))
    return out


def judge_window(judge, samples, start, traffic, seed, answers=None):
    """The numbers of the window: ``samples`` (client.Sample), ``start``
    the checkpoint before the window, ``answers`` whose answers are judged
    (default :class:`Program`).  Returns ({sample index: its numbers}, the
    numbers of the window: the largest of each)."""
    answers = answers or Program()
    energies, _ = draw(len(samples), traffic, seed)
    per = {}
    for i in energies:
        pos, _ = state_of(samples[i].checkpoint)
        e_rel, d_rel = energy_numbers([answers.energy(samples[i])],
                                      [judge.answer(pos)])
        per.setdefault(i, {}).update(energy_rel=e_rel, dedl_rel=d_rel)
    for i, before, steps, after in stretches(samples, start, traffic, seed):
        x0, v0 = state_of(before)
        x1, v1 = answers.state(x0, v0, steps, after)
        xr, vr = judge.follow(x0, v0, steps)
        numbers = trajectory_numbers(x1, v1, xr, vr)
        mine = per.setdefault(i, {})
        for name, value in numbers.items():
            mine[name] = worst([value, mine.get(name, 0.0)])
    numbers = {name: worst([n[name] for n in per.values() if name in n])
               for name in NUMBERS}
    return per, numbers


def worst(values):
    """The largest of ``values`` (0 if none); NaN if any is NaN."""
    values = np.asarray(values, dtype=np.float64)
    return float(np.max(values)) if values.size else 0.0


def failed_samples(per, limits):
    """How many of the drawn samples have a compared number (one with a
    limit) over its limit."""
    return sum(any(not (np.isfinite(v) and v <= float(limits[k]))
                   for k, v in n.items() if k in limits)
               for n in per.values())


def verdict(numbers, limits):
    """(correct, {name: {value, limit}}) of the numbers ``limits`` names:
    every one at or under its limit; a number that is not finite fails."""
    table = {name: {"value": numbers[name], "limit": float(limits[name])}
             for name in NUMBERS if name in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in table.values())
    return bool(ok), table
