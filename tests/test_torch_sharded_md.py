"""The port's slab-decomposed MD step
(``nonbondedslicing_tpu_torch/parallel/fused_shard.make_sharded_md_step``)
on the CPU over gloo, against the JAX package's ``make_sharded_md_step`` at
the same number of ranks (devices of the CPU mesh of ``tests/conftest.py``).

Ranks are spawned processes (``torch_parallel_cases.run_ranks``), one spawn
per world size running every case in every rank; every rank must return
the same positions, velocities and energy to the bit.  The system is
``tests/test_parallel.py::_water_system``: 40 rigid waters in a 3.2 nm box,
a (3, 3, 3) cell grid of 32 slots at the JAX default target skin, K = 2,
so the pair stage is ``pair_column``'s plain twin over each rank's x-slab
(float64).  The slabs are ceil(3 / D) planes a rank:

* world 2 gives a ragged last slab (3 % 2 = 1: 18 cells, then 9);
* world 3 one plane a rank;
* world 4 leaves rank 3 with no cell ((4 - 1) * ceil(3 / 4) = 3 >= 3): it
  launches no pair kernel and adds zeros, as the JAX package's device 3
  masks its duplicate cells;

and in each spawn every rank also runs the step in a 1-rank gloo group of
its own.  Tolerances are the JAX tests' (``test_parallel.py:148``,
``:205``): PME positions 1e-9 nm, velocities 1e-8 nm/ps, energy 1e-9
relative; LJPME with parameter offsets 5e-9, 5e-6, 1e-9.

The port's pair kernels (and their plain twins) take erfc from the A&S
7.1.26 polynomial, |error| <= 1.5e-7, as the JAX package's own Pallas pair
kernels do (``pallas_direct.py:49-57``); the JAX slab step's XLA sweep
takes the exact erfc (``ops/direct.py:30,124``).  So the parity runs of the
JAX step take its sweep's erfc from its Pallas kernels' polynomial
(patched into ``ops/direct.py``'s namespace for the run, no file changed),
and the port must match them to the JAX tolerances; against the unpatched
JAX step the velocities and the energy are held to the bound of that
polynomial's error (:func:`erfc_bounds`), the positions still to the JAX
tolerances.
"""

import functools
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import direct as jdirect
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import pallas_direct
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.parallel.fused_shard import \
    make_sharded_md_step as jax_sharded_md_step
from nonbondedslicing_tpu.runtime.constraints import cluster_constraints

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import params
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.parallel import fused_shard
from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0

import tests.test_parallel as jax_parallel_tests
import torch_parallel_cases as cases

JAX_KEYS = ("reuse_steps", "skin", "counts", "capacity", "slabs_per_device",
            "devices")
# the runs: the rank job's arguments (torch_parallel_cases.slab_md) and the
# JAX tolerances (positions nm, velocities nm/ps, energy relative); "cell"
# takes its exceptions as periodic, so the pair stage is pair_cell's twin
# with the exclusion corrections fused in (JAX: the generic corrections)
RUNS = {
    "pme": dict(method="PME", gvals=[0.8], vel_seed=4, n_steps=5,
                tol=(1e-9, 1e-8, 1e-9)),
    "ljpme": dict(method="LJPME", offsets=True, gvals=[0.8, 0.6, 0.25],
                  vel_seed=8, n_steps=4, zeroed=[0.8, 0.0, 0.0],
                  tol=(5e-9, 5e-6, 1e-9)),
    "cell": dict(method="PME", periodic=True, gvals=[0.8], vel_seed=4,
                 n_steps=5),
}
WORLDS = (2, 3, 4)
ERFC_ERROR = 1.5e-7       # A&S 7.1.26: |erfc approximation - erfc|


def _job(name):
    return (name, "torch_parallel_cases:slab_md",
            {k: v for k, v in RUNS[name].items() if k != "tol"})


def _jobs(world):
    jobs = [_job("pme"),
            ("one_rank", "torch_parallel_cases:slab_one_rank", {})]
    if world < 4:
        jobs += [_job("ljpme"), _job("cell"),
                 ("guards", "torch_parallel_cases:slab_guards", {})]
    return jobs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> every rank's results of its jobs (one spawn a
    size)."""
    torch.set_num_threads(2)
    return {world: cases.run_ranks(
        world, str(tmp_path_factory.mktemp(f"world{world}")), _jobs(world))
        for world in WORLDS}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def same_on_every_rank(results, name, skip=()):
    """Rank 0's results of ``name``, after checking that every rank
    returned the same (but the keys ``skip``), to the bit."""
    def kept(x):
        return {k: v for k, v in x.items() if k not in skip}

    for r, out in enumerate(results[1:], 1):
        assert _equal(kept(results[0][name]), kept(out[name])), (
            f"{name}: rank {r} differs from rank 0")
    return results[0][name]


@functools.lru_cache(maxsize=None)
def jax_run(name, world, kernel_erfc=True):
    """JAX make_sharded_md_step on ``world`` CPU devices, its sweep's erfc
    the Pallas kernels' polynomial with ``kernel_erfc``: (positions,
    velocities, energy, run.config, energy with the offsets zeroed)."""
    run_ = RUNS[name]
    system, force, positions = jax_parallel_tests._water_system(
        method=getattr(nbs.SlicedNonbondedForce, run_["method"]),
        offsets=run_.get("offsets", False))
    force.setExceptionsUsePeriodicBoundaryConditions(
        run_.get("periodic", False))
    plan = jplan.build_plan(force, system)
    n = plan.num_particles
    masses = np.array([system.getParticleMass(i) for i in range(n)])
    cons = cluster_constraints(
        [system.getConstraintParameters(i)
         for i in range(system.getNumConstraints())], n)
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))
    data = jengine.plan_data(plan)
    box = jnp.asarray(np.array(system.getDefaultPeriodicBoxVectors()))
    pos0 = jnp.asarray(positions)
    vel0 = jnp.asarray(np.random.default_rng(run_["vel_seed"]).normal(
        scale=0.3, size=(n, 3)))
    erfc = pallas_direct._erfc_hastings if kernel_erfc else jdirect.erfc
    # the sweep's pair terms are traced at the first call of each run
    with mock.patch.object(jdirect, "erfc", erfc):
        run = jax_sharded_md_step(plan, masses, 0.001, mesh, axis="x",
                                  dtype=jnp.float64, constraints=cons,
                                  reuse_steps=2, cell_capacity=32)
        steps = run_["n_steps"]
        p, v, e = run(pos0, vel0, box, jnp.asarray(run_["gvals"]), data,
                      steps)
        e0 = None
        if "zeroed" in run_:
            e0 = float(run(pos0, vel0, box, jnp.asarray(run_["zeroed"]),
                           data, steps)[2])
    return np.asarray(p), np.asarray(v), float(e), dict(run.config), e0


def erfc_bounds(name, positions, dt=0.001):
    """How far the polynomial erfc (|error| <= ERFC_ERROR) can move the
    run ``name`` from one with the exact erfc, at ``positions``: (energy,
    velocities, positions).  A pair within the cutoff, not excluded,
    changes its Coulomb energy by at most ONE_4PI_EPS0 |q_i q_j|
    ERFC_ERROR / r and its force by ONE_4PI_EPS0 |q_i q_j| ERFC_ERROR / r^2
    (the Gaussian term of the force is exact; every lambda here is at most
    1); so does an excluded pair's correction where the kernel computes it
    (erf = 1 - erfc, on the cell kernel's path).  The constraint
    projections do not lengthen a mass-weighted change, so after n kicks
    an atom's velocity moves by at most n dt |M^-1/2 dF| / sqrt(min mass)
    and its position by n (n + 1) / 2 dt^2 of the same."""
    run_ = RUNS[name]
    plan, masses, _, _, box, data = cases.water_md_inputs(
        run_["method"], run_.get("offsets", False),
        periodic=run_.get("periodic", False))
    gvals = torch.as_tensor(run_["gvals"], dtype=torch.float64)
    q = params.particle_params(data, gvals)[0].numpy()
    d = positions[:, None, :] - positions[None, :, :]
    edge = float(box[0, 0])
    d -= edge * np.round(d / edge)
    r = np.linalg.norm(d, axis=-1)
    near = (r < plan.cutoff) & ~np.eye(len(q), dtype=bool)
    if not run_.get("periodic", False):
        for i, j in plan.exclusion_pairs:
            near[i, j] = near[j, i] = False
    qq = ONE_4PI_EPS0 * np.abs(q[:, None] * q[None, :]) * ERFC_ERROR
    r = np.where(near, r, 1.0)
    energy = 0.5 * float(np.sum(np.where(near, qq / r, 0.0)))
    force = np.sum(np.where(near, qq / r ** 2, 0.0), axis=1)
    n = run_["n_steps"]
    kick = dt * np.sqrt(np.sum(force ** 2 / masses)) / np.sqrt(masses.min())
    return energy, n * kick, n * (n + 1) / 2 * dt * kick


def _against_jax(found, name, world):
    """The port's run ``found`` against JAX's at the same D, its sweep's
    erfc the kernels' polynomial: the JAX tolerances, and the JAX keys of
    run.config equal.  Returns JAX's energy with the offsets zeroed."""
    p_j, v_j, e_j, config_j, e0_j = jax_run(name, world)
    tol_p, tol_v, tol_e = RUNS[name]["tol"]
    np.testing.assert_allclose(found["pos"], p_j, rtol=0, atol=tol_p)
    np.testing.assert_allclose(found["vel"], v_j, rtol=0, atol=tol_v)
    np.testing.assert_allclose(found["energy"], e_j, rtol=tol_e)
    assert {k: found["config"][k] for k in JAX_KEYS} == {
        k: (tuple(config_j[k]) if k == "counts" else config_j[k])
        for k in JAX_KEYS}
    assert found["config"]["graph"] is False     # gloo: eager windows
    return e0_j


def test_port_water_system_is_the_jax_system():
    for offsets in (False, True):
        _, _, positions = jax_parallel_tests._water_system(offsets=offsets)
        plan, *_, pos, _, _ = cases.water_md_inputs("PME", offsets)
        np.testing.assert_array_equal(pos.numpy(), positions)
        assert plan.num_particles == 120


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_md_step_pme_matches_jax(spawned, world):
    """PME, 5 steps: the port's slab step against JAX's at the same D, the
    pair kernel called once a step and once for the energies on every
    rank with cells, never on a rank without."""
    found = same_on_every_rank(spawned[world], "pme",
                               skip=("calls", "slab"))
    _against_jax(found, "pme", world)
    assert found["config"]["pair"] == "pair_column"
    per = -(-3 // world) * 9            # cells of ceil(3 / D) planes
    for rank, out in enumerate(r["pme"] for r in spawned[world]):
        begin, end = out["slab"]
        assert (begin, end) == (min(rank * per, 27),
                                min(rank * per + per, 27))
        # once a step (5) and once for the energies, over the slab
        expected = [(begin, end - begin)] * 6 if end > begin else []
        assert out["calls"] == expected, (world, rank)
    assert spawned[world][-1]["pme"]["slab"][1] == 27
    if world == 4:
        assert spawned[world][3]["pme"]["calls"] == []


@pytest.mark.parametrize("world", WORLDS[:2])
def test_sharded_md_step_ljpme_offsets_matches_jax(spawned, world):
    """LJPME with particle and exception parameter offsets, 4 steps; the
    offsets must matter: zeroing their globals moves the energy by more
    than 1e-6 kJ/mol, in both packages alike."""
    found = same_on_every_rank(spawned[world], "ljpme",
                               skip=("calls", "slab"))
    e0_j = _against_jax(found, "ljpme", world)
    assert abs(found["energy_zeroed"] - found["energy"]) > 1e-6
    np.testing.assert_allclose(found["energy_zeroed"], e0_j, rtol=1e-9)


@pytest.mark.parametrize("name", ["pme", "ljpme"])
def test_sharded_md_step_within_the_erfc_bound_of_jax(spawned, name):
    """Against the JAX step as it is (the exact erfc in its sweep): the
    positions to the JAX tolerances, the velocities and the energy within
    what the polynomial's error can move them (:func:`erfc_bounds`)."""
    found = spawned[2][0][name]
    p_j, v_j, e_j, _, _ = jax_run(name, 2, kernel_erfc=False)
    e_bound, v_bound, _ = erfc_bounds(name, found["pos"])
    np.testing.assert_allclose(found["pos"], p_j, rtol=0,
                               atol=RUNS[name]["tol"][0])
    assert np.abs(found["vel"] - v_j).max() <= v_bound
    assert abs(found["energy"] - e_j) <= e_bound


@pytest.mark.parametrize("world", WORLDS[:2])
def test_sharded_md_step_cell_path_matches_jax(spawned, world):
    """Periodic exceptions: each rank runs pair_cell's twin over its slab
    with the exclusion corrections fused in, where the JAX step adds the
    generic corrections on every device (divided by D).  Both the pair
    terms and the corrections take the polynomial's erfc in the port, so
    positions, velocities and energy are held to :func:`erfc_bounds` of
    the pairs and the excluded pairs against the JAX step as it is."""
    found = same_on_every_rank(spawned[world], "cell",
                               skip=("calls", "slab"))
    assert found["config"]["pair"] == "pair_cell"
    for out in (r["cell"] for r in spawned[world]):
        begin, end = out["slab"]
        assert out["calls"] == [(begin, end - begin)] * 6
    p_j, v_j, e_j, config_j, _ = jax_run("cell", world, kernel_erfc=False)
    e_bound, v_bound, p_bound = erfc_bounds("cell", found["pos"])
    assert np.abs(found["pos"] - p_j).max() <= p_bound
    assert np.abs(found["vel"] - v_j).max() <= v_bound
    assert abs(found["energy"] - e_j) <= e_bound
    assert {k: found["config"][k] for k in JAX_KEYS} == {
        k: (tuple(config_j[k]) if k == "counts" else config_j[k])
        for k in JAX_KEYS}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_md_step_one_rank_group(spawned, world):
    """Every rank in a 1-rank group of its own: the whole grid on one rank,
    equal to JAX's step on one device; a box below 3 cells a axis
    refused."""
    for out, refusal in (r["one_rank"] for r in spawned[world]):
        assert out["config"]["devices"] == 1
        assert out["slab"] == (0, 27) and out["calls"] == [(0, 27)] * 6
        _against_jax(out, "pme", 1)
        assert refusal == ("make_sharded_md_step: box too small for a cell "
                           "grid")


@pytest.mark.parametrize("world", WORLDS[:2])
def test_sharded_md_step_guards(spawned, world):
    """A cell capacity of 4 raises after the run with "overflow"; an atom
    carried past skin/2 within one window raises with "skin"."""
    found = same_on_every_rank(spawned[world], "guards")
    assert "capacity overflow" in found["overflow"]
    assert "skin violation" in found["skin"]


@pytest.mark.parametrize("method", ["NoCutoff", "CutoffNonPeriodic"])
def test_sharded_md_step_refuses_without_a_periodic_cutoff(method):
    """Refused before any process group is touched (none exists here)."""
    system, force, _ = cases.system(nbt, method)
    with pytest.raises(nbt.OpenMMException, match="periodic cutoff"):
        fused_shard.make_sharded_md_step(tplan.build_plan(force, system),
                                         np.ones(64), 0.001)


def test_slab_step_imports_without_jax():
    """The slab step (and the package's lazy export of it) loads no JAX
    and nothing of the JAX package."""
    probe = """
import sys
from nonbondedslicing_tpu_torch.parallel import make_sharded_md_step
from nonbondedslicing_tpu_torch.parallel import fused_shard
assert make_sharded_md_step is fused_shard.make_sharded_md_step
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("nonbondedslicing_tpu.")))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
