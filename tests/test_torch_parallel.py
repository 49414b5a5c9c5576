"""The port's sharded evaluation (``nonbondedslicing_tpu_torch/parallel``)
on the CPU over gloo, against the JAX package.

Ranks are spawned processes joined through a ``file://`` rendezvous
(``torch_parallel_cases.run_ranks``); one spawn per world size (2 and 3)
runs every case, each rank computing with the same inputs, and every rank
must return the same result.  The twins of ``tests/test_parallel.py``:

* ``make_sharded_compute`` of its 64-atom system in float64 (the cell list
  split over cells under CutoffPeriodic, PME, LJPME and Ewald, the
  all-pairs rows under NoCutoff, and under PME in a 2.4 nm box of 2 cells
  a axis, where the exclusion corrections and the dispersion correction
  are added once beside the rows) against the JAX package's single-device
  ``make_compute`` to 1e-10, and PME also against its
  ``make_sharded_compute`` on a 2-device mesh;
* ``make_sharded_pme`` (Coulomb and LJPME's dispersion) and
  ``make_sharded_ewald`` at N = 64, which 3 does not divide, against the
  unsharded ``ops/pme.pme_reciprocal`` and ``ops/ewald.ewald_reciprocal``;
* the kernel route (``neighbor="pallas"``, whose float32 CPU route is
  ``pair_cell``'s plain twin over each rank's range of cells) against the
  unsharded float32 call: direct forces equal to the bit;
* ``make_multichip_md_step`` against the JAX package's over 2 steps in
  float64 to 1e-9;

and without spawning, ``pair_cell_plain`` over concatenated cell ranges
against the whole-grid call, to the bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.parallel import mesh as jmesh

from nonbondedslicing_tpu_torch.ops import cuda_direct, ewald, pme
from nonbondedslicing_tpu_torch.ops import engine as tengine

import tests.test_parallel as jax_parallel_tests
import torch_pair_cases
import torch_parallel_cases as cases

METHODS = ("CutoffPeriodic", "PME", "LJPME", "Ewald", "NoCutoff")
SMALL_BOX = 2.4          # nm: 2 cells of the 0.9 nm cutoff a axis
KINDS = ("pme", "dispersion", "ewald")
WORLDS = (2, 3)
MD_STEPS = 2
JOBS = (
    [(m, "torch_parallel_cases:sharded_compute", dict(method=m))
     for m in METHODS]
    + [("PME small box", "torch_parallel_cases:sharded_compute",
        dict(method="PME", box=SMALL_BOX))]
    + [(k, "torch_parallel_cases:sharded_reciprocal", dict(kind=k))
       for k in KINDS]
    + [("kernel_direct", "torch_parallel_cases:sharded_engine",
        dict(method="PME", neighbor="pallas", include=(True, False))),
       ("kernel_all", "torch_parallel_cases:sharded_engine",
        dict(method="PME", neighbor="pallas")),
       ("md", "torch_parallel_cases:md_steps", dict(n_steps=MD_STEPS))])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world size -> every rank's results of JOBS (one spawn a size)."""
    torch.set_num_threads(2)
    return {world: cases.run_ranks(
        world, str(tmp_path_factory.mktemp(f"world{world}")), JOBS)
        for world in WORLDS}


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def same_on_every_rank(results, name):
    """The results of ``name``, after checking that every rank returned
    the same, to the bit."""
    for r, out in enumerate(results[1:], 1):
        assert _equal(results[0][name], out[name]), (
            f"{name}: rank {r} differs from rank 0")
    return results[0][name]


def jax_inputs(method, box=3.0):
    system, force, positions = jax_parallel_tests._system(
        getattr(nbs.NonbondedForce, method), box=box)
    plan = jplan.build_plan(force, system)
    box = jnp.asarray(np.array(system.getDefaultPeriodicBoxVectors()))
    return plan, jnp.asarray(positions), box, jnp.asarray([0.7])


@functools.lru_cache(maxsize=None)
def jax_single(method, box=3.0):
    plan, pos, box, gvals = jax_inputs(method, box)
    e, f = jax.jit(jengine.make_compute(plan, True, True))(
        pos, box, gvals, jengine.plan_data(plan))
    return np.asarray(e), np.asarray(f)


def test_port_system_is_the_jax_system():
    for method in ("PME", "NoCutoff"):
        _, _, positions = jax_parallel_tests._system(
            getattr(nbs.NonbondedForce, method))
        plan, pos, *_ = cases.port_inputs(method, "cpu", torch.float64)
        np.testing.assert_array_equal(pos.numpy(), positions)
        assert plan.method == getattr(nbs.NonbondedForce, method)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_single_device(spawned, world, method):
    route, e, f = same_on_every_rank(spawned[world], method)
    assert route == ("all_pairs" if method == "NoCutoff" else "cell")
    e_j, f_j = jax_single(method)
    np.testing.assert_allclose(e, e_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(f, f_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_all_pairs_rows_with_side_terms(spawned, world):
    """PME below 3 cells a axis: the all-pairs rows split over the ranks,
    the reciprocal part over the atoms, and the exclusion corrections and
    the dispersion correction added once."""
    route, e, f = same_on_every_rank(spawned[world], "PME small box")
    assert route == "all_pairs"
    e_j, f_j = jax_single("PME", SMALL_BOX)
    np.testing.assert_allclose(e, e_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(f, f_j, rtol=1e-10, atol=1e-10)


def test_sharded_pme_matches_jax_sharded(spawned):
    _, e, f = same_on_every_rank(spawned[2], "PME")
    plan, pos, box, gvals = jax_inputs("PME")
    mesh = Mesh(np.array(jax.devices()[:2]), ("atoms",))
    e_j, f_j = jax.jit(jmesh.make_sharded_compute(plan, mesh))(
        pos, box, gvals, jengine.plan_data(plan))
    np.testing.assert_allclose(e, np.asarray(e_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(f, np.asarray(f_j), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_reciprocal_matches_unsharded(spawned, world, kind):
    e, f = same_on_every_rank(spawned[world], kind)
    method = {"pme": "PME", "dispersion": "LJPME", "ewald": "Ewald"}[kind]
    plan, pos, box, gvals, data = cases.port_inputs(method, "cpu",
                                                    torch.float64)
    assert plan.num_particles % 3 != 0
    args = cases.reciprocal_args(plan, data, gvals, kind)
    pairs = torch.as_tensor(args["pairs"])
    table = torch.as_tensor(plan.slice_table, dtype=torch.int64)
    if kind == "ewald":
        e_1, f_1 = ewald.ewald_reciprocal(
            pos, box, args["values"], data["subsets"], args["lam"],
            kvec_ints=torch.as_tensor(args["kvec"]), alpha=plan.ewald_alpha,
            num_subsets=plan.num_subsets, slice_table=table,
            slice_subset_pairs=pairs)
    else:
        e_1, f_1 = pme.pme_reciprocal(
            pos, box, args["values"], data["subsets"], args["lam"],
            alpha=args["alpha"], grid_shape=args["grid"],
            moduli=tuple(torch.as_tensor(m) for m in args["moduli"]),
            num_subsets=plan.num_subsets, slice_subset_pairs=pairs,
            slice_table=table, dispersion=kind == "dispersion")
    assert np.abs(f).max() > 0.1
    np.testing.assert_allclose(e, e_1.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(f, f_1.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_route_sharded_matches_unsharded(spawned, world):
    """Float32 on the kernel route: each rank runs pair_cell's plain twin
    over its range of cells.  The direct forces equal the unsharded call's
    to the bit (a permutation written into zeros, summed with zeros); the
    energies (float64 sums in another order) and, with the reciprocal
    part (the grids summed over the ranks in float32), the forces, to
    rounding: phase 14's gates of chip_smoke.py."""
    plan, pos, box, gvals, data = cases.port_inputs("PME", "cpu",
                                                    torch.float32)
    for name, include in (("kernel_direct", (True, False)),
                          ("kernel_all", (True, True))):
        route, e, f, overflow = same_on_every_rank(spawned[world], name)
        assert route == "pallas" and overflow == 0
        e_1, f_1 = tengine.make_compute(plan, *include, neighbor="pallas")(
            pos, box, gvals, data)
        if name == "kernel_direct":
            np.testing.assert_array_equal(f, f_1.numpy())
        else:
            assert np.abs(f - f_1.numpy()).max() <= 1e-5 * np.abs(f).max()
        np.testing.assert_allclose(e, e_1.numpy(), rtol=1e-6,
                                   atol=1e-6 * np.abs(e).max())


def test_multichip_md_step_matches_jax(spawned):
    """The harness of tests/test_parallel.py::test_multichip_md_step_runs:
    2 steps of 1 fs from rest, world 2, float64."""
    steps = same_on_every_rank(spawned[2], "md")
    plan, pos, box, gvals = jax_inputs("PME")
    masses = np.tile([16.0, 1.0], plan.num_particles // 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("atoms",))
    step = jmesh.make_multichip_md_step(plan, masses, dt=0.001, mesh=mesh,
                                        dtype=jnp.float64)
    data = jengine.plan_data(plan)
    vel = jnp.zeros_like(pos)
    for p_t, v_t, e_t in steps:
        pos, vel, energy = step(pos, vel, box, gvals, data)
        np.testing.assert_allclose(p_t, np.asarray(pos), rtol=0, atol=1e-9)
        np.testing.assert_allclose(v_t, np.asarray(vel), rtol=0, atol=1e-9)
        np.testing.assert_allclose(e_t, float(energy), rtol=1e-9)
    assert not np.allclose(steps[0][0], steps[1][0])


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", ["odd_capacity", "grid_3x4x5", "ljpme",
                                  "reaction_field"])
def test_pair_cell_plain_ranges_equal_whole_grid(case, parts):
    """The ranges a sharded evaluation of ``parts`` ranks launches, whose
    outputs concatenated are the whole-grid call's to the bit, forces and
    moment panels alike."""
    arrays = torch_pair_cases.pair_case_arrays(case)
    args = torch_pair_cases.pair_case_slots(arrays, True, "cpu",
                                            torch.float32)["args"]
    cfg, n = arrays["cfg"], arrays["charge"].shape[0]
    f_all, m_all = cuda_direct.pair_cell_plain(*args, True, n)
    per = -(-cfg.n_cells // parts)
    outs = [cuda_direct.pair_cell(*args, True, n,
                                  cells=(lo, min(per, cfg.n_cells - lo)))
            for lo in range(0, cfg.n_cells, per)]
    assert len(outs) == parts
    assert torch.equal(torch.cat([o[0] for o in outs]), f_all)
    assert torch.equal(torch.cat([o[1] for o in outs]), m_all)
    with pytest.raises(ValueError, match="cells"):
        cuda_direct.pair_cell(*args, True, n, cells=(cfg.n_cells - 1, 2))
