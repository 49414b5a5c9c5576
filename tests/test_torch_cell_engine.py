"""Port generic engine on its cell-list routes vs the JAX package's:
``neighbor="cell"`` (the plain cell list) in float64 to 1e-10 on the n = 300
systems of tests/test_neighbors.py, the overflow count past a forced small
capacity, ``neighbor="pallas"`` (the min-image cell kernel, whose plain
twin runs on CPU tensors) in float32 against the JAX package's Pallas route
in interpret mode to the tolerances of tests/test_pallas_direct.py, the
kernel route's float64 route (the plain cell list plus the generic
exclusion corrections), an excluded pair two cells apart, and the routing
of ``neighbor``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import neighbors as jneighbors
from nonbondedslicing_tpu.ops import plan as jplan

from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan

import tests.test_neighbors as jax_neighbor_tests
from tests.test_torch_plan import jax_data_np

torch.set_num_threads(2)

CP = "CutoffPeriodic"


def random_system(api, method_name, **kw):
    """tests/test_neighbors.py::_random_system through ``api``: (force,
    system, positions, box)."""
    saved = jax_neighbor_tests.nbs
    jax_neighbor_tests.nbs = api
    try:
        return jax_neighbor_tests._random_system(
            getattr(api.SlicedNonbondedForce, method_name), **kw)
    finally:
        jax_neighbor_tests.nbs = saved


def both(method_name, n=300, **kw):
    """(JAX plan, port plan, positions, box) of ``random_system``."""
    force_j, system_j, positions, box = random_system(nbs, method_name,
                                                      n=n, **kw)
    force_t, system_t, positions_t, _ = random_system(nbt, method_name,
                                                      n=n, **kw)
    np.testing.assert_array_equal(positions, positions_t)
    return (jplan.build_plan(force_j, system_j),
            tplan.build_plan(force_t, system_t), positions, box)


def jax_eval(plan_j, positions, box, neighbor, dtype, include=(True, True),
             **kw):
    data = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    fn = jengine.make_compute(plan_j, *include, neighbor=neighbor, **kw)
    e, f = fn(jnp.asarray(positions, dtype), jnp.asarray(box, dtype),
              jnp.asarray(plan_j.global_defaults, dtype), data)
    return np.asarray(e), np.asarray(f)


def port_eval(plan_t, positions, box, neighbor, dtype, include=(True, True),
              **kw):
    fn = tengine.make_compute(plan_t, *include, neighbor=neighbor,
                              with_aux=True, **kw)
    e, f, aux = fn(torch.as_tensor(positions).to(dtype),
                   torch.as_tensor(box).to(dtype),
                   torch.as_tensor(plan_t.global_defaults).to(dtype),
                   tengine.plan_data(plan_t, device="cpu", dtype=dtype))
    return e.numpy(), f.numpy(), aux, fn.route


def assert_close(e_t, f_t, e_j, f_j, tol):
    np.testing.assert_allclose(e_t, e_j, rtol=tol,
                               atol=tol * (np.abs(e_j).max() + 1.0))
    np.testing.assert_allclose(f_t, f_j, rtol=tol,
                               atol=tol * (np.abs(f_j).max() + 1.0))


@pytest.mark.parametrize("method,switching", [
    (CP, False), (CP, True), ("PME", False), ("LJPME", False)])
def test_cell_matches_jax(method, switching):
    """Float64 through the plain cell list on both sides, the reciprocal
    part included, to 1e-10."""
    plan_j, plan_t, positions, box = both(method, switching=switching)
    e_t, f_t, aux, route = port_eval(plan_t, positions, box, "cell",
                                     torch.float64)
    assert route == "cell" and int(aux["overflow"]) == 0
    assert "excl_span" not in aux
    e_j, f_j = jax_eval(plan_j, positions, box, "cell", np.float64)
    assert_close(e_t, f_t, e_j, f_j, 1e-10)


def test_overflow_counts_atoms_past_the_capacity():
    """A forced capacity of 4 slots (the mean occupancy is 4.7): both
    cell-list routes count the atoms that do not fit, as the JAX package's
    cell_overflow does."""
    plan_j, plan_t, positions, box = both(CP)
    counts, _ = jneighbors.choose_cell_grid(plan_j.box0, plan_j.cutoff,
                                            plan_j.num_particles)
    expected = int(jneighbors.cell_overflow(jnp.asarray(positions),
                                            jnp.asarray(box), counts, 4))
    assert expected > 0
    for neighbor in ("cell", "pallas"):
        _, _, aux, route = port_eval(plan_t, positions, box, neighbor,
                                     torch.float32, include=(True, False),
                                     cell_capacity=4)
        assert route == neighbor
        assert aux["overflow"].dtype == torch.int32
        assert int(aux["overflow"]) == expected, neighbor


@pytest.mark.parametrize("method,switching", [(CP, True), ("PME", False)])
def test_kernel_route_matches_jax_pallas(method, switching):
    """Float32 through the kernel route (the plain twin of pair_cell on
    CPU tensors) against the JAX package's Pallas route in interpret mode,
    direct space only, to tests/test_pallas_direct.py's tolerances."""
    plan_j, plan_t, positions, box = both(method, switching=switching)
    e_t, f_t, aux, route = port_eval(plan_t, positions, box, "pallas",
                                     torch.float32, include=(True, False))
    assert route == "pallas" and int(aux["overflow"]) == 0
    assert float(aux["excl_span"]) < 1.0
    e_j, f_j = jax_eval(plan_j, positions, box, "pallas", np.float32,
                        include=(True, False))
    np.testing.assert_allclose(e_t, e_j, rtol=2e-4, atol=2e-2)
    scale = np.abs(f_j).max()
    np.testing.assert_allclose(f_t, f_j, rtol=2e-3,
                               atol=2e-4 * max(scale, 1.0))


def test_kernel_route_float64_is_cell_plus_corrections():
    """Float64 tensors on the kernel route take the plain cell list plus
    the generic exclusion corrections, as the reference does: equal to the
    "cell" route to 1e-12 (the twin of
    tests/test_pallas_direct.py::test_pallas_f64_falls_back_with_corrections)."""
    _, plan_t, positions, box = both("PME")
    e_c, f_c, _, _ = port_eval(plan_t, positions, box, "cell",
                               torch.float64, include=(True, False))
    e_p, f_p, aux, route = port_eval(plan_t, positions, box, "pallas",
                                     torch.float64, include=(True, False))
    assert route == "pallas" and float(aux["excl_span"]) < 1.0
    assert_close(e_p, f_p, e_c, f_c, 1e-12)


def test_excluded_pair_two_cells_apart():
    """An excluded pair 2.2 nm apart (cells of 1 nm): the kernel route,
    which corrects only excluded pairs within the 27-cell neighbourhood,
    reports excl_span >= 1; the "cell" route, whose corrections take every
    pair, matches all pairs in float64."""
    _, plan_t, positions, box = both("PME")
    positions = positions.copy()
    positions[1] = positions[0] + [2.2, 0.0, 0.0]
    _, _, aux, _ = port_eval(plan_t, positions, box, "pallas",
                             torch.float32, include=(True, False))
    assert float(aux["excl_span"]) >= 1.0
    e_c, f_c, _, _ = port_eval(plan_t, positions, box, "cell", torch.float64)
    e_a, f_a, _, _ = port_eval(plan_t, positions, box, "all_pairs",
                               torch.float64)
    assert_close(e_c, f_c, e_a, f_a, 1e-10)


def _plan_with(n, emax=1, nsub=3):
    """A port plan of ``n`` atoms in a 6 nm PME box, atom 0 excluded with
    ``emax`` others."""
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((6, 0, 0), (0, 6, 0), (0, 0, 6))
    force = nbt.SlicedNonbondedForce(nsub)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.PME)
    force.setCutoffDistance(1.0)
    for i in range(n):
        system.addParticle(1.0)
        force.addParticle(0.1 * (-1) ** i, 0.3, 0.5)
        force.setParticleSubset(i, i % nsub)
    for j in range(1, emax + 1):
        force.addException(0, j, 0.0, 1.0, 0.0)
    system.addForce(force)
    return tplan.build_plan(force, system)


def test_routing():
    """"auto" takes the kernel route at n >= 1024, also with exclusion
    lists wider than a warp (40 per atom); past the kernel's limits "auto"
    and "pallas" raise and name neighbor="cell", which builds the plain
    cell list; small systems take all pairs."""
    plan = _plan_with(1024)
    assert tengine.make_compute(plan, True, True).route == "pallas"
    assert tengine.make_compute(plan, True, True,
                                neighbor="cell").route == "cell"
    assert tengine.make_compute(plan, True, True,
                                neighbor="all_pairs").route == "all_pairs"
    assert tengine.make_compute(_plan_with(1000), True,
                                True).route == "all_pairs"
    assert tengine.make_compute(_plan_with(1024, emax=40), True,
                                True).route == "pallas"
    wide = _plan_with(1024, emax=cuda_direct.MAX_EXCLUSIONS + 1)
    many = _plan_with(1024, nsub=cuda_direct.MAX_SUBSETS + 1)
    for past in (wide, many):
        for neighbor in ("auto", "pallas"):
            with pytest.raises(ValueError, match='neighbor="cell"'):
                tengine.make_compute(past, True, True, neighbor=neighbor)
        assert tengine.make_compute(past, True, True,
                                    neighbor="cell").route == "cell"
    with pytest.raises(ValueError, match='neighbor="cell"'):
        tengine.make_compute(plan, True, True, neighbor="pallas",
                             cell_capacity=cuda_direct.MAX_CAPACITY + 4)
    with pytest.raises(ValueError, match="neighbor must be"):
        tengine.make_compute(plan, True, True, neighbor="verlet")
