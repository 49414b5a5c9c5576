"""Port MD step (make_md_step) vs the JAX package's on the rigid-water box
of tests/test_md_conservation.py (under PME and LJPME, in single and mixed
precision), on a flexible chain solvated in water, with a harmonic bond
across a box face, and its guards; and its NVE energy conservation in both
precisions (the twin of
tests/test_md_conservation.py::test_nve_energy_conservation_rigid_water).
These CPU runs take make_md_step's eager loop; tests/test_torch_gpu_graph.py
holds its CUDA graphs against it on the card.

The box holds 512 waters instead of 125: the fused engine needs at least 3
cells of one cutoff per axis, and the 125-water box (1.55 nm) runs the
per-step rebuild fallback in both packages (held to each other in
tests/test_torch_fallbacks.py).  The solute box is port_systems.py's solute system at a small
size: its 12-site chain with harmonic bonds in a 3 nm box of 216 waters
spread to a third of water's density, so that it has 3 cells of its 0.9 nm
cutoff per axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.runtime.fastpath import make_md_step as jax_md_step

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops.fused import make_fused_engine
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from port_systems import KB, build_solute_system
from tests.test_torch_plan import D_HH, D_OH, both_plans, jax_data_np, \
    pair_system, water_box

torch.set_num_threads(2)


N_MOL = 512


def _setup(method=None):
    plan_j, plan_t, positions = both_plans(water_box, n_mol=N_MOL,
                                           method=method)
    _, _, _, masses, constraints, box = water_box(nbt, n_mol=N_MOL)
    data_np = jax_data_np(plan_j)
    return plan_j, plan_t, positions, masses, constraints, box, data_np


def _trajectory_against_jax(method=None, steps=10, bonds=None, **kw):
    """``steps`` steps of the water box from rest through both packages'
    make_md_step with the same arguments: positions to 1e-4 nm, the final
    energy to 1e-3 relative (float32 forces).  Returns the port's run,
    positions and energy."""
    plan_j, plan_t, positions, masses, constraints, box, data_np = _setup(
        method)
    run_t = make_md_step(plan_t, masses, dt=0.001, dtype=torch.float32,
                         constraints=constraints, reuse_steps=4, bonds=bonds,
                         **kw)
    data_t = tengine.data_from_numpy(data_np, device="cpu",
                                     dtype=torch.float32)
    p_t, v_t, e_t = run_t(positions, np.zeros_like(positions),
                          np.diag([box] * 3), np.array([1.0]), data_t, steps)
    assert run_t.config["reuse_steps"] == 4
    assert run_t.config["counts"] == (3, 3, 3)

    run_j = jax_md_step(plan_j, masses, dt=0.001, dtype=jnp.float32,
                        constraints=constraints, reuse_steps=4, bonds=bonds,
                        **kw)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in data_np.items()}
    p_j, v_j, e_j = run_j(jnp.asarray(positions, jnp.float32),
                          jnp.zeros(positions.shape, jnp.float32),
                          jnp.asarray(np.diag([box] * 3), jnp.float32),
                          jnp.asarray([1.0], jnp.float32), data_j, steps)
    mixed = kw.get("mixed_precision", False)
    assert p_t.dtype == (torch.float64 if mixed else torch.float32)
    assert v_t.dtype == torch.float32 and e_t.dtype == torch.float64
    assert np.asarray(p_j).dtype == p_t.numpy().dtype
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)
    return run_t, p_t, e_t


def test_md_trajectory_matches_jax():
    _trajectory_against_jax()


def test_md_ljpme_trajectory_matches_jax():
    """The same under LJPME: the column kernel's dispersion terms, the
    dispersion PME pass and the rows' back-out on every step."""
    run, _, _ = _trajectory_against_jax(nbs.SlicedNonbondedForce.LJPME,
                                        steps=6)
    assert run.config["dispersion_grid"] == (15, 15, 15)


def test_md_periodic_bond_matches_jax():
    """A harmonic bond between the oxygens of two waters on either side of
    the x face of the box, less than 0.4 nm apart by minimum image and more
    than half the box as given: with ``bonds_periodic`` both packages take
    the minimum image.  Without it the port takes the vector as given, as
    the JAX package does, and the bonded atoms move otherwise."""
    _, plan_t, positions, masses, constraints, box, data_np = _setup()
    o = positions[::3]
    a = int(np.argmin(o[:, 0]))
    near = o - o[a]
    near[:, 0] -= box
    d = np.linalg.norm(near, axis=1)
    b = int(np.argmin(np.where(o[:, 0] > 0.5 * box, d, np.inf)))
    r_min = float(d[b])
    r_raw = float(np.linalg.norm(o[b] - o[a]))
    assert r_min < 0.4 and r_raw > 0.5 * box
    bonds = [(3 * a, 3 * b, r_min + 0.05, 5000.0)]
    _, p_per, _ = _trajectory_against_jax(steps=4, bonds=bonds,
                                          bonds_periodic=True)
    run_raw = make_md_step(plan_t, masses, dt=0.001, constraints=constraints,
                           reuse_steps=4, bonds=bonds)
    p_raw, _, _ = run_raw(positions, np.zeros_like(positions),
                          np.diag([box] * 3), np.array([1.0]),
                          tengine.data_from_numpy(data_np, device="cpu",
                                                  dtype=torch.float32), 4)
    moved = (p_per - p_raw).abs()[[3 * a, 3 * b]]
    assert float(moved.max()) > 1e-3


def test_md_grid_pipeline_matches_stencil_pipeline(monkeypatch):
    """10 steps through make_md_step(pme_pipeline="grid") against the
    default pipeline from the same start.  In float64 the two trajectories
    agree to 1e-10 nm and the final energies to 1e-10 relative (the same
    arithmetic in another layout).  In float32 the pipelines' forces differ
    by rounding, which ten constrained steps amplify: positions to 1e-4 nm
    and the energy to 1e-3 relative, this file's float32 budget.  The four
    window kernels' wrappers are called once per step and once for the
    final energy, the whole-grid ones only by the double spread of that
    evaluation."""
    from nonbondedslicing_tpu_torch.ops import cuda_pme
    plan_j, plan_t, positions, masses, constraints, box, data_np = _setup()
    calls = {name: 0 for name in (
        "pme_spread_windows", "pme_fold", "pme_extract", "pme_interp_windows",
        "pme_spread", "pme_interp")}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(cuda_pme, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(cuda_pme, name, counted)
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-3),
                              (torch.float64, 1e-10, 1e-10)):
        data_t = tengine.data_from_numpy(data_np, device="cpu", dtype=dtype)
        out = {}
        for pipeline in ("grid", "stencil"):
            run = make_md_step(plan_t, masses, dt=0.001, dtype=dtype,
                               constraints=constraints, reuse_steps=4,
                               pme_pipeline=pipeline)
            assert run.config["pme_pipeline"] == pipeline
            before = dict(calls)
            out[pipeline] = run(positions, np.zeros_like(positions),
                                np.diag([box] * 3), np.array([1.0]), data_t,
                                10)
            made = {name: calls[name] - before[name] for name in calls}
            if pipeline == "grid":
                assert made == {
                    "pme_spread_windows": 11, "pme_fold": 11,
                    "pme_extract": 11, "pme_interp_windows": 11,
                    "pme_spread": 1, "pme_interp": 0}
            else:
                assert made == {
                    "pme_spread_windows": 0, "pme_fold": 0, "pme_extract": 0,
                    "pme_interp_windows": 0, "pme_spread": 12,
                    "pme_interp": 11}
        (p_g, _, e_g), (p_s, _, e_s) = out["grid"], out["stencil"]
        np.testing.assert_allclose(p_g.numpy(), p_s.numpy(), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(float(e_g), float(e_s), rtol=rtol)


def test_md_guards_raise():
    plan_j, plan_t, positions, masses, constraints, box, data_np = _setup()
    data_t = tengine.data_from_numpy(data_np, device="cpu",
                                     dtype=torch.float32)
    box_arr = np.diag([box] * 3)
    gvals = np.array([1.0])
    vel0 = np.zeros_like(positions)
    # forced cell overflow: capacity far below the occupancy
    run = make_md_step(plan_t, masses, dt=0.001, constraints=constraints,
                       cell_capacity=4, reuse_steps=2)
    with pytest.raises(nbt.OpenMMException, match="capacity overflow"):
        run(positions, vel0, box_arr, gvals, data_t, 2)
    # skin violation: atoms far faster than the reuse window allows
    run = make_md_step(plan_t, masses, dt=0.001, reuse_steps=4)
    fast = np.full_like(positions, 60.0)
    with pytest.raises(nbt.OpenMMException, match="skin violation"):
        run(positions, fast, box_arr, gvals, data_t, 4)
    # box-static engine: another box is refused
    with pytest.raises(nbt.OpenMMException, match="runtime box"):
        run(positions, vel0, 1.01 * box_arr, gvals, data_t, 1)


def test_md_excluded_pair_span_guard():
    """On the cell kernel's path, an excluded pair two cells apart raises
    after the run (the JAX Context's refusal, models/context.py:366-392);
    the solute box of this file spans less than a cell."""
    _, plan_t, positions = both_plans(pair_system,
                                      nbs.SlicedNonbondedForce.PME)
    masses = np.tile([16.0, 1.0], plan_t.num_particles // 2)
    data_t = tengine.plan_data(plan_t, device="cpu", dtype=torch.float32)
    run = make_md_step(plan_t, masses, dt=0.001, reuse_steps=1)
    assert run.config["counts"] == (4, 4, 4)       # cells of 1.2 nm
    positions = positions.copy()
    positions[1] = positions[0] + [2.2, 0.0, 0.0]
    with pytest.raises(nbt.OpenMMException, match="excluded pair spans"):
        run(positions, np.zeros_like(positions), plan_t.box0, [0.8], data_t,
            1)

    out = _solute_box(nbt)
    plan_s = tplan.build_plan(out[1], out[0])
    prep, app, _ = make_fused_engine(plan_s, cell_capacity=64)
    data_s = tengine.plan_data(plan_s, device="cpu", dtype=torch.float32)
    pos = torch.as_tensor(out[2], dtype=torch.float32)
    box = torch.as_tensor(plan_s.box0, dtype=torch.float32)
    gvals = torch.as_tensor(plan_s.global_defaults, dtype=torch.float32)
    _, _, aux = app(pos, box, gvals, data_s, prep(pos, box, gvals, data_s))
    assert 0.0 < float(aux["excl_span"]) < 1.0


def test_md_mixed_matches_jax():
    """mixed_precision=True: float64 positions with float32 forces, kick
    and velocities, the position update and SETTLE in float64.  Against the
    JAX package's mixed run (its double-single positions) on the water box
    for 10 steps: positions to 1e-4 nm, the energy to 1e-3 relative.
    Against the port's single run, to the bounds of the JAX package's test
    (tests/test_md_conservation.py::test_mixed_precision_default_and_
    trajectory_consistency): positions to 1e-4 nm, the energy to 1e-3 |E|
    + 1; the water geometry holds to 1e-8 nm (the JAX test allows 5e-6),
    since the constraint solve runs in float64.  mixed_precision is
    ignored beside dtype=float64, as in the JAX package."""
    run_m, p_m, e_m = _trajectory_against_jax(mixed_precision=True)
    assert run_m.config["mixed_precision"] is True
    _, plan_t, positions, masses, constraints, box, data_np = _setup()
    run_s = make_md_step(plan_t, masses, dt=0.001, dtype=torch.float32,
                         constraints=constraints, reuse_steps=4)
    assert run_s.config["mixed_precision"] is False
    p_s, _, e_s = run_s(positions, np.zeros_like(positions),
                        np.diag([box] * 3), np.array([1.0]),
                        tengine.data_from_numpy(data_np, device="cpu",
                                                dtype=torch.float32), 10)
    np.testing.assert_allclose(p_m.numpy(), p_s.double().numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(e_m), float(e_s), rtol=0,
                               atol=1e-3 * abs(float(e_s)) + 1.0)
    w = p_m.numpy().reshape(-1, 3, 3)
    for (a, b), d in (((0, 1), D_OH), ((0, 2), D_OH), ((1, 2), D_HH)):
        err = np.abs(np.linalg.norm(w[:, a] - w[:, b], axis=-1) - d).max()
        assert err < 1e-8, ((a, b), err)
    run64 = make_md_step(plan_t, masses, dt=0.001, dtype=torch.float64,
                         mixed_precision=True)
    assert run64.config["mixed_precision"] is False
    # harmonic bonds are ported
    run = make_md_step(plan_t, masses, dt=0.001, bonds=[(0, 1, 0.1, 1000.0)])
    assert run.config["reuse_steps"] >= 1


def test_md_graph_flag_for_wide_clusters():
    """A constraint cluster wider than 3 (two waters joined by an O-O
    constraint: 7 coupled constraints) takes the gather constrainer's
    CGLS solve, which reads nothing back to the host: run.config["graph"]
    is True, so the card replays its windows as CUDA graphs, as it does
    for rigid waters alone."""
    from nonbondedslicing_tpu_torch.runtime.constraints import \
        cluster_constraints
    _, plan_t, positions, masses, (cons_p, cons_d), box, _ = _setup()
    triples = [(i, j, d) for pairs, dists in zip(cons_p, cons_d)
               for (i, j), d in zip(pairs, dists)]
    run = make_md_step(plan_t, masses, dt=0.001,
                       constraints=cluster_constraints(triples, len(masses)))
    assert run.config["graph"] is True
    d_oo = float(np.linalg.norm(positions[0] - positions[3]))
    wide = cluster_constraints(triples + [(0, 3, d_oo)], len(masses))
    assert wide[0].shape[1] == 7
    run = make_md_step(plan_t, masses, dt=0.001, constraints=wide)
    assert run.config["graph"] is True


SOLUTE_BOX = 3.0


def _solute_box(api):
    """port_systems.build_solute_system on 216 waters spread over a 3 nm box."""
    _, _, positions, _, _, box = water_box(api, n_mol=216, seed=5)
    waters = positions.reshape(-1, 3, 3)
    waters = waters + waters[:, :1] * (SOLUTE_BOX / box - 1.0)
    return build_solute_system(api, waters.reshape(-1, 3), SOLUTE_BOX)


def test_md_solute_trajectory_matches_jax(monkeypatch):
    """20 steps of the chain in water, with bonds and the gather
    constrainer, through the cell pair kernel on both sides: positions to
    2e-4 nm, the final energy to 1e-3 relative (float32)."""
    out_j, out_t = _solute_box(nbs), _solute_box(nbt)
    plan_j = jplan.build_plan(out_j[1], out_j[0])
    plan_t = tplan.build_plan(out_t[1], out_t[0])
    _, _, positions, masses, constraints, bonds, _ = out_t
    np.testing.assert_array_equal(positions, out_j[2])
    rng = np.random.default_rng(11)
    vel = rng.normal(size=positions.shape) * np.sqrt(KB * 300.0 / masses)[:, None]
    box = np.diag([SOLUTE_BOX] * 3)
    gvals = plan_t.global_defaults
    calls = {"pair_cell": 0, "pair_column": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(cuda_direct, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(cuda_direct, name, counted)

    run_t = make_md_step(plan_t, masses, dt=0.002, dtype=torch.float32,
                         constraints=constraints, bonds=bonds, reuse_steps=2)
    data_t = tengine.plan_data(plan_t, device="cpu", dtype=torch.float32)
    p_t, v_t, e_t = run_t(positions, vel, box, gvals, data_t, 20)
    assert run_t.config["counts"] == (3, 3, 3)
    assert calls == {"pair_cell": 21, "pair_column": 0}

    run_j = jax_md_step(plan_j, masses, dt=0.002, dtype=jnp.float32,
                        constraints=constraints, bonds=bonds, reuse_steps=2)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in jax_data_np(plan_j).items()}
    p_j, v_j, e_j = run_j(jnp.asarray(positions, jnp.float32),
                          jnp.asarray(vel, jnp.float32),
                          jnp.asarray(box, jnp.float32),
                          jnp.asarray(gvals, jnp.float32), data_j, 20)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)


@pytest.mark.parametrize("method,precision", [
    pytest.param("PME", "single", id="PME"),
    pytest.param("LJPME", "single", id="LJPME"),
    pytest.param("PME", "mixed", id="PME-mixed"),
    pytest.param("LJPME", "mixed", id="LJPME-mixed")])
def test_nve_energy_conservation(method, precision):
    """Twin of tests/test_md_conservation.py::test_nve_energy_conservation_
    rigid_water in single and in mixed precision (float64 positions), on
    this file's 512-water box (K = 2:
    the lattice relaxes fast at first): settle it for 20 steps of 1 fs,
    then PE + KE may drift by at most 5% of the kinetic energy scale over
    40 more.  PE is the energy each run() returns (its last evaluation,
    with energies, at the final positions); KE that of the leapfrog
    half-step velocities, as in the JAX test."""
    _, plan_t, positions, masses, constraints, box, _ = _setup(
        getattr(nbs.SlicedNonbondedForce, method))
    data = tengine.plan_data(plan_t, device="cpu", dtype=torch.float32)
    run = make_md_step(plan_t, masses, dt=0.001, dtype=torch.float32,
                       constraints=constraints, reuse_steps=2,
                       mixed_precision=precision == "mixed")
    box_arr = np.diag([box] * 3)

    def total_energy(vel, pe):
        ke = 0.5 * float(np.sum(masses[:, None]
                                * vel.double().numpy() ** 2))
        return float(pe) + ke, ke

    pos, vel, pe = run(positions, np.zeros_like(positions), box_arr, [1.0],
                       data, 20)
    e0, ke0 = total_energy(vel, pe)
    pos, vel, pe = run(pos, vel, box_arr, [1.0], data, 40)
    e1, ke1 = total_energy(vel, pe)
    assert ke1 > 0.0
    assert abs(e1 - e0) < 0.05 * max(ke0, ke1, 100.0), (e0, e1, ke0, ke1)
