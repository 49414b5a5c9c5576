"""Port MD step (make_md_step) vs the JAX package's on the rigid-water box
of tests/test_md_conservation.py, on a flexible chain solvated in water,
and its guards.

The box holds 512 waters instead of 125: the fused engine needs at least 3
cells of one cutoff per axis, and the 125-water box (1.55 nm) runs the JAX
package's per-step rebuild fallback, which the port has not yet
(ROADMAP A9).  The solute box is port_systems.py's solute system at a small
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
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from port_systems import KB, build_solute_system
from tests.test_torch_plan import both_plans, jax_data_np, water_box

torch.set_num_threads(2)


N_MOL = 512


def _setup():
    plan_j, plan_t, positions = both_plans(water_box, n_mol=N_MOL)
    _, _, _, masses, constraints, box = water_box(nbt, n_mol=N_MOL)
    data_np = jax_data_np(plan_j)
    return plan_j, plan_t, positions, masses, constraints, box, data_np


def test_md_trajectory_matches_jax():
    plan_j, plan_t, positions, masses, constraints, box, data_np = _setup()
    run_t = make_md_step(plan_t, masses, dt=0.001, dtype=torch.float32,
                         constraints=constraints, reuse_steps=4)
    data_t = tengine.data_from_numpy(data_np, device="cpu",
                                     dtype=torch.float32)
    p_t, v_t, e_t = run_t(positions, np.zeros_like(positions),
                          np.diag([box] * 3), np.array([1.0]), data_t, 10)
    assert run_t.config["reuse_steps"] == 4
    assert run_t.config["counts"] == (3, 3, 3)

    run_j = jax_md_step(plan_j, masses, dt=0.001, dtype=jnp.float32,
                        constraints=constraints, reuse_steps=4)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in data_np.items()}
    p_j, v_j, e_j = run_j(jnp.asarray(positions, jnp.float32),
                          jnp.zeros(positions.shape, jnp.float32),
                          jnp.asarray(np.diag([box] * 3), jnp.float32),
                          jnp.asarray([1.0], jnp.float32), data_j, 10)
    assert p_t.dtype == torch.float32 and e_t.dtype == torch.float64
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)


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


def test_md_unported_options_raise():
    plan_j, plan_t, positions, masses, constraints, box, data_np = _setup()
    with pytest.raises(NotImplementedError, match="A7"):
        make_md_step(plan_t, masses, dt=0.001, mixed_precision=True)
    # harmonic bonds are ported
    run = make_md_step(plan_t, masses, dt=0.001, bonds=[(0, 1, 0.1, 1000.0)])
    assert run.config["reuse_steps"] >= 1


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
