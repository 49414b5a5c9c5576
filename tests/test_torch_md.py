"""Port MD step (make_md_step) vs the JAX package's on the rigid-water box
of tests/test_md_conservation.py, and its guards.

The box holds 512 waters instead of 125: the fused engine needs at least 3
cells of one cutoff per axis, and the 125-water box (1.55 nm) runs the JAX
package's per-step rebuild fallback, which the port has not yet
(ROADMAP A9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonbondedslicing_tpu.runtime.fastpath import make_md_step as jax_md_step

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

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
    with pytest.raises(NotImplementedError, match="A11"):
        make_md_step(plan_t, masses, dt=0.001, bonds=[(0, 1, 0.1, 1000.0)])
