"""The two fallbacks the Context needs, against the JAX package on the CPU:

* the fused engine's bare Ewald (the pair kernel in Ewald mode plus the
  k-sum of ``ops/ewald.py`` on the atoms), a twin of
  tests/test_fused.py::test_fused_matches_oracle_bare_ewald at a smaller
  box: in float32 against the JAX fused engine (its Pallas kernels in
  interpret mode) at that test's 2e-4 scaled budget; in float64 against
  the JAX all-pairs oracle to 1e-10, with the exact erfc swapped into the
  pair kernel's twin for the comparison (the twin's A&S polynomial is off
  by up to 1.5e-7, the kernel's own arithmetic, as in the JAX kernel);
* ``make_md_step`` where the fused engine has no cell grid (fewer than 3
  cells of one cutoff per axis): the per-step rebuild over the generic
  engine, 10 steps against the JAX package's ``_make_md_step_simple``,
  float64 to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import fused as jfused
from nonbondedslicing_tpu.runtime.fastpath import make_md_step as jax_md_step

from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.runtime.fastpath import (SIMPLE_WINDOW,
                                                         make_md_step)

from tests.test_torch_plan import both_plans, jax_data_np, pair_system, \
    water_box, water_system

torch.set_num_threads(2)

EWALD = nbs.SlicedNonbondedForce.Ewald
GVAL = 0.8


def _ewald_case(case):
    """(JAX plan, port plan, positions) of a 3 nm Ewald box: dimer
    exclusions with 1-4s and offsets (the min-image cell kernel), or water
    triangles (the column kernel and the exclusion rows)."""
    if case == "pairs":
        return both_plans(pair_system, EWALD, n_mol=100, box=3.0,
                          extras=True)
    return both_plans(water_system, n_mol=100, box=3.0, method=EWALD)


def _port_fused(plan_j, plan_t, positions, dtype, energies=True):
    data = tengine.data_from_numpy(jax_data_np(plan_j), device="cpu",
                                   dtype=dtype)
    pos = torch.as_tensor(positions).to(dtype)
    box = torch.as_tensor(np.asarray(plan_j.box0)).to(dtype)
    gvals = torch.full((len(plan_j.global_names),), GVAL, dtype=dtype)
    prepare, apply, cfg = tfused.make_fused_engine(
        plan_t, cell_capacity=32, energies=energies)
    e, f, aux = apply(pos, box, gvals, data, prepare(pos, box, gvals, data))
    assert cfg["counts"] == (3, 3, 3) and int(aux["overflow"]) == 0
    return e, f


def _jax_inputs(plan_j, positions, dtype):
    data = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    return (jnp.asarray(positions, dtype), jnp.asarray(plan_j.box0, dtype),
            jnp.asarray([GVAL] * len(plan_j.global_names), dtype), data)


@pytest.mark.parametrize("case", ["pairs", "water"])
def test_fused_bare_ewald_matches_jax_fused(case):
    plan_j, plan_t, positions = _ewald_case(case)
    e_t, f_t = _port_fused(plan_j, plan_t, positions, torch.float32)
    _, f_only = _port_fused(plan_j, plan_t, positions, torch.float32,
                            energies=False)
    prepare, apply, _ = jfused.make_fused_engine(plan_j, interpret=True,
                                                 cell_capacity=32)
    pos, box, gvals, data = _jax_inputs(plan_j, positions, jnp.float32)
    e_j, f_j, _ = apply(pos, box, gvals, data,
                        prepare(pos, box, gvals, data))
    e_j, f_j = np.asarray(e_j), np.asarray(f_j)
    scale = float(np.abs(e_j).max()) + 1.0
    np.testing.assert_allclose(e_t.numpy(), e_j, atol=2e-4 * scale)
    fscale = float(np.abs(f_j).max()) + 1.0
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=2e-4 * fscale)
    # the force-only variant skips the energies, not the forces
    np.testing.assert_array_equal(f_only.numpy(), f_t.numpy())


@pytest.mark.parametrize("case", ["pairs", "water"])
def test_fused_bare_ewald_f64_matches_oracle(monkeypatch, case):
    monkeypatch.setattr(cuda_direct, "_erfc_gauss_hastings",
                        lambda x: (torch.special.erfc(x), torch.exp(-x * x)))
    plan_j, plan_t, positions = _ewald_case(case)
    e_t, f_t = _port_fused(plan_j, plan_t, positions, torch.float64)
    oracle = jengine.make_compute(plan_j, True, True, neighbor="all_pairs")
    e_o, f_o = oracle(*_jax_inputs(plan_j, positions, jnp.float64))
    e_o, f_o = np.asarray(e_o), np.asarray(f_o)
    np.testing.assert_allclose(e_t.numpy(), e_o, rtol=0,
                               atol=1e-10 * np.abs(e_o).max())
    np.testing.assert_allclose(f_t.numpy(), f_o, rtol=0,
                               atol=1e-10 * np.abs(f_o).max())


def test_md_step_below_three_cells_matches_jax():
    """The 125-water box (1.55 nm, cutoff 0.75: 2 cells per axis) from
    300 K velocities: the port's per-step rebuild against the JAX
    fallback, SETTLE in float64 on both sides, 10 steps in one window of
    10 and, on the port's side, in two runs of 5."""
    plan_j, plan_t, positions = both_plans(water_box, n_mol=125)
    _, _, _, masses, constraints, box = water_box(nbt, n_mol=125)
    assert tfused.fused_config(plan_t) is None
    rng = np.random.default_rng(0)
    vel = rng.normal(size=positions.shape) * np.sqrt(
        8.314e-3 * 300.0 / masses)[:, None]
    data_np = jax_data_np(plan_j)
    box_m = np.diag([box] * 3)
    run = make_md_step(plan_t, masses, dt=0.002, dtype=torch.float64,
                       constraints=constraints, reuse_steps=4)
    assert run.config["reuse_steps"] == 1 and SIMPLE_WINDOW >= 10
    assert run.config["route"] == "all_pairs" and run.config["graph"]
    data_t = tengine.data_from_numpy(data_np, device="cpu",
                                     dtype=torch.float64)
    p_t, v_t, e_t = run(positions, vel, box_m, np.array([1.0]), data_t, 10)
    p_h, v_h, _ = run(positions, vel, box_m, np.array([1.0]), data_t, 5)
    p_h, v_h, e_h = run(p_h, v_h, box_m, np.array([1.0]), data_t, 5)

    run_j = jax_md_step(plan_j, masses, dt=0.002, dtype=jnp.float64,
                        constraints=constraints)
    p_j, v_j, e_j = run_j(jnp.asarray(positions), jnp.asarray(vel),
                          jnp.asarray(box_m), jnp.asarray([1.0]), data_np,
                          10)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(v_j)).max())
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-10)
    np.testing.assert_array_equal(p_h.numpy(), p_t.numpy())
    assert float(e_h) == float(e_t)
