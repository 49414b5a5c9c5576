"""Port fused engine (prepare/apply) vs the JAX package's fused engine
(Pallas kernels in interpret mode) and its all-pairs oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import fused as jfused

from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused

from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0

from tests.test_torch_plan import both_plans, jax_data_np, pair_system, \
    water_system

torch.set_num_threads(2)

GVAL = 0.8


def _jax_inputs(plan_j, positions, dtype):
    data = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    return (jnp.asarray(positions, dtype), jnp.asarray(plan_j.box0, dtype),
            jnp.asarray([GVAL], dtype), data)


def _port_inputs(plan_j, positions, dtype):
    data = tengine.data_from_numpy(jax_data_np(plan_j), device="cpu",
                                   dtype=dtype)
    return (torch.as_tensor(positions).to(dtype),
            torch.as_tensor(np.asarray(plan_j.box0)).to(dtype),
            torch.tensor([GVAL], dtype=dtype), data)


def _port_eval(plan_t, inputs, energies, pos_apply=None, **kw):
    prep, app, cfg = tfused.make_fused_engine(plan_t, energies=energies, **kw)
    pos, box, gvals, data = inputs
    st = prep(pos, box, gvals, data)
    e, f, aux = app(pos if pos_apply is None else pos_apply, box, gvals,
                    data, st)
    return e, f, aux, cfg


@pytest.mark.parametrize("energies", [True, False])
@pytest.mark.parametrize("case", ["water_pme", "pairs_rf"])
def test_fused_apply_matches_jax_fused(case, energies):
    if case == "water_pme":
        plan_j, plan_t, positions = both_plans(water_system)
        kw = dict(cell_capacity=32)
    else:
        plan_j, plan_t, positions = both_plans(
            pair_system, nbs.SlicedNonbondedForce.CutoffPeriodic,
            switching=True)
        kw = {}
    e_t, f_t, aux, _ = _port_eval(plan_t, _port_inputs(plan_j, positions,
                                                       torch.float32),
                                  energies, **kw)
    assert int(aux["overflow"]) == 0 and float(aux["maxdisp2"]) == 0.0
    prep, app, _ = jfused.make_fused_engine(plan_j, interpret=True,
                                            energies=energies, **kw)
    pos, box, gvals, data = _jax_inputs(plan_j, positions, jnp.float32)
    e_j, f_j, _ = app(pos, box, gvals, data, prep(pos, box, gvals, data))
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=2e-4 * (np.abs(f_j).max() + 1.0))
    if energies:
        e_j = np.asarray(e_j)
        np.testing.assert_allclose(e_t.numpy(), e_j,
                                   atol=2e-4 * (np.abs(e_j).max() + 1.0))
        d_t = tengine.parameter_derivatives(e_t, plan_t.deriv_mask)
        d_j = np.asarray(jengine.parameter_derivatives(jnp.asarray(e_j),
                                                       plan_j.deriv_mask))
        np.testing.assert_allclose(d_t.numpy(), d_j,
                                   atol=2e-4 * (np.abs(e_j).max() + 1.0))
    else:
        assert e_t is None


def test_fused_f64_matches_all_pairs_oracle():
    """Whole float64 evaluation (plain twins) vs the JAX all-pairs oracle
    (exact erfc): the gap is the A&S erfc polynomial's error, 1e-6 of the
    largest force and its summed bound on the slice energies."""
    from nonbondedslicing_tpu.ops import plan as jplan
    from nonbondedslicing_tpu_torch.ops import plan as tplan
    from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha

    plans = []
    for api, plan_mod in ((nbs, jplan), (nbt, tplan)):
        system, force, positions = water_system(api)
        # the cell-aligned grid of the fused engine, for both
        force.setPMEParameters(ewald_alpha(0.9, 5e-4), 45, 45, 45)
        plans.append(plan_mod.build_plan(force, system))
    plan_j, plan_t = plans
    e_t, f_t, _, cfg = _port_eval(plan_t, _port_inputs(plan_j, positions,
                                                       torch.float64),
                                  True, cell_capacity=32)
    assert tuple(cfg["pme_grid"]) == tuple(plan_j.pme_grid) == (45, 45, 45)
    oracle = jengine.make_compute(plan_j, True, True, neighbor="all_pairs")
    e_o, f_o = oracle(*_jax_inputs(plan_j, positions, jnp.float64))
    e_o, f_o = np.asarray(e_o), np.asarray(f_o)
    np.testing.assert_allclose(f_t.numpy(), f_o,
                               atol=1e-6 * np.abs(f_o).max())
    # energies: the erfc polynomial's 1.5e-7 absolute error times the sum
    # of |k q_i q_j / r| over the pairs within the cutoff bounds the gap
    q = plan_j.base_params[:, 0]
    box = np.diag(plan_j.box0)
    d = positions[:, None] - positions[None, :]
    r = np.linalg.norm(d - box * np.round(d / box), axis=-1)
    near = (r < plan_j.cutoff) & (r > 0)
    bound = 1.5e-7 * ONE_4PI_EPS0 * np.sum(
        np.abs(q[:, None] * q[None, :])[near] / r[near]) / 2
    np.testing.assert_allclose(e_t.numpy(), e_o, rtol=0, atol=bound)


def test_fused_preshift_face_crossing_during_reuse():
    """Twin of tests/test_fused.py::test_fused_preshift_face_crossing_during_reuse:
    an atom crossing a periodic box face during the reuse window keeps its
    prepare-time image, so none of its pairs are dropped."""
    plan_j, plan_t, positions = both_plans(water_system)
    positions = positions.copy()
    positions[0] = [0.005, 2.0, 2.0]
    positions[1] = [0.08, 2.05, 2.0]
    positions[2] = [0.08, 1.95, 2.0]
    drift = np.zeros_like(positions)
    drift[0:3, 0] = -0.02
    inputs = _port_inputs(plan_j, positions, torch.float32)
    pos1 = inputs[0] + torch.as_tensor(drift, dtype=torch.float32)
    e_t, f_t, aux, cfg = _port_eval(plan_t, inputs, True, pos_apply=pos1,
                                    cell_capacity=32)
    assert float(aux["maxdisp2"]) <= (cfg["skin"] / 2) ** 2 + 1e-12
    assert int(aux["overflow"]) == 0

    oracle = jengine.make_compute(plan_j, True, True, neighbor="all_pairs")
    pos, box, gvals, data = _jax_inputs(plan_j, positions, jnp.float32)
    e_o, f_o = oracle(pos + jnp.asarray(drift, jnp.float32), box, gvals,
                      data)
    e_o, f_o = np.asarray(e_o), np.asarray(f_o)
    np.testing.assert_allclose(e_t.numpy(), e_o,
                               atol=2e-3 * (np.abs(e_o).max() + 1.0))
    np.testing.assert_allclose(f_t.numpy(), f_o,
                               atol=2e-3 * (np.abs(f_o).max() + 1.0))


def test_unported_methods_raise():
    for method, item in ((nbs.SlicedNonbondedForce.LJPME, "A10"),
                         (nbs.SlicedNonbondedForce.Ewald, "A9"),
                         (nbs.SlicedNonbondedForce.PME, "B4")):
        _, plan_t, _ = both_plans(pair_system, method, n_mol=100)
        with pytest.raises(NotImplementedError, match=item):
            tfused.make_fused_engine(plan_t)
