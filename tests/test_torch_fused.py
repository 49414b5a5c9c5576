"""Port fused engine (prepare/apply) vs the JAX package's fused engine
(Pallas kernels in interpret mode) and its all-pairs oracle: the column
kernel path (water triangles, reaction field) and the min-image cell kernel
path (dimer exclusions under PME), each under PME and LJPME, and through the
brick-window PME pipeline (``pme_pipeline="grid"``) on both sides."""

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


def _gvals(plan_j):
    """GVAL for every global parameter of the plan."""
    return [GVAL] * len(plan_j.global_names)


def _jax_inputs(plan_j, positions, dtype):
    data = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    return (jnp.asarray(positions, dtype), jnp.asarray(plan_j.box0, dtype),
            jnp.asarray(_gvals(plan_j), dtype), data)


def _port_inputs(plan_j, positions, dtype):
    data = tengine.data_from_numpy(jax_data_np(plan_j), device="cpu",
                                   dtype=dtype)
    return (torch.as_tensor(positions).to(dtype),
            torch.as_tensor(np.asarray(plan_j.box0)).to(dtype),
            torch.tensor(_gvals(plan_j), dtype=dtype), data)


def _port_eval(plan_t, inputs, energies, pos_apply=None, **kw):
    prep, app, cfg = tfused.make_fused_engine(plan_t, energies=energies, **kw)
    pos, box, gvals, data = inputs
    st = prep(pos, box, gvals, data)
    e, f, aux = app(pos if pos_apply is None else pos_apply, box, gvals,
                    data, st)
    return e, f, aux, cfg


LJPME = nbs.SlicedNonbondedForce.LJPME


@pytest.mark.parametrize("energies", [True, False])
@pytest.mark.parametrize("case", ["water_pme", "pairs_rf", "pairs_pme",
                                  "water_ljpme", "pairs_ljpme"])
def test_fused_apply_matches_jax_fused(case, energies):
    kw = dict(cell_capacity=32)
    if case.startswith("water"):
        # water triangles: the column kernel and the exclusion rows
        plan_j, plan_t, positions = both_plans(
            water_system, method=LJPME if case == "water_ljpme" else None)
    elif case.startswith("pairs_") and case != "pairs_rf":
        # dimer exclusions: the min-image cell kernel on both sides, with
        # 1-4 exceptions and parameter offsets
        ljpme = case == "pairs_ljpme"
        plan_j, plan_t, positions = both_plans(
            pair_system, LJPME if ljpme else nbs.SlicedNonbondedForce.PME,
            n_mol=100, box=3.0, extras=True, bond=0.1 if ljpme else None)
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


def _water_ljpme_wide_grid(api):
    """The LJPME water system with a dispersion grid of 30 points per axis:
    6 per brick of its (5, 5, 5) bricks, so that the window pipeline takes
    the dispersion pass too (the default grid, 25, has 5)."""
    from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha
    system, force, positions = water_system(api, method=LJPME)
    force.setLJPMEParameters(ewald_alpha(0.9, 5e-4), 30, 30, 30)
    return system, force, positions


@pytest.mark.parametrize("energies", [True, False])
@pytest.mark.parametrize("case", ["water_pme", "pairs_pme", "water_ljpme"])
def test_fused_apply_grid_pipeline_matches_jax_fused(monkeypatch, case,
                                                     energies):
    """The brick-window PME pipeline through the fused engine, against the
    JAX fused engine under NBS_PME_PIPELINE=grid (its fold and extract
    kernels in interpret mode), at the 2e-4 budget of the default pipeline;
    and against the port's default pipeline, whose slice energies it shares
    (the double whole-grid spread) and whose forces it matches to 2e-5.
    Under LJPME both passes, the charges' and the C6 weights', go through
    the windows."""
    monkeypatch.setenv("NBS_PME_PIPELINE", "grid")
    if case == "water_pme":
        plan_j, plan_t, positions = both_plans(water_system)
    elif case == "water_ljpme":
        plan_j, plan_t, positions = both_plans(_water_ljpme_wide_grid)
    else:
        plan_j, plan_t, positions = both_plans(
            pair_system, nbs.SlicedNonbondedForce.PME, n_mol=100, box=3.0,
            extras=True)
    kw = dict(cell_capacity=32)
    inputs = _port_inputs(plan_j, positions, torch.float32)
    e_t, f_t, aux, cfg = _port_eval(plan_t, inputs, energies,
                                    pme_pipeline="grid", **kw)
    assert int(aux["overflow"]) == 0
    for grid_key in ("pme_grid", "dispersion_grid"):
        assert all(p >= 6 for p, _ in tfused.pme_bricks.brick_window(
            cfg.get(grid_key, cfg["pme_grid"]), cfg["bricks"]))
    prep, app, _ = jfused.make_fused_engine(plan_j, interpret=True,
                                            energies=energies, **kw)
    pos, box, gvals, data = _jax_inputs(plan_j, positions, jnp.float32)
    e_j, f_j, _ = app(pos, box, gvals, data, prep(pos, box, gvals, data))
    f_j = np.asarray(f_j)
    scale = np.abs(f_j).max() + 1.0
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=2e-4 * scale)
    e_s, f_s, _, _ = _port_eval(plan_t, inputs, energies, **kw)
    np.testing.assert_allclose(f_t.numpy(), f_s.numpy(), atol=2e-5 * scale)
    if energies:
        e_j = np.asarray(e_j)
        np.testing.assert_allclose(e_t.numpy(), e_j,
                                   atol=2e-4 * (np.abs(e_j).max() + 1.0))
        np.testing.assert_array_equal(e_t.numpy(), e_s.numpy())
    else:
        assert e_t is None


def test_fused_grid_pipeline_refuses_narrow_bricks():
    """5 grid points per brick (w = 11 > 2p): the JAX package falls back to
    its "blocked" pipeline, the port raises and names the default one."""
    from nonbondedslicing_tpu_torch.ops import plan as tplan
    from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha
    system, force, _ = water_system(nbt)
    force.setPMEParameters(ewald_alpha(0.9, 5e-4), 25, 25, 25)
    plan_t = tplan.build_plan(force, system)
    with pytest.raises(ValueError, match="stencil"):
        tfused.make_fused_engine(plan_t, pme_pipeline="grid")
    with pytest.raises(ValueError, match="pme_pipeline must be one of"):
        tfused.make_fused_engine(plan_t, pme_pipeline="windows")
    assert tfused.make_fused_engine(plan_t) is not None


def test_fused_grid_pipeline_refuses_plan_without_pme():
    """A reaction-field plan has no reciprocal part: asking for the window
    pipeline raises rather than running the default one silently."""
    _, plan_t, _ = both_plans(
        pair_system, nbs.SlicedNonbondedForce.CutoffPeriodic, switching=True)
    with pytest.raises(ValueError, match="needs a PME plan"):
        tfused.make_fused_engine(plan_t, pme_pipeline="grid")
    assert tfused.make_fused_engine(plan_t) is not None


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
    """Bare Ewald, once refused here, builds in Ewald mode
    (tests/test_torch_fallbacks.py holds it to the JAX package); the
    window pipeline, which has no Ewald counterpart, still refuses it."""
    from nonbondedslicing_tpu_torch.ops import cuda_direct
    _, plan_t, _ = both_plans(pair_system, nbs.SlicedNonbondedForce.Ewald,
                              n_mol=100)
    _, _, cfg = tfused.make_fused_engine(plan_t)
    assert cfg["pair"].mode == cuda_direct.MODE_EWALD
    with pytest.raises(ValueError, match="needs a PME plan"):
        tfused.make_fused_engine(plan_t, pme_pipeline="grid")
