"""LJPME in the port vs the JAX package.

* the dispersion convolution kernel (``pme.dispersion_eterm_np``) to 1e-12;
* the dispersion pass of the PME pipeline (``cuda_pme.pme_reciprocal(...,
  dispersion=True)``: C6 weights, the dispersion kernel, the vdW lambdas)
  against the JAX generic ``pme.pme_reciprocal(dispersion=True)`` in
  float64 to 1e-10;
* the exclusion rows' dispersion back-out against the JAX package's
  ``bonded.exclusion_corrections_rows(ljpme=True)``, float64 to 1e-10 and
  float32 to 2e-5 of the largest value;
* the fused engine in float64 against the all-pairs oracle, on the column
  kernel's path (water triangles, the rows) and the cell kernel's (dimers,
  the fused back-out);
* the window pipeline's refusal where the dispersion grid has fewer than 6
  points per brick, as at the 23,289-atom benchmark box (ROADMAP D5).

The fused engine against the JAX fused engine, both PME pipelines, is in
tests/test_torch_fused.py; the pair kernels' LJPME terms, with and without
the switch, in the hard shapes of tests/torch_pair_cases.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import bonded as jbonded
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import pme as jpme
from nonbondedslicing_tpu.utils.indexing import slice_pair_table, slice_subsets

from nonbondedslicing_tpu_torch.ops import bonded as tbonded
from nonbondedslicing_tpu_torch.ops import cuda_pme
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.ops import pme as tpme
from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0
from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha

from port_systems import build_system
from tests.test_torch_fused import (_gvals, _jax_inputs, _port_eval,
                                    _port_inputs)
from tests.test_torch_plan import both_plans, jax_data_np, pair_system, \
    water_system
from tests.test_torch_pme import BOX, GRID, N, NSUB, _inputs, _port_slots

torch.set_num_threads(2)

LJPME = nbs.SlicedNonbondedForce.LJPME


@pytest.mark.parametrize("grid,box", [
    ((30, 30, 30), np.diag([6.1484] * 3)),
    ((12, 15, 20), np.array([[3.0, 0, 0], [0.4, 3.2, 0], [-0.3, 0.5, 3.5]]))])
def test_dispersion_eterm_matches_jax(grid, box):
    """Including the zero frequency, which the Coulomb kernel drops."""
    moduli = tpme.bspline_moduli(grid)
    e_t = tpme.dispersion_eterm_np(grid, moduli, box, 2.92)
    e_j = jpme.dispersion_eterm_np(grid, jpme.bspline_moduli(grid), box, 2.92)
    assert e_t.shape == (grid[0], grid[1], grid[2] // 2 + 1)
    assert e_t[0, 0, 0] != 0.0
    np.testing.assert_allclose(e_t, e_j, rtol=1e-12,
                               atol=1e-12 * np.abs(e_j).max())


def test_dispersion_pass_f64_matches_generic_pme():
    """The port's PME pipeline with per-slot C6 weights, the dispersion
    kernel and ``dispersion=True`` against the JAX generic LJPME
    reciprocal pass, on the slots of tests/test_torch_pme.py."""
    positions, _, subsets, lam = _inputs()
    rng = np.random.default_rng(21)
    sig_half = rng.uniform(0.02, 0.17, N)
    eps2 = rng.uniform(0.3, 1.6, N)
    c6 = 8.0 * sig_half ** 3 * eps2
    alpha = 2.5
    box, table, slot_pos, slot_c6, slot_sub = _port_slots(
        positions, c6, subsets, torch.float64)
    moduli = tpme.bspline_moduli(GRID)
    eterm = torch.as_tensor(tpme.dispersion_eterm_np(GRID, moduli,
                                                     box.numpy(), alpha))
    e_t, f_t = cuda_pme.pme_reciprocal(
        slot_pos, slot_c6, slot_sub, box,
        torch.as_tensor(lam[slice_pair_table(NSUB)]), grid_shape=GRID,
        eterm=eterm, slice_subset_pairs=torch.as_tensor(slice_subsets(NSUB)),
        dispersion=True)
    inv = torch.zeros(N + 1, dtype=torch.int64)
    inv[table.reshape(-1).long()] = torch.arange(table.numel())
    f_t = f_t.transpose(1, 2).reshape(-1, 3)[inv[:N]].numpy()

    e_o, f_o = jpme.pme_reciprocal(
        jnp.asarray(positions), jnp.asarray(np.diag([BOX] * 3)),
        jnp.asarray(c6), jnp.asarray(subsets, jnp.int32), jnp.asarray(lam),
        alpha=alpha, grid_shape=GRID, moduli=jpme.bspline_moduli(GRID),
        num_subsets=NSUB, slice_subset_pairs=jnp.asarray(slice_subsets(NSUB)),
        slice_table=slice_pair_table(NSUB), dispersion=True, dense=False)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_o), rtol=1e-10)
    f_o = np.asarray(f_o)
    np.testing.assert_allclose(f_t, f_o, rtol=0,
                               atol=1e-10 * np.abs(f_o).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exclusion_rows_ljpme_match_jax(dtype):
    """80 water-like triangles (O-H 0.09-0.11 nm at 104.5 degrees) with
    random parameters and lambdas.  (At a few hundredths of a nm the
    back-out cancels to float32 noise, in both packages alike.)"""
    rng = np.random.default_rng(5)
    m = 80
    n = 3 * m
    o = rng.random((m, 3)) * 3.0
    u = rng.normal(size=(m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(u, rng.normal(size=(m, 3)))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta = np.deg2rad(104.5)
    legs = rng.uniform(0.09, 0.11, (m, 2, 1))
    positions = np.stack([o, o + legs[:, 0] * u,
                          o + legs[:, 1] * (np.cos(theta) * u
                                            + np.sin(theta) * v)],
                         axis=1).reshape(n, 3)
    charge = rng.normal(size=n)
    sig_half = 0.02 + 0.15 * rng.random(n)
    eps2 = rng.random(n)
    subsets = rng.integers(0, 3, n)
    sl_tab = slice_pair_table(3)
    lam_c = rng.random(6)
    lam_v = rng.random(6)
    sub3 = subsets.reshape(m, 3)
    pair_slices = np.stack([sl_tab[sub3[:, 0], sub3[:, 1]],
                            sl_tab[sub3[:, 0], sub3[:, 2]],
                            sl_tab[sub3[:, 1], sub3[:, 2]]], axis=1)
    kw = dict(alpha=2.7, ljpme=True, dispersion_alpha=2.0, num_slices=6)
    t = lambda a: torch.as_tensor(a).to(dtype)   # noqa: E731
    e_t, f_t = tbonded.exclusion_corrections_rows(
        t(positions), t(charge), t(sig_half), t(eps2),
        torch.as_tensor(pair_slices), t(lam_c), t(lam_v), **kw)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = lambda a: jnp.asarray(a, jdt)            # noqa: E731
    e_j, f_j = jbonded.exclusion_corrections_rows(
        j(positions), j(charge), j(sig_half), j(eps2),
        jnp.asarray(pair_slices, jnp.int32), j(lam_c), j(lam_v), **kw)
    e_j, f_j = np.asarray(e_j), np.asarray(f_j)
    assert np.abs(e_j[:, 1]).max() > 0.0       # the dispersion back-out
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=0,
                               atol=tol * np.abs(e_j).max())
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=tol * np.abs(f_j).max())
    # without LJPME the vdW column is empty
    e_p, _ = tbonded.exclusion_corrections_rows(
        t(positions), t(charge), t(sig_half), t(eps2),
        torch.as_tensor(pair_slices), t(lam_c), t(lam_v),
        **dict(kw, ljpme=False))
    assert not e_p[:, 1].any()


def _ljpme_aligned(make_system, grid, dgrid, **kwargs):
    """``make_system`` under LJPME with the cell-aligned PME and dispersion
    grids of the fused engine set explicitly, so that the all-pairs oracle
    (which takes the plan's grids as they are) uses the same."""
    def build(api):
        system, force, positions = make_system(api, method=LJPME, **kwargs)
        force.setPMEParameters(ewald_alpha(0.9, 5e-4), *grid)
        force.setLJPMEParameters(ewald_alpha(0.9, 5e-4), *dgrid)
        return system, force, positions
    return build


@pytest.mark.parametrize("case", ["water", "pairs"])
def test_fused_ljpme_f64_matches_all_pairs_oracle(case):
    """LJPME in float64 (plain twins) against the JAX all-pairs oracle:
    the column kernel with the exclusion rows (water) and the cell kernel
    with the fused exclusion back-out (dimers 0.1 nm apart, 1-4 exceptions,
    parameter offsets).  The dispersion terms are exact on both sides, so
    the gap is the A&S erfc polynomial's, as for PME
    (tests/test_torch_fused.py): 1e-6 of the largest force, and its summed
    bound on the slice energies.  Both packages turn the switch off under
    LJPME (ops/plan.py); the switched LJPME pair terms are held to the
    oracle in the hard shapes of tests/test_torch_pair.py."""
    if case == "water":
        build = _ljpme_aligned(water_system, (45,) * 3, (25,) * 3)
    else:
        build = _ljpme_aligned(pair_system, (27,) * 3, (15,) * 3, n_mol=100,
                               box=3.0, extras=True, bond=0.1)
    plan_j, plan_t, positions = both_plans(build)
    e_t, f_t, _, cfg = _port_eval(plan_t, _port_inputs(plan_j, positions,
                                                       torch.float64),
                                  True, cell_capacity=32)
    assert tuple(cfg["pme_grid"]) == tuple(plan_j.pme_grid)
    assert tuple(cfg["dispersion_grid"]) == tuple(plan_j.dispersion_grid)
    assert cfg["pair"].ljpme and not cfg["pair"].use_switch
    oracle = jengine.make_compute(plan_j, True, True, neighbor="all_pairs")
    e_o, f_o = oracle(*_jax_inputs(plan_j, positions, jnp.float64))
    e_o, f_o = np.asarray(e_o), np.asarray(f_o)
    np.testing.assert_allclose(f_t.numpy(), f_o,
                               atol=1e-6 * np.abs(f_o).max())
    # the polynomial's 1.5e-7 in erfc (pairs within the cutoff) and in erf
    # (excluded pairs), times k |q_i q_j| / r
    data = jax_data_np(plan_j)
    q = np.abs(data["base_params"][:, 0]
               + np.asarray(_gvals(plan_j)) @ data["charge_offsets"])
    box = np.diag(plan_j.box0)
    d = positions[:, None] - positions[None, :]
    r = np.linalg.norm(d - box * np.round(d / box), axis=-1)
    near = (r < plan_j.cutoff) & (r > 0)
    ex = plan_j.exclusion_pairs
    near[ex[:, 0], ex[:, 1]] = near[ex[:, 1], ex[:, 0]] = True
    bound = 1.5e-7 * ONE_4PI_EPS0 * np.sum(
        (q[:, None] * q[None, :])[near] / r[near]) / 2
    np.testing.assert_allclose(e_t.numpy(), e_o, rtol=0, atol=bound)


def test_grid_pipeline_refuses_the_benchmark_dispersion_grid():
    """At the 23,289-atom benchmark box the dispersion grid is 28 points,
    aligned to its (6, 6, 6) bricks as 30: 5 points a brick, so the window
    pipeline raises and names the default one (D5; the JAX package falls
    back to "blocked").  The default pipeline takes it, and the skin is the
    PME plan's: the cap of two dispersion-grid spacings (0.41 nm) does not
    bind."""
    plans = {}
    for method in ("PME", "LJPME"):
        system, force, _, _ = build_system(nbt, method)
        plans[method] = tplan.build_plan(force, system)
    plan = plans["LJPME"]
    assert plan.dispersion_grid == (28, 28, 28)
    with pytest.raises(ValueError, match="stencil"):
        tfused.make_fused_engine(plan, target_skin=0.09, pme_pipeline="grid")
    _, _, cfg = tfused.make_fused_engine(plan, target_skin=0.09)
    assert cfg["bricks"] == (6, 6, 6)
    assert cfg["dispersion_grid"] == (30, 30, 30)
    assert cfg["pme_grid"] == (60, 60, 60)
    assert cfg["pair"].ljpme
    assert cfg["skin"] == tfused.fused_config(plans["PME"], None, 0.09)["skin"]
