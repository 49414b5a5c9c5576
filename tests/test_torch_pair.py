"""Pair kernel (B1) plain twin vs the JAX package.

* float32: against ``pallas_direct.make_pallas_column_kernel`` in interpret
  mode on the same slot tensors, at the fused engine's 2e-4 scaled budget
  (tests/test_fused.py:66-71).
* float64: against the JAX all-pairs direct-space oracle (exact erfc) at
  1e-6 relative — the bound set by the A&S 7.1.26 erfc polynomial's
  ~1.5e-7 absolute error (pallas_direct.py:19-22).  The hard shapes of
  tests/torch_pair_cases.py (the ones the CUDA kernel is held to on the
  card) go through the same oracle, each atom at the budget the polynomial
  gives its own pairs (``torch_pair_cases.erfc_budget``, below 1e-3 of
  max|F| in every case).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import direct as jdirect
from nonbondedslicing_tpu.ops import params as jparams
from nonbondedslicing_tpu.ops.pallas_direct import make_pallas_column_kernel
from nonbondedslicing_tpu.utils.indexing import slice_subsets

from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.ops import params as tparams

from tests.test_torch_plan import both_plans, jax_data_np, pair_system
from torch_pair_cases import (PAIR_CASES, erfc_budget,
                              pair_case_arrays, pair_case_slots)

torch.set_num_threads(2)

GVAL = 0.8


def _slots(switching, dtype):
    """Port slot tensors of a (3, 3, 3)-cell pair system, the plans and
    inputs, and the pair config for both physics modes."""
    plan_j, plan_t, positions = both_plans(
        pair_system, nbs.SlicedNonbondedForce.CutoffPeriodic, n_mol=100,
        box=3.0, switching=switching)
    data_np = jax_data_np(plan_j)
    data = tengine.data_from_numpy(data_np, device="cpu", dtype=dtype)
    prep, _, cfg = tfused.make_fused_engine(plan_t, cell_capacity=32)
    assert cfg["counts"] == (3, 3, 3)
    pos = torch.as_tensor(positions).to(dtype)
    box = torch.as_tensor(np.asarray(plan_t.box0)).to(dtype)
    gvals = torch.tensor([GVAL], dtype=dtype)
    st = prep(pos, box, gvals, data)
    assert int(st["overflow"]) == 0
    g, C = cfg["pair"].n_cells, cfg["pair"].capacity
    slot_pos = (torch.cat([st["pos0w"], pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    lam = tparams.slice_lambdas(plan_t.lam_source, gvals)
    sl_tab = torch.as_tensor(plan_t.slice_table, dtype=torch.int64)
    return dict(plan_j=plan_j, plan_t=plan_t, positions=positions,
                data_np=data_np, st=st, slot_pos=slot_pos, box=box,
                lam=lam, lam_c_nn=lam[:, 0][sl_tab].contiguous(),
                lam_v_nn=lam[:, 1][sl_tab].contiguous(), cfg=cfg["pair"])


def _pair_cfg(cfg, ewald, plan):
    if not ewald:
        return cfg
    from nonbondedslicing_tpu_torch.utils.ewald_params import ewald_alpha
    return dataclasses.replace(cfg, mode=cuda_direct.MODE_EWALD,
                               ewald_alpha=ewald_alpha(plan.cutoff, 5e-4))


def _slice_energies(moments, nsub):
    """(S, 2) from per-cell (2, nsub, nsub) moments or per-tile JAX ones."""
    m = moments.sum(axis=0)
    pairs = slice_subsets(nsub)
    a, b = pairs[:, 0], pairs[:, 1]
    return np.where((a == b)[:, None], m[:, a, a].T, (m[:, a, b] + m[:, b, a]).T)


@pytest.mark.parametrize("energies", [True, False])
@pytest.mark.parametrize("switching", [False, True])
@pytest.mark.parametrize("ewald", [False, True])
def test_plain_pair_matches_pallas_column_kernel(ewald, switching, energies):
    s = _slots(switching, torch.float32)
    cfg = _pair_cfg(s["cfg"], ewald, s["plan_t"])
    st = s["st"]
    forces, moments = cuda_direct.pair_column(
        s["slot_pos"], st["slot_par"], st["slot_sub"], st["table"],
        st["sexcl"], s["lam_c_nn"], s["lam_v_nn"], s["box"], cfg, energies,
        s["plan_t"].num_particles)
    assert (moments is None) == (not energies)

    # the same slots in the JAX kernel's feature-major layout
    nsub, C = cfg.nsub, cfg.capacity
    real = (st["table"] < s["plan_t"].num_particles).numpy()
    oh = (np.arange(nsub)[None, :, None] == st["slot_sub"].numpy()[:, None, :])
    oh = (oh & real[:, None, :]).astype(np.float32)
    feat = np.concatenate([s["slot_pos"].numpy(), st["slot_par"].numpy(), oh],
                          axis=1).reshape(cfg.counts + (6 + nsub, C))
    kern = make_pallas_column_kernel(
        mode=jdirect.EWALD_DIRECT if ewald else jdirect.CUTOFF,
        cutoff=cfg.cutoff, counts=cfg.counts, capacity=C, nsub=nsub,
        emax=cfg.emax, krf=cfg.krf, crf=cfg.crf, use_switch=cfg.use_switch,
        switch_distance=cfg.switch_distance, ewald_alpha=cfg.ewald_alpha,
        interpret=True, compute_energies=energies, assume_pads_far=True)
    f_j, mc_j, mv_j = kern(
        jnp.asarray(feat), jnp.asarray(st["table"].numpy()).reshape(
            cfg.counts + (1, C)),
        jnp.asarray(st["sexcl"].numpy()).reshape(cfg.counts + (cfg.emax, C)),
        jnp.asarray(s["lam_c_nn"].numpy()), jnp.asarray(s["lam_v_nn"].numpy()),
        jnp.asarray(s["box"].numpy()), s["plan_t"].num_particles)
    f_j = np.asarray(f_j)
    fscale = np.abs(f_j).max() + 1.0
    np.testing.assert_allclose(forces.numpy(), f_j, atol=2e-4 * fscale)
    if energies:
        e_j = _slice_energies(np.stack([np.asarray(mc_j, np.float64),
                                        np.asarray(mv_j, np.float64)], 1),
                              nsub)
        e_t = _slice_energies(moments.numpy().astype(np.float64), nsub)
        np.testing.assert_allclose(e_t, e_j,
                                   atol=2e-4 * (np.abs(e_j).max() + 1.0))


@pytest.mark.parametrize("switching", [False, True])
@pytest.mark.parametrize("ewald", [False, True])
def test_plain_pair_f64_matches_all_pairs_oracle(ewald, switching):
    s = _slots(switching, torch.float64)
    plan_j = s["plan_j"]
    cfg = _pair_cfg(s["cfg"], ewald, s["plan_t"])
    st = s["st"]
    forces, moments = cuda_direct.pair_column(
        s["slot_pos"], st["slot_par"], st["slot_sub"], st["table"],
        st["sexcl"], s["lam_c_nn"], s["lam_v_nn"], s["box"], cfg, True,
        s["plan_t"].num_particles)
    f_t = forces.transpose(1, 2).reshape(-1, 3)[st["inv_slots"]].numpy()
    e_t = _slice_energies(moments.numpy(), cfg.nsub)

    data_j = {k: jnp.asarray(v) for k, v in s["data_np"].items()}
    gvals = jnp.asarray([GVAL], jnp.float64)
    charge, sig_half, eps2 = jparams.particle_params(data_j, gvals)
    lam = jparams.slice_lambdas(plan_j.lam_source, gvals)
    oracle = jdirect.make_direct_space(
        mode=jdirect.EWALD_DIRECT if ewald else jdirect.CUTOFF, periodic=True,
        cutoff=cfg.cutoff, krf=cfg.krf, crf=cfg.crf,
        use_switch=cfg.use_switch, switch_distance=cfg.switch_distance,
        ewald_alpha=cfg.ewald_alpha, num_slices=plan_j.num_slices)
    e_o, f_o = oracle(jnp.asarray(s["positions"]), jnp.asarray(plan_j.box0),
                      charge, sig_half, eps2, data_j["subsets"],
                      data_j["exclusion_list"], plan_j.slice_table,
                      lam[:, 0], lam[:, 1])
    f_o = np.asarray(f_o)
    e_o = np.asarray(e_o)
    np.testing.assert_allclose(f_t, f_o, rtol=0,
                               atol=1e-6 * np.abs(f_o).max())
    np.testing.assert_allclose(e_t, e_o, rtol=0,
                               atol=1e-6 * (np.abs(e_o).max() + 1.0))


def oracle_direct_space(arrays, positions):
    """(slice energies (S, 2), forces (N, 3)) of a hard-shape case from the
    JAX all-pairs direct-space function (exact erfc; LJPME's dispersion
    terms where the case has them), in float64."""
    cfg = arrays["cfg"]
    ewald = cfg.mode == cuda_direct.MODE_EWALD
    nsub = cfg.nsub
    oracle = jdirect.make_direct_space(
        mode=jdirect.EWALD_DIRECT if ewald else jdirect.CUTOFF, periodic=True,
        cutoff=cfg.cutoff, krf=cfg.krf, crf=cfg.crf,
        use_switch=cfg.use_switch, switch_distance=cfg.switch_distance,
        ewald_alpha=cfg.ewald_alpha, ljpme=cfg.ljpme,
        dispersion_alpha=cfg.dispersion_alpha,
        num_slices=nsub * (nsub + 1) // 2)
    e_o, f_o = oracle(
        jnp.asarray(positions), jnp.asarray(arrays["box"]),
        jnp.asarray(arrays["charge"]), jnp.asarray(arrays["sig_half"]),
        jnp.asarray(arrays["eps2"]), jnp.asarray(arrays["subsets"]),
        jnp.asarray(arrays["exclusion_list"]), arrays["slice_table"],
        jnp.asarray(arrays["lam_c"]), jnp.asarray(arrays["lam_v"]))
    return np.asarray(e_o), np.asarray(f_o)


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_plain_pair_f64_hard_shapes_match_all_pairs_oracle(case):
    arrays = pair_case_arrays(case)
    cfg = arrays["cfg"]
    n = arrays["charge"].shape[0]
    slots = pair_case_slots(arrays, False, "cpu", torch.float64)
    forces, moments = cuda_direct.pair_column(*slots["args"], True, n)
    f_t = forces.transpose(1, 2).reshape(-1, 3)[slots["inv_slots"]].numpy()
    e_t = _slice_energies(moments.numpy(), cfg.nsub)
    e_o, f_o = oracle_direct_space(arrays, arrays["wrapped"])
    assert np.abs(f_o).max() > 1.0
    # the erfc polynomial's budget; 1e-9 relative for the float64 sums
    f_budget, e_budget = erfc_budget(arrays)
    assert f_budget.max() <= 1e-3 * np.abs(f_o).max()
    assert np.all(np.abs(f_t - f_o) <= f_budget + 1e-9 * np.abs(f_o).max())
    np.testing.assert_allclose(
        e_t, e_o, rtol=0, atol=e_budget + 1e-9 * (np.abs(e_o).max() + 1.0))
    # pad rows get no force
    pads = (slots["args"][3] >= n)[:, None, :].expand_as(forces)
    assert not forces[pads].any()
