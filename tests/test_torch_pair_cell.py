"""Min-image cell pair kernel (B4) plain twin vs the JAX package.

The system is the PME dimer box of ``test_torch_plan.pair_system``: one
exclusion per dimer, so the fused engine takes the cell kernel with the
Ewald exclusion corrections fused in.  ``periodic`` sets
``setExceptionsUsePeriodicBoundaryConditions`` and moves the second atom of
every fifth dimer by one box vector, so that the unwrapped and the
minimum-image deltas of those excluded pairs differ.

* float32: against ``pallas_direct.make_pallas_cell_kernel`` in interpret
  mode, fed by the JAX fused engine's own prepare state
  (``fused.make_fused_engine(plan, interpret=True)``), at the fused
  engine's 2e-4 scaled budget (tests/test_fused.py:66-71).
* float64: against the JAX all-pairs engine
  (``engine.make_compute(..., neighbor="all_pairs")``, exact erfc and erf,
  which includes the exclusion corrections) at 1e-6 of max|F|: the A&S
  7.1.26 polynomial's ~1.5e-7 absolute error, as in test_torch_fused.py.
  The hard shapes of tests/torch_pair_cases.py (the ones the CUDA kernel is
  held to on the card) go through the JAX all-pairs direct-space function
  plus ``bonded.exclusion_corrections``, each atom at the budget the
  polynomial gives its own pairs (``torch_pair_cases.erfc_budget``, below
  1e-3 of max|F| in every case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import bonded as jbonded
from nonbondedslicing_tpu.ops import direct as jdirect
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import fused as jfused
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.ops.pallas_direct import (HALF_OFFSETS,
                                                    make_pallas_cell_kernel)

from nonbondedslicing_tpu_torch.ops import cuda_direct
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused
from nonbondedslicing_tpu_torch.ops import params as tparams
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.utils.constants import ONE_4PI_EPS0

from tests.test_torch_pair import _slice_energies, oracle_direct_space
from tests.test_torch_plan import jax_data_np, pair_system
from torch_pair_cases import (PAIR_CASES, erfc_budget,
                              pair_case_arrays, pair_case_slots)

torch.set_num_threads(2)

GVAL = 0.8
CAPACITY = 32
BOX = 3.0


def _plans(periodic):
    """(JAX plan, port plan, positions) of the (3, 3, 3)-cell dimer box."""
    plans = []
    for api, plan_mod in ((nbs, jplan), (nbt, tplan)):
        system, force, positions = pair_system(
            api, api.SlicedNonbondedForce.PME, n_mol=100, box=BOX)
        force.setExceptionsUsePeriodicBoundaryConditions(periodic)
        plans.append(plan_mod.build_plan(force, system))
    if periodic:
        positions = positions.copy()
        positions[1::10, 0] += BOX
    return plans[0], plans[1], positions


def _port_slots(plan_t, data_np, positions, dtype, energies):
    """The port's slot tensors and ``pair_cell`` call, as ``apply`` makes
    them."""
    data = tengine.data_from_numpy(data_np, device="cpu", dtype=dtype)
    prep, _, cfg = tfused.make_fused_engine(plan_t, cell_capacity=CAPACITY,
                                            energies=energies)
    pc = cfg["pair"]
    assert pc.counts == (3, 3, 3)
    pos = torch.as_tensor(positions).to(dtype)
    box = torch.as_tensor(np.asarray(plan_t.box0)).to(dtype)
    gvals = torch.tensor([GVAL], dtype=dtype)
    st = prep(pos, box, gvals, data)
    assert int(st["overflow"]) == 0
    g, C = pc.n_cells, pc.capacity
    slot_pos = (torch.cat([pos, pos.new_zeros((1, 3))])[st["slots"]]
                .reshape(g, C, 3).transpose(1, 2) + st["padfix3"]).contiguous()
    lam = tparams.slice_lambdas(plan_t.lam_source, gvals)
    sl_tab = torch.as_tensor(plan_t.slice_table, dtype=torch.int64)
    forces, moments = cuda_direct.pair_cell(
        slot_pos, st["slot_par"], st["slot_sub"], st["table"], st["sexcl"],
        lam[:, 0][sl_tab].contiguous(), lam[:, 1][sl_tab].contiguous(), box,
        pc, energies, plan_t.num_particles)
    return forces, moments, st, pc


def _jax_cell_kernel(plan_j, positions, energies):
    """Slot forces (cells, 3, C) and per-tile moments of the JAX cell
    kernel, assembled as the JAX fused engine's apply assembles them."""
    prep, _, cfg = jfused.make_fused_engine(
        plan_j, interpret=True, energies=energies, cell_capacity=CAPACITY)
    counts, C = cfg["counts"], cfg["capacity"]
    n = plan_j.num_particles
    g = int(np.prod(counts))
    data = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    pos = jnp.asarray(positions, jnp.float32)
    box = jnp.asarray(plan_j.box0, jnp.float32)
    gvals = jnp.asarray([GVAL], jnp.float32)
    st = prep(pos, box, gvals, data)
    assert "cand_static" in st      # the cell kernel's layout, not B1's
    kernel = make_pallas_cell_kernel(
        mode=jdirect.EWALD_DIRECT, cutoff=plan_j.cutoff, counts=counts,
        capacity=C, nsub=plan_j.num_subsets,
        emax=plan_j.exclusion_list.shape[1], ewald_alpha=plan_j.ewald_alpha,
        interpret=True, exceptions_periodic=plan_j.exceptions_periodic,
        fuse_exclusions=True, images_preshifted=False,
        compute_energies=energies, assume_pads_far=False)
    pos_p = jnp.concatenate([pos, jnp.zeros((1, 3), jnp.float32)])
    pos_fm = (jnp.swapaxes(pos_p[st["slots"]].reshape(g, C, 3), 1, 2)
              + st["padfix3"])
    grid_pos = pos_fm.reshape(counts + (3, C))
    cand_pos = jnp.concatenate(
        [jnp.roll(grid_pos, (-dx, -dy, -dz), axis=(0, 1, 2)).reshape(g, 3, C)
         for (dx, dy, dz) in HALF_OFFSETS], axis=2)
    from nonbondedslicing_tpu.ops.params import slice_lambdas
    lam = slice_lambdas(plan_j.lam_source, gvals)
    sl_tab = jnp.asarray(plan_j.slice_table)
    (row_f, col_f, m_c, m_v), _ = kernel(
        jnp.concatenate([pos_fm, st["sfeat"]], axis=1), st["table"],
        st["sexcl"], jnp.concatenate([cand_pos, st["cand_static"]], axis=1),
        st["cand_idx"], lam[:, 0][sl_tab], lam[:, 1][sl_tab], box, n)
    # roll the per-offset column forces back onto their home cells
    slot_f = row_f[:g].reshape(counts + (3, C))
    col_g = col_f[:g].reshape(counts + (3, 14, C))
    for k, (dx, dy, dz) in enumerate(HALF_OFFSETS):
        slot_f = slot_f + jnp.roll(col_g[:, :, :, :, k], (dx, dy, dz),
                                   axis=(0, 1, 2))
    moments = np.stack([np.asarray(m_c, np.float64),
                        np.asarray(m_v, np.float64)], 1)
    return np.asarray(slot_f).reshape(g, 3, C), moments


@pytest.mark.parametrize("energies", [True, False])
@pytest.mark.parametrize("periodic", [False, True])
def test_plain_pair_cell_matches_pallas_cell_kernel(periodic, energies):
    plan_j, plan_t, positions = _plans(periodic)
    assert plan_t.exceptions_periodic == periodic
    forces, moments, _, pc = _port_slots(plan_t, jax_data_np(plan_j),
                                         positions, torch.float32, energies)
    assert (moments is None) == (not energies)
    f_j, m_j = _jax_cell_kernel(plan_j, positions, energies)
    np.testing.assert_allclose(forces.numpy(), f_j,
                               atol=2e-4 * (np.abs(f_j).max() + 1.0))
    if energies:
        e_j = _slice_energies(m_j, pc.nsub)
        e_t = _slice_energies(moments.numpy().astype(np.float64), pc.nsub)
        np.testing.assert_allclose(e_t, e_j,
                                   atol=2e-4 * (np.abs(e_j).max() + 1.0))


@pytest.mark.parametrize("periodic", [False, True])
def test_plain_pair_cell_f64_matches_all_pairs_oracle(periodic):
    plan_j, plan_t, positions = _plans(periodic)
    data_np = jax_data_np(plan_j)
    forces, moments, st, pc = _port_slots(plan_t, data_np, positions,
                                          torch.float64, True)
    f_t = forces.transpose(1, 2).reshape(-1, 3)[st["inv_slots"]].numpy()
    e_t = _slice_energies(moments.numpy(), pc.nsub)

    # direct space + exclusion corrections (no 1-4 exceptions in this
    # system); the dispersion correction is not the kernel's
    oracle = jengine.make_compute(plan_j, True, False, neighbor="all_pairs")
    data_j = {k: jnp.asarray(v) for k, v in data_np.items()}
    box = np.asarray(plan_j.box0)
    e_o, f_o = oracle(jnp.asarray(positions), jnp.asarray(box),
                      jnp.asarray([GVAL], jnp.float64), data_j)
    e_o = np.asarray(e_o).copy()
    e_o[:, 1] -= data_np["dispersion_coefficients"] / np.prod(np.diag(box))
    f_o = np.asarray(f_o)
    np.testing.assert_allclose(f_t, f_o, rtol=0,
                               atol=1e-6 * np.abs(f_o).max())
    # energies: the polynomial's 1.5e-7 absolute error in erfc (pairs within
    # the cutoff) and in erf (excluded pairs), times k |q_i q_j| / r
    q = plan_j.base_params[:, 0]
    d = positions[:, None] - positions[None, :]
    r = np.linalg.norm(d - np.diag(box) * np.round(d / np.diag(box)), axis=-1)
    near = (r < plan_j.cutoff) & (r > 0)
    ex = plan_j.exclusion_pairs
    near[ex[:, 0], ex[:, 1]] = near[ex[:, 1], ex[:, 0]] = True
    bound = 1.5e-7 * ONE_4PI_EPS0 * np.sum(
        np.abs(q[:, None] * q[None, :])[near] / r[near]) / 2
    np.testing.assert_allclose(e_t, e_o, rtol=0, atol=bound)


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_plain_pair_cell_f64_hard_shapes_match_all_pairs_oracle(case):
    arrays = pair_case_arrays(case)
    cfg = arrays["cfg"]
    n = arrays["charge"].shape[0]
    slots = pair_case_slots(arrays, True, "cpu", torch.float64)
    forces, moments = cuda_direct.pair_cell(*slots["args"], True, n)
    f_t = forces.transpose(1, 2).reshape(-1, 3)[slots["inv_slots"]].numpy()
    e_t = _slice_energies(moments.numpy(), cfg.nsub)

    # raw positions: some atoms sit in other images of the box
    e_o, f_o = oracle_direct_space(arrays, arrays["raw"])
    if cfg.mode == cuda_direct.MODE_EWALD:
        e_x, f_x = jbonded.exclusion_corrections(
            jnp.asarray(arrays["raw"]), jnp.asarray(arrays["box"]),
            jnp.asarray(arrays["exclusion_pairs"]),
            jnp.asarray(arrays["charge"]), jnp.asarray(arrays["sig_half"]),
            jnp.asarray(arrays["eps2"]), jnp.asarray(arrays["subsets"]),
            arrays["slice_table"], jnp.asarray(arrays["lam_c"]),
            jnp.asarray(arrays["lam_v"]), alpha=cfg.ewald_alpha,
            periodic_exceptions=cfg.exceptions_periodic, ljpme=False,
            dispersion_alpha=0.0, num_slices=e_o.shape[0], num_particles=n)
        e_o = e_o + np.asarray(e_x)
        f_o = f_o + np.asarray(f_x)
    assert np.abs(f_o).max() > 1.0
    # the erfc polynomial's budget; 1e-9 relative for the float64 sums
    f_budget, e_budget = erfc_budget(arrays)
    assert f_budget.max() <= 1e-3 * np.abs(f_o).max()
    assert np.all(np.abs(f_t - f_o) <= f_budget + 1e-9 * np.abs(f_o).max())
    np.testing.assert_allclose(
        e_t, e_o, rtol=0, atol=e_budget + 1e-9 * (np.abs(e_o).max() + 1.0))
    pads = (slots["args"][3] >= n)[:, None, :].expand_as(forces)
    assert not forces[pads].any()
