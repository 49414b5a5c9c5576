"""Port slot table (prepare) equal to the bit to the JAX fused engine's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import fused as jfused

from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import fused as tfused

from tests.test_torch_plan import both_plans, jax_data_np, pair_system, \
    water_system

torch.set_num_threads(2)


def _prepare_both(plan_j, plan_t, positions, gval, **engine_kw):
    data_np = jax_data_np(plan_j)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in data_np.items()}
    box = np.asarray(plan_j.box0, np.float32)
    prep_j, _, cfg_j = jfused.make_fused_engine(plan_j, interpret=True,
                                                **engine_kw)
    st_j = prep_j(jnp.asarray(positions, jnp.float32), jnp.asarray(box),
                  jnp.asarray([gval], jnp.float32), data_j)
    prep_t, _, cfg_t = tfused.make_fused_engine(plan_t, **engine_kw)
    data_t = tengine.data_from_numpy(data_np, device="cpu",
                                     dtype=torch.float32)
    st_t = prep_t(torch.as_tensor(positions, dtype=torch.float32),
                  torch.as_tensor(box), torch.tensor([gval]), data_t)
    for key in ("counts", "capacity", "skin", "bricks"):
        assert cfg_t[key] == cfg_j[key], key
    return st_j, st_t


@pytest.mark.parametrize("case", ["water_pme", "pairs_rf"])
def test_slot_table_matches_jax(case):
    if case == "water_pme":
        plan_j, plan_t, positions = both_plans(water_system)
        kw = dict(cell_capacity=32)
    else:
        plan_j, plan_t, positions = both_plans(
            pair_system, nbs.SlicedNonbondedForce.CutoffPeriodic)
        kw = {}
    st_j, st_t = _prepare_both(plan_j, plan_t, positions, 0.8, **kw)
    assert int(st_t["overflow"]) == int(st_j["overflow"]) == 0
    np.testing.assert_array_equal(st_t["table"].numpy(),
                                  np.asarray(st_j["table"]))
    np.testing.assert_array_equal(st_t["inv_slots"].numpy(),
                                  np.asarray(st_j["inv_slots"]))
    np.testing.assert_array_equal(st_t["sexcl"].numpy(),
                                  np.asarray(st_j["sexcl"]))
    np.testing.assert_array_equal(st_t["padfix3"].numpy(),
                                  np.asarray(st_j["padfix3"]))
    np.testing.assert_array_equal(st_t["pos0w"].numpy(),
                                  np.asarray(st_j["pos0w"]))
    # per-slot charge, sigma/2, 2 sqrt(eps) are the JAX feature rows 0-2
    np.testing.assert_array_equal(st_t["slot_par"].numpy(),
                                  np.asarray(st_j["sfeat"])[:, :3])
    oh = np.asarray(st_j["sfeat"])[:, 3:]
    real = st_t["table"].numpy() < plan_t.num_particles
    np.testing.assert_array_equal(st_t["slot_sub"].numpy()[real],
                                  np.argmax(oh, axis=1)[real])


def test_overflow_count_matches_jax():
    """Cramming atoms into one corner reports the same dropped count."""
    plan_j, plan_t, _ = both_plans(
        pair_system, nbs.SlicedNonbondedForce.CutoffPeriodic, n_mol=300)
    positions = np.random.default_rng(0).random((600, 3)) * 0.4
    st_j, st_t = _prepare_both(plan_j, plan_t, positions, 0.8)
    assert int(st_t["overflow"]) == int(st_j["overflow"]) > 0
    np.testing.assert_array_equal(st_t["table"].numpy(),
                                  np.asarray(st_j["table"]))
