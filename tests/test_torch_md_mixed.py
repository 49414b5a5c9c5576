"""Port make_md_step(mixed_precision=True) vs the JAX package's ``mixed`` on
a solute-like system: the 12-site chain of port_systems.py in a 3 nm box
of 216 waters, with harmonic bonds on its 1-3 pairs and constraints on its
1-2 pairs (clusters that are not water triangles), so that every
constraint, the waters' included, goes through the gather M-SHAKE solver.
The JAX package runs double-single positions and local-frame projectors;
the port float64 positions and a float64 solve.  Bounds of
tests/test_torch_md.py::test_md_mixed_matches_jax: positions to 1e-4 nm
over 10 steps, the energy to 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import plan as jplan
from nonbondedslicing_tpu.runtime.fastpath import make_md_step as jax_md_step

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime.constraints import \
    cluster_constraints
from nonbondedslicing_tpu_torch.runtime.fastpath import make_md_step

from port_systems import BOND_R0, KB, SOLUTE_SITES, chain_constraints
from tests.test_torch_md import SOLUTE_BOX, _solute_box
from tests.test_torch_plan import jax_data_np

torch.set_num_threads(2)

STEPS = 10


def _constrained_chain(out):
    """The solute box with the chain's 1-2 pairs as constraints (added to
    the water triangles, as one cluster list) and its 1-3 pairs as
    harmonic bonds."""
    system, force, positions, masses, constraints, bonds, _ = out
    triples, bonds = chain_constraints(constraints, bonds)
    return (system, force, positions, masses,
            cluster_constraints(triples, len(masses)), bonds)


def test_md_mixed_solute_matches_jax():
    system_j, force_j, positions, masses, constraints, bonds = \
        _constrained_chain(_solute_box(nbs))
    system_t, force_t, positions_t, _, _, _ = \
        _constrained_chain(_solute_box(nbt))
    np.testing.assert_array_equal(positions, positions_t)
    plan_j = jplan.build_plan(force_j, system_j)
    plan_t = tplan.build_plan(force_t, system_t)
    assert constraints[0].shape[1] > 3 and len(bonds) == SOLUTE_SITES - 2
    rng = np.random.default_rng(11)
    vel = (rng.normal(size=positions.shape)
           * np.sqrt(KB * 300.0 / masses)[:, None])
    box = np.diag([SOLUTE_BOX] * 3)
    gvals = plan_t.global_defaults

    run_t = make_md_step(plan_t, masses, dt=0.002, dtype=torch.float32,
                         constraints=constraints, bonds=bonds, reuse_steps=2,
                         mixed_precision=True)
    assert run_t.config["mixed_precision"] is True
    p_t, v_t, e_t = run_t(positions, vel, box, gvals,
                          tengine.plan_data(plan_t, device="cpu",
                                            dtype=torch.float32), STEPS)
    assert p_t.dtype == torch.float64 and v_t.dtype == torch.float32

    run_j = jax_md_step(plan_j, masses, dt=0.002, dtype=jnp.float32,
                        constraints=constraints, bonds=bonds, reuse_steps=2,
                        mixed_precision=True)
    data_j = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
              for k, v in jax_data_np(plan_j).items()}
    p_j, v_j, e_j = run_j(jnp.asarray(positions, jnp.float32),
                          jnp.asarray(vel, jnp.float32),
                          jnp.asarray(box, jnp.float32),
                          jnp.asarray(gvals, jnp.float32), data_j, STEPS)
    assert np.asarray(p_j).dtype == np.float64
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)
    # the chain's constraints hold in float64
    p = p_t.numpy()
    d = np.linalg.norm(p[1:SOLUTE_SITES] - p[:SOLUTE_SITES - 1], axis=1)
    assert np.abs(d - BOND_R0).max() < 1e-8
