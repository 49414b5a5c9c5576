"""Port plan and parameter tensors vs the JAX package.

Also holds the system factories the other ``test_torch_*`` files share:
each takes the API module (``nonbondedslicing_tpu`` or
``nonbondedslicing_tpu_torch``) and builds the same system through it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import plan as jplan

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan

torch.set_num_threads(2)

D_OH, D_HH = 0.09572, 0.15139


def water_system(api, n_mol=150, box=4.8, seed=7, nsub=3):
    """Lattice of water-like triples whose exclusions are contiguous
    triangles (the fused engine's production layout); twin of
    tests/test_fused.py::_water_system plus a dE/dlambda request."""
    rng = np.random.default_rng(seed)
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(nsub)
    force.setNonbondedMethod(api.SlicedNonbondedForce.PME)
    force.setCutoffDistance(0.9)
    grid = int(np.ceil(n_mol ** (1 / 3)))
    sites = np.stack(np.meshgrid(*[np.arange(grid)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    sites = (sites[:n_mol] + 0.5) * (box / grid)
    positions = np.empty((3 * n_mol, 3))
    for m in range(n_mol):
        system.addParticle(16.0)
        system.addParticle(1.0)
        system.addParticle(1.0)
        force.addParticle(-0.8, 0.31, 0.6)
        force.addParticle(0.4, 0.1, 0.05)
        force.addParticle(0.4, 0.1, 0.05)
        o = sites[m] + rng.normal(scale=0.03, size=3)
        positions[3 * m] = o
        positions[3 * m + 1] = o + rng.normal(scale=0.06, size=3)
        positions[3 * m + 2] = o + rng.normal(scale=0.06, size=3)
        for a, b in ((0, 1), (0, 2), (1, 2)):
            force.addException(3 * m + a, 3 * m + b, 0.0, 1.0, 0.0)
        for a in range(3):
            force.setParticleSubset(3 * m + a, (m + a) % nsub)
    force.addGlobalParameter("lam01", 0.8)
    force.addScalingParameter("lam01", 0, 1, True, True)
    force.addEnergyParameterDerivative("lam01")
    system.addForce(force)
    return system, force, positions


def pair_system(api, method, n_mol=400, box=4.8, seed=2, nsub=3,
                switching=False, extras=False):
    """Random bonded pairs (one exclusion each); twin of
    tests/test_fused.py::_system.  ``extras`` adds 1-4 exceptions and
    particle / exception parameter offsets."""
    rng = np.random.default_rng(seed)
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(nsub)
    force.setNonbondedMethod(method)
    force.setCutoffDistance(0.9)
    if switching:
        force.setUseSwitchingFunction(True)
        force.setSwitchingDistance(0.75)
    n = 2 * n_mol
    positions = rng.random((n, 3)) * box
    for k in range(n_mol):
        system.addParticle(16.0)
        system.addParticle(1.0)
        force.addParticle(-0.5, 0.31, 0.6)
        force.addParticle(0.5, 0.1, 0.05)
        # keep the excluded pair bonded-range
        positions[2 * k + 1] = positions[2 * k] + rng.normal(scale=0.03,
                                                             size=3)
        force.addException(2 * k, 2 * k + 1, 0.0, 1.0, 0.0)
        force.setParticleSubset(2 * k, k % nsub)
        force.setParticleSubset(2 * k + 1, (k + 1) % nsub)
    force.addGlobalParameter("lam01", 0.8)
    force.addScalingParameter("lam01", 0, 1, True, True)
    force.addEnergyParameterDerivative("lam01")
    if extras:
        force.addGlobalParameter("qoff", 0.1)
        for k in range(0, n_mol - 1, 7):
            force.addException(2 * k + 1, 2 * k + 2, 0.05, 0.3, 0.2)
        force.addParticleParameterOffset("qoff", 3, 0.2, 0.01, 0.0)
        force.addExceptionParameterOffset("qoff", n_mol, 0.1, 0.0, 0.05)
    system.addForce(force)
    return system, force, positions


def water_box(api, n_mol=125, seed=3):
    """Rigid 3-site water lattice with SETTLE constraints; twin of
    tests/test_md_conservation.py::_water_box."""
    rng = np.random.default_rng(seed)
    n_atoms = 3 * n_mol
    box = float(np.cbrt(n_atoms / 100.2))
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(2)
    force.setNonbondedMethod(api.SlicedNonbondedForce.PME)
    force.setCutoffDistance(0.75)
    positions = np.zeros((n_atoms, 3))
    cons_p, cons_d = [], []
    m = int(round(n_mol ** (1 / 3)))
    sp = box / m
    for k in range(n_mol):
        iz, r = divmod(k, m * m)
        iy, ix = divmod(r, m)
        c = ((np.array([ix, iy, iz]) + 0.5) * sp
             + rng.uniform(-0.03, 0.03, 3) * sp)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        perp = np.cross(axis, rng.normal(size=3))
        perp /= np.linalg.norm(perp)
        half = D_HH / 2
        h = np.sqrt(D_OH ** 2 - half ** 2)
        o = 3 * k
        positions[o] = c
        positions[o + 1] = c + h * axis + half * perp
        positions[o + 2] = c + h * axis - half * perp
        system.addParticle(15.999)
        system.addParticle(1.008)
        system.addParticle(1.008)
        force.addParticle(-0.834, 0.3151, 0.6364)
        force.addParticle(0.417, 0.04, 0.192)
        force.addParticle(0.417, 0.04, 0.192)
        for a, b in ((o, o + 1), (o, o + 2), (o + 1, o + 2)):
            force.addException(a, b, 0, 1, 0)
        for a in range(3):
            force.setParticleSubset(o + a, k % 2)
        cons_p.append([[o, o + 1], [o, o + 2], [o + 1, o + 2]])
        cons_d.append([D_OH, D_OH, D_HH])
    force.addGlobalParameter("lam", 1.0)
    force.addScalingParameter("lam", 0, 1, True, True)
    system.addForce(force)
    masses = np.tile([15.999, 1.008, 1.008], n_mol)
    return system, force, positions, masses, (cons_p, cons_d), box


def both_plans(make_system, *args, **kwargs):
    """(JAX plan, port plan, positions) of one system built through both
    APIs."""
    out_j = make_system(nbs, *args, **kwargs)
    out_t = make_system(nbt, *args, **kwargs)
    np.testing.assert_array_equal(out_j[2], out_t[2])
    return (jplan.build_plan(out_j[1], out_j[0]),
            tplan.build_plan(out_t[1], out_t[0]), out_j[2])


def jax_data_np(plan_j):
    """The JAX package's parameter pytree as numpy arrays."""
    return {k: np.asarray(v) for k, v in jengine.plan_data(plan_j).items()}


CASES = {
    "water_pme": (water_system, (), {}),
    "pairs_rf_switch": (pair_system, (nbs.SlicedNonbondedForce.CutoffPeriodic,),
                        dict(switching=True)),
    "pairs_pme_extras": (pair_system, (nbs.SlicedNonbondedForce.PME,),
                         dict(extras=True)),
    "pairs_ljpme": (pair_system, (nbs.SlicedNonbondedForce.LJPME,), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_plan_matches_jax(case):
    make_system, args, kwargs = CASES[case]
    plan_j, plan_t, _ = both_plans(make_system, *args, **kwargs)
    for field in dataclasses.fields(plan_j):
        a = getattr(plan_j, field.name)
        b = getattr(plan_t, field.name)
        if field.name == "dispersion_coefficients":
            # the JAX package may sum class pairs in its native C++ helper;
            # the switched integral cancels to ~1e-10 relative in f64
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
        elif isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        elif isinstance(a, np.ndarray) or a is None:
            np.testing.assert_array_equal(b, a, err_msg=field.name)
        else:
            assert b == a, field.name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_data_and_data_from_numpy(dtype):
    plan_j, plan_t, _ = both_plans(pair_system,
                                   nbs.SlicedNonbondedForce.PME, extras=True)
    from_jax = tengine.data_from_numpy(jax_data_np(plan_j), device="cpu",
                                       dtype=dtype)
    own = tengine.plan_data(plan_t, dtype=dtype)
    assert set(from_jax) == set(own) == set(tengine.DATA_KEYS)
    for key, ref in jax_data_np(plan_j).items():
        for t in (from_jax[key], own[key]):
            if ref.dtype.kind == "f":
                assert t.dtype == dtype
                if key == "dispersion_coefficients":
                    np.testing.assert_allclose(t.numpy(), ref.astype(
                        t.numpy().dtype), rtol=1e-6 if dtype == torch.float32
                        else 1e-9)
                else:
                    np.testing.assert_array_equal(t.numpy(),
                                                  ref.astype(t.numpy().dtype))
            else:
                assert t.dtype == torch.int64
                np.testing.assert_array_equal(t.numpy(), ref)


def test_energy_contractions_match_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    plan_j, plan_t, _ = both_plans(pair_system,
                                   nbs.SlicedNonbondedForce.PME, extras=True)
    se = rng.normal(size=(plan_t.num_slices, 2)) * 100.0
    lam = rng.random((plan_t.num_slices, 2))
    e_t = tengine.contract_energy(torch.as_tensor(se), torch.as_tensor(lam))
    e_j = jengine.contract_energy(jnp.asarray(se), jnp.asarray(lam))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-14)
    d_t = tengine.parameter_derivatives(torch.as_tensor(se),
                                        plan_t.deriv_mask)
    d_j = jengine.parameter_derivatives(jnp.asarray(se), plan_j.deriv_mask)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-14)


@pytest.mark.parametrize("grid,counts", [((60, 60, 60), (6, 6, 6)),
                                         ((44, 45, 27), (5, 5, 3))])
def test_grid_sizing_matches_jax(grid, counts):
    from nonbondedslicing_tpu.ops import pme_bricks as jbricks
    from nonbondedslicing_tpu_torch.ops import pme_bricks as tbricks
    aligned = tbricks.aligned_grid(grid, counts)
    assert aligned == jbricks.aligned_grid(grid, counts)
    assert tbricks.brick_window(aligned, counts) == jbricks.brick_window(
        aligned, counts)
