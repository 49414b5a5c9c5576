"""Port generic engine (ops/engine.make_compute) vs the JAX package's on all
pairs (``neighbor="all_pairs"``), in float64 to 1e-10, for all six
nonbonded methods: exclusions, 1-4 exceptions, particle and exception
parameter offsets, three scaling parameters, the switch, the dispersion
correction, a triclinic PME box and two forces in one system; the twin of
tests/test_exclusion_rows.py::test_rows_match_generic_pass for the generic
exclusion corrections; and the port's own identities (split switches,
hoisted convolution kernels).  Cases picked from tests/test_direct.py,
test_reciprocal.py, test_slicing.py, test_two_forces.py and
test_exclusion_rows.py; both packages build the same system through their
own API and plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import bonded as jbonded
from nonbondedslicing_tpu.ops import engine as jengine
from nonbondedslicing_tpu.ops import plan as jplan

from nonbondedslicing_tpu_torch.ops import bonded as tbonded
from nonbondedslicing_tpu_torch.ops import engine as tengine
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.utils.indexing import slice_pair_table

from tests.test_torch_plan import jax_data_np

torch.set_num_threads(2)

TRICLINIC = ((3.0, 0.0, 0.0), (0.6, 3.0, 0.0), (-0.4, 0.5, 3.0))


def molecules(api, method, n_mol=40, seed=3, box=3.0, cutoff=1.0,
              switching=False, triclinic=False, periodic_exceptions=False,
              charge_scale=1.0):
    """Random 3-site molecules A-B-C in 3 subsets: A-B and B-C excluded,
    A-C a 1-4 exception (one with a parameter offset), a particle
    parameter offset on a few atoms, lambdas on slices (0, 1), (1, 2) and
    (2, 2), the dispersion correction.  Returns (system, force,
    positions)."""
    rng = np.random.default_rng(seed)
    vectors = (np.asarray(TRICLINIC) if triclinic
               else np.diag([box] * 3))
    system = api.System()
    system.setDefaultPeriodicBoxVectors(*[tuple(v) for v in vectors])
    force = api.SlicedNonbondedForce(3)
    force.setNonbondedMethod(method)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(5e-4)
    force.setUseDispersionCorrection(True)
    if switching:
        force.setUseSwitchingFunction(True)
        force.setSwitchingDistance(0.8 * cutoff)
    if periodic_exceptions:
        force.setExceptionsUsePeriodicBoundaryConditions(True)
    n = 3 * n_mol
    positions = np.empty((n, 3))
    centers = rng.random((n_mol, 3)) @ vectors
    for m in range(n_mol):
        for a in range(3):
            system.addParticle(12.0)
            force.addParticle(charge_scale * (0.4 - 0.3 * a) * (-1) ** m,
                              0.25 + 0.05 * a, 0.3 + 0.2 * rng.random())
            force.setParticleSubset(3 * m + a, (m + a) % 3)
            positions[3 * m + a] = centers[m] + rng.normal(scale=0.08,
                                                            size=3)
        o = 3 * m
        force.addException(o, o + 1, 0.0, 1.0, 0.0)
        force.addException(o + 1, o + 2, 0.0, 1.0, 0.0)
        force.addException(o, o + 2, -0.05 * charge_scale, 0.3, 0.2)
    force.addGlobalParameter("lamA", 0.7)
    force.addScalingParameter("lamA", 0, 1, True, True)
    force.addGlobalParameter("lamB", 0.4)
    force.addScalingParameter("lamB", 1, 2, True, False)
    force.addGlobalParameter("lamC", 0.9)
    force.addScalingParameter("lamC", 2, 2, False, True)
    force.addEnergyParameterDerivative("lamA")
    force.addEnergyParameterDerivative("lamC")
    force.addGlobalParameter("qoff", 0.3)
    for i in (0, 4, 9):
        force.addParticleParameterOffset("qoff", i, 0.2, 0.01, 0.05)
    force.addExceptionParameterOffset("qoff", 2, 0.1, 0.0, 0.05)
    system.addForce(force)
    return system, force, positions


def both(method_name, **kw):
    """(JAX plan, port plan, positions) of ``molecules``."""
    out_j = molecules(nbs, getattr(nbs.SlicedNonbondedForce, method_name),
                      **kw)
    out_t = molecules(nbt, getattr(nbt.SlicedNonbondedForce, method_name),
                      **kw)
    np.testing.assert_array_equal(out_j[2], out_t[2])
    return (jplan.build_plan(out_j[1], out_j[0]),
            tplan.build_plan(out_t[1], out_t[0]), out_j[2])


def gvals_of(plan):
    """Globals away from their defaults."""
    return 0.8 * np.asarray(plan.global_defaults) + 0.05


def run_jax(plan_j, positions, neighbor, dtype=np.float64, **kw):
    data = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in jax_data_np(plan_j).items()}
    box = (np.zeros((3, 3)) if plan_j.box0 is None
           else np.asarray(plan_j.box0))
    fn = jengine.make_compute(plan_j, True, True, neighbor=neighbor, **kw)
    e, f = fn(jnp.asarray(positions, dtype), jnp.asarray(box, dtype),
              jnp.asarray(gvals_of(plan_j), dtype), data)
    return np.asarray(e), np.asarray(f)


def port_inputs(plan_t, positions, dtype=torch.float64):
    box = (np.zeros((3, 3)) if plan_t.box0 is None
           else np.asarray(plan_t.box0))
    return (torch.as_tensor(positions).to(dtype),
            torch.as_tensor(box).to(dtype),
            torch.as_tensor(gvals_of(plan_t)).to(dtype),
            tengine.plan_data(plan_t, device="cpu", dtype=dtype))


def run_port(plan_t, positions, neighbor, include=(True, True), **kw):
    fn = tengine.make_compute(plan_t, *include, neighbor=neighbor,
                              with_aux=True, **kw)
    e, f, aux = fn(*port_inputs(plan_t, positions))
    return e.numpy(), f.numpy(), aux, fn


def assert_close(e_t, f_t, e_j, f_j, tol=1e-10):
    np.testing.assert_allclose(e_t, e_j, rtol=tol,
                               atol=tol * (np.abs(e_j).max() + 1.0))
    np.testing.assert_allclose(f_t, f_j, rtol=tol,
                               atol=tol * (np.abs(f_j).max() + 1.0))


CASES = {
    "NoCutoff": dict(),
    "CutoffNonPeriodic-switch": dict(switching=True),
    "CutoffPeriodic-switch-periodic-exceptions": dict(
        switching=True, periodic_exceptions=True),
    "Ewald": dict(),
    "PME-triclinic": dict(triclinic=True),
    "LJPME-switch": dict(switching=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_all_pairs_matches_jax(case):
    """Slice energies, forces and dE/dlambda to 1e-10 (float64), and the
    all-pairs route with overflow 0."""
    plan_j, plan_t, positions = both(case.split("-")[0], **CASES[case])
    e_t, f_t, aux, fn = run_port(plan_t, positions, "all_pairs")
    assert fn.route == "all_pairs" and int(aux["overflow"]) == 0
    assert aux["overflow"].dtype == torch.int32
    assert e_t.dtype == np.float64 and e_t.shape == (plan_t.num_slices, 2)
    e_j, f_j = run_jax(plan_j, positions, "all_pairs")
    assert_close(e_t, f_t, e_j, f_j)
    d_t = tengine.parameter_derivatives(torch.as_tensor(e_t),
                                        plan_t.deriv_mask).numpy()
    d_j = np.asarray(jengine.parameter_derivatives(jnp.asarray(e_j),
                                                   plan_j.deriv_mask))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-10,
                               atol=1e-10 * (np.abs(e_j).max() + 1.0))


def test_two_forces_match_jax():
    """Two forces in one system (Coulomb-heavy PME and LJ-heavy
    CutoffPeriodic), each evaluated by its own plan: both, and their sum,
    to 1e-10."""
    results = []
    for method, kw in (("PME", dict(seed=5)),
                       ("CutoffPeriodic", dict(seed=5, charge_scale=0.2))):
        plan_j, plan_t, positions = both(method, **kw)
        e_t, f_t, _, _ = run_port(plan_t, positions, "all_pairs")
        e_j, f_j = run_jax(plan_j, positions, "all_pairs")
        assert_close(e_t, f_t, e_j, f_j)
        results.append((e_t, f_t, e_j, f_j))
    assert_close(*(results[0][k] + results[1][k] for k in range(4)))


def test_split_switches_and_hoisted_eterm():
    """Direct space alone plus the reciprocal part alone is the full
    evaluation (LJPME), and the convolution kernels hoisted from
    plan.box0 give the per-call ones' result, to 1e-12."""
    _, plan_t, positions = both("LJPME", seed=7)
    e, f, _, _ = run_port(plan_t, positions, "all_pairs")
    e_d, f_d, _, _ = run_port(plan_t, positions, "all_pairs",
                              include=(True, False))
    e_r, f_r, _, _ = run_port(plan_t, positions, "all_pairs",
                              include=(False, True))
    assert np.abs(e_r).max() > 0 and np.abs(f_d).max() > 0
    assert_close(e_d + e_r, f_d + f_r, e, f, tol=1e-12)
    e_h, f_h, _, _ = run_port(plan_t, positions, "all_pairs",
                              hoist_eterm=True)
    assert_close(e_h, f_h, e, f, tol=1e-12)


def test_generic_exclusion_corrections_match_jax():
    """The twin of tests/test_exclusion_rows.py::test_rows_match_generic_pass:
    the port's generic corrections against the JAX package's on 80 random
    water-like triangles under LJPME terms (float64, 1e-10), and against the
    port's own row layout."""
    rng = np.random.default_rng(5)
    m = 80
    n = 3 * m
    positions = rng.random((n, 3)) * 3.0
    charge = rng.normal(size=n)
    sig_half = 0.1 + 0.2 * rng.random(n)
    eps2 = rng.random(n)
    subsets = rng.integers(0, 3, n)
    sl_tab = slice_pair_table(3)
    lam_c = rng.random(6)
    lam_v = rng.random(6)
    pairs = np.concatenate([np.stack([
        [3 * k, 3 * k + 1], [3 * k, 3 * k + 2], [3 * k + 1, 3 * k + 2]])
        for k in range(m)])
    box = np.diag([3.0, 3.0, 3.0])
    kw = dict(alpha=2.7, periodic_exceptions=False, ljpme=True,
              dispersion_alpha=2.0, num_slices=6, num_particles=n)
    e_j, f_j = jbonded.exclusion_corrections(
        jnp.asarray(positions), jnp.asarray(box), jnp.asarray(pairs),
        jnp.asarray(charge), jnp.asarray(sig_half), jnp.asarray(eps2),
        jnp.asarray(subsets, dtype=jnp.int32), jnp.asarray(sl_tab),
        jnp.asarray(lam_c), jnp.asarray(lam_v), **kw)
    t = torch.as_tensor
    e_t, f_t = tbonded.exclusion_corrections(
        t(positions), t(box), t(pairs), t(charge), t(sig_half), t(eps2),
        t(subsets), sl_tab, t(lam_c), t(lam_v), **kw)
    assert_close(e_t.numpy(), f_t.numpy(), np.asarray(e_j), np.asarray(f_j))
    sub3 = subsets.reshape(m, 3)
    pair_slices = np.stack([sl_tab[sub3[:, 0], sub3[:, 1]],
                            sl_tab[sub3[:, 0], sub3[:, 2]],
                            sl_tab[sub3[:, 1], sub3[:, 2]]], axis=1)
    e_r, f_r = tbonded.exclusion_corrections_rows(
        t(positions), t(charge), t(sig_half), t(eps2), t(pair_slices),
        t(lam_c), t(lam_v), alpha=2.7, ljpme=True, dispersion_alpha=2.0,
        num_slices=6)
    assert_close(e_r.numpy(), f_r.numpy(), e_t.numpy(), f_t.numpy())
