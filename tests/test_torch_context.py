"""The port's Context against the JAX package's on the CPU.

The same System through both APIs, the JAX Context on its Reference
platform (float64) and the port's on ``Reference`` with the platform
property ``"Device": "cpu"``: ``getState`` energies, forces and dE/dlambda
for all six methods, force groups and the reciprocal-space group,
``setParameter`` and ``updateParametersInContext`` (charge, sigma,
epsilon and an offset), the PME parameters in context, two forces in one
System, a runtime box change; and on the port alone ``enforcePeriodicBox``,
the box guards, the Platform surface and the excluded-pair span guard.
Every float64 evaluation of both packages runs exact arithmetic (all
pairs below 1,024 atoms, the exact erfc), so they agree to 1e-10.
"""

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt

from tests.test_torch_plan import pair_system, water_system

torch.set_num_threads(2)

TOL = 1e-10
CPU = {"Device": "cpu"}


def _contexts(make_system, *args, **kwargs):
    """One JAX and one port Reference Context of the same system, at the
    system's positions; returns them and both forces."""
    out = []
    for api in (nbs, nbt):
        system, force, positions = make_system(api, *args, **kwargs)
        ref = api.Platform.getPlatformByName("Reference")
        ctx = api.Context(system, api.VerletIntegrator(0.001), ref,
                          CPU if api is nbt else None)
        ctx.setPositions(positions)
        out.append((ctx, force))
    return out


def _state(ctx, **kw):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True, **kw)
    return (st.getPotentialEnergy(), np.asarray(st.getForces()),
            st.getEnergyParameterDerivatives())


def _assert_same(ctx_j, ctx_t, **kw):
    e_j, f_j, d_j = _state(ctx_j, **kw)
    e_t, f_t, d_t = _state(ctx_t, **kw)
    assert abs(e_t - e_j) <= TOL * max(abs(e_j), 1.0), (e_t, e_j)
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=TOL * max(np.abs(f_j).max(), 1.0))
    assert d_t.keys() == d_j.keys()
    for name in d_j:
        assert abs(d_t[name] - d_j[name]) <= TOL * max(abs(e_j), 1.0)
    return e_t


@pytest.mark.parametrize("method", range(6))
def test_get_state_matches_jax(method):
    """The dimer system (1-4 exceptions and offsets, excluded pairs 0.1 nm
    apart: closer, LJPME's dispersion back-out of an excluded pair
    cancels) in a 3 nm box under each method; under the Ewald family with
    the reciprocal part in its own force group: direct and reciprocal
    alone, and their sum against the whole."""
    (ctx_j, f_j), (ctx_t, f_t) = _contexts(pair_system, method, n_mol=100,
                                           box=3.0, extras=True, bond=0.1)
    e_all = _assert_same(ctx_j, ctx_t)
    if method >= nbs.SlicedNonbondedForce.Ewald:
        for ctx, force in ((ctx_j, f_j), (ctx_t, f_t)):
            force.setReciprocalSpaceForceGroup(1)
            ctx.reinitialize(preserveState=True)
        e_dir = _assert_same(ctx_j, ctx_t, groups={0})
        e_rec = _assert_same(ctx_j, ctx_t, groups=1 << 1)
        assert abs(e_dir + e_rec - e_all) <= TOL * abs(e_all)
        assert ctx_t.getState(getEnergy=True,
                              groups=1 << 2).getPotentialEnergy() == 0.0


def test_parameters_and_updates_match_jax():
    """A lambda, then a charge, a sigma, an epsilon and an offset's scale
    changed and pushed with updateParametersInContext, on the dimer system
    with 1-4 exceptions and offsets under PME."""
    (ctx_j, f_j), (ctx_t, f_t) = _contexts(
        pair_system, nbs.SlicedNonbondedForce.PME, n_mol=100, box=3.0,
        extras=True)
    for ctx in (ctx_j, ctx_t):
        ctx.setParameter("lam01", 0.3)
        ctx.setParameter("qoff", -0.4)
    _assert_same(ctx_j, ctx_t)
    for force in (f_j, f_t):
        q, sig, eps = force.getParticleParameters(5)
        force.setParticleParameters(5, q * 1.5, sig * 1.1, eps * 0.7)
        force.setParticleParameterOffset(0, "qoff", 3, 0.35, 0.02, 0.01)
    data = ctx_t._compiled[id(f_t)].data
    ptrs = {k: v.data_ptr() for k, v in data.items()}
    e_before = ctx_t.getState(getEnergy=True).getPotentialEnergy()
    for ctx, force in ((ctx_j, f_j), (ctx_t, f_t)):
        force.updateParametersInContext(ctx)
    e_after = _assert_same(ctx_j, ctx_t)
    assert e_after != e_before
    # the new values went into the same tensors
    assert {k: v.data_ptr() for k, v in data.items()} == ptrs
    with pytest.raises(nbt.OpenMMException):
        ctx_t.setParameter("nope", 1.0)
    assert ctx_t.getParameters() == ctx_j.getParameters()


def test_pme_parameters_in_context():
    (ctx_j, f_j), (ctx_t, f_t) = _contexts(
        water_system, n_mol=100, box=3.0,
        method=nbs.SlicedNonbondedForce.LJPME)
    assert f_t.getPMEParametersInContext(ctx_t) == \
        f_j.getPMEParametersInContext(ctx_j)
    assert f_t.getLJPMEParametersInContext(ctx_t) == \
        f_j.getLJPMEParametersInContext(ctx_j)
    (_, _), (ctx_t, f_t) = _contexts(water_system, n_mol=100, box=3.0,
                                     method=nbs.SlicedNonbondedForce.Ewald)
    with pytest.raises(nbt.OpenMMException, match="PME"):
        f_t.getPMEParametersInContext(ctx_t)


def _two_forces(api):
    """Twin of tests/test_two_forces.py::test_two_forces: two forces in
    groups 0 and 1, a HarmonicBondForce in group 2."""
    system = api.System()
    for _ in range(3):
        system.addParticle(1.0)
    nb1 = api.SlicedNonbondedForce(1)
    nb1.addParticle(-1.5, 1.0, 1.2)
    nb1.addParticle(0.5, 1.0, 1.0)
    nb1.addParticle(0.2, 0.8, 0.4)
    system.addForce(nb1)
    nb2 = api.SlicedNonbondedForce(1)
    nb2.addParticle(0.4, 1.4, 0.5)
    nb2.addParticle(0.3, 1.8, 1.0)
    nb2.addParticle(-0.1, 1.2, 0.6)
    nb2.setForceGroup(1)
    system.addForce(nb2)
    bonds = api.HarmonicBondForce()
    bonds.addBond(0, 2, 1.2, 300.0)
    bonds.setForceGroup(2)
    system.addForce(bonds)
    positions = np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0],
                          [0.3, 1.1, 0.2]])
    return system, nb1, positions


def test_two_forces_match_jax():
    (ctx_j, nb1_j), (ctx_t, nb1_t) = _contexts(_two_forces)
    parts = [_assert_same(ctx_j, ctx_t, groups=1 << g) for g in range(3)]
    e_all = _assert_same(ctx_j, ctx_t)
    assert abs(sum(parts) - e_all) <= TOL * abs(e_all)
    for ctx, force in ((ctx_j, nb1_j), (ctx_t, nb1_t)):
        force.setParticleParameters(0, -1.2, 1.1, 1.4)
        force.updateParametersInContext(ctx)
    _assert_same(ctx_j, ctx_t, groups=1 << 0)


def test_runtime_box_change_matches_jax():
    """PME with a runtime box 5% larger than the default box, as the JAX
    Context evaluates it (the convolution follows the runtime box)."""
    (ctx_j, _), (ctx_t, _) = _contexts(water_system, n_mol=100, box=3.0)
    for ctx in (ctx_j, ctx_t):
        ctx.setPeriodicBoxVectors((3.15, 0, 0), (0, 3.15, 0), (0, 0, 3.15))
    _assert_same(ctx_j, ctx_t)
    assert ctx_t.getPeriodicBoxVectors() == ctx_j.getPeriodicBoxVectors()


def _dense_box(api, n=1400, box=4.5, excluded=None):
    """Twin of the system of
    tests/test_box_change.py::test_box_shrink_below_cell_grid_raises:
    1,400 atoms (the cell list's size) in a 4.5 nm box (4 cells of its 1 nm
    cutoff), CutoffPeriodic; or, with ``excluded``, PME and that one
    exclusion."""
    rng = np.random.default_rng(1)
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = api.SlicedNonbondedForce(2)
    force.setNonbondedMethod(api.SlicedNonbondedForce.PME
                             if excluded else
                             api.SlicedNonbondedForce.CutoffPeriodic)
    force.setCutoffDistance(1.0)
    for i in range(n):
        system.addParticle(16.0)
        force.addParticle(0.1 * (-1) ** i, 0.3, 0.3)
        force.setParticleSubset(i, i % 2)
    if excluded:
        force.addException(*excluded, 0.0, 1.0, 0.0)
    system.addForce(force)
    return system, force, rng.random((n, 3)) * box


def test_box_guards():
    """Below twice the cutoff, and below the cell grid sized from the
    default box, getState raises."""
    system, _, positions = _dense_box(nbt)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.001),
                      nbt.Platform.getPlatformByName("Reference"), CPU)
    ctx.setPositions(positions)
    ctx.setPeriodicBoxVectors((3.9, 0, 0), (0, 3.9, 0), (0, 0, 3.9))
    with pytest.raises(nbt.OpenMMException, match="cell grid"):
        ctx.getState(getEnergy=True)
    ctx.setPeriodicBoxVectors((1.9, 0, 0), (0, 1.9, 0), (0, 0, 1.9))
    with pytest.raises(nbt.OpenMMException, match="twice"):
        ctx.getState(getEnergy=True)


def test_excluded_pair_span_guard():
    """An excluded pair 2 nm apart (two cell widths): the float32 cell
    kernel's route (its plain twin on the CPU) cannot correct it, and the
    Context raises; the Reference platform (the plain cell list and the
    generic exclusion corrections) evaluates it."""
    system, _, positions = _dense_box(nbt, excluded=(0, 1))
    positions[1] = positions[0] + [2.0, 0.0, 0.0]
    for name, raises in (("CUDA", True), ("Reference", False)):
        ctx = nbt.Context(system, nbt.VerletIntegrator(0.001),
                          nbt.Platform.getPlatformByName(name), CPU)
        ctx.setPositions(positions)
        if raises:
            with pytest.raises(nbt.OpenMMException, match="spans"):
                ctx.getState(getEnergy=True)
        else:
            assert np.isfinite(ctx.getState(getEnergy=True)
                               .getPotentialEnergy())


def test_enforce_periodic_box():
    """Twin of tests/test_api.py::test_enforce_periodic_box."""
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((2, 0, 0), (0, 2, 0), (0, 0, 2))
    force = nbt.SlicedNonbondedForce(1)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.NoCutoff)
    for _ in range(4):
        system.addParticle(1.0)
        force.addParticle(0.0, 0.3, 0.1)
    force.addException(0, 1, 0.0, 1.0, 0.0)
    force.addException(2, 3, 0.0, 1.0, 0.0)
    system.addForce(force)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.001), None, CPU)
    pos = np.array([[1.95, 0.5, 0.5], [2.05, 0.5, 0.5],
                    [0.5, 2.6, 0.5], [0.6, 2.7, 0.5]])
    ctx.setPositions(pos)
    raw = np.asarray(ctx.getState(getPositions=True).getPositions())
    np.testing.assert_array_equal(raw, pos)
    wrapped = np.asarray(ctx.getState(
        getPositions=True, enforcePeriodicBox=True).getPositions())
    np.testing.assert_allclose(wrapped, [[-0.05, 0.5, 0.5], [0.05, 0.5, 0.5],
                                         [0.5, 0.6, 0.5], [0.6, 0.7, 0.5]],
                               atol=1e-12)


def test_platform_enumeration_and_properties():
    assert nbt.Platform.getNumPlatforms() == 2
    names = {nbt.Platform.getPlatform(i).getName() for i in range(2)}
    assert names == {"CUDA", "Reference"}
    with pytest.raises(nbt.OpenMMException):
        nbt.Platform.getPlatform(2)
    with pytest.raises(nbt.OpenMMException):
        nbt.Platform.getPlatformByName("TPU")
    fastest = nbt.Platform.findPlatform()
    ref = nbt.Platform.getPlatformByName("Reference")
    assert fastest.getName() == "CUDA"
    assert fastest.getSpeed() > ref.getSpeed()
    assert ref.getPropertyNames() == ["Device", "Precision"]
    assert ref.getPropertyDefaultValue("Precision") == "double"
    assert fastest.getPropertyDefaultValue("Precision") == "single"
    assert fastest.getPropertyDefaultValue("Device") == "cuda"

    system = nbt.System()
    system.addParticle(1.0)
    force = nbt.SlicedNonbondedForce(1)
    force.addParticle(0.0, 0.3, 0.1)
    system.addForce(force)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.001), fastest,
                      {"Device": "cpu", "Precision": "mixed"})
    assert fastest.getPropertyValue(ctx, "Precision") == "mixed"
    assert fastest.getPropertyValue(ctx, "Device") == "cpu"
    # the platform passed in keeps its own properties
    assert fastest.getPropertyDefaultValue("Device") == "cuda"
    with pytest.raises(nbt.OpenMMException):
        ref.getPropertyValue(ctx, "nope")
    with pytest.raises(nbt.OpenMMException):
        ref.setPropertyValue(ctx, "Precision", "single")
    with pytest.raises(nbt.OpenMMException, match="Precision"):
        nbt.Context(system, nbt.VerletIntegrator(0.001), fastest,
                    {"Device": "cpu", "Precision": "half"})
    with pytest.raises(nbt.OpenMMException, match="Device"):
        nbt.Context(system, nbt.VerletIntegrator(0.001), fastest,
                    {"Device": "tpu"})
    if not torch.cuda.is_available():
        # no card and no "cpu": the Context refuses, it never falls back
        with pytest.raises(nbt.OpenMMException, match="No CUDA device"):
            nbt.Context(system, nbt.VerletIntegrator(0.001))


def test_past_the_kernel_limits_takes_the_cell_list():
    """Nine subsets (the cell kernel takes eight) at 1,050 atoms: the
    float32 Context's make_compute(neighbor="auto") raises ValueError, so
    it builds the plain cell list, which agrees with float64."""
    system, force, positions = water_system(nbt, n_mol=350, box=4.8, nsub=9)
    energies = {}
    for name in ("CUDA", "Reference"):
        ctx = nbt.Context(system, nbt.VerletIntegrator(0.001),
                          nbt.Platform.getPlatformByName(name), CPU)
        ctx.setPositions(positions)
        energies[name] = ctx.getState(getEnergy=True).getPotentialEnergy()
        comp = ctx._compiled[id(force)]
        assert comp.neighbor == "cell"
        assert {f.route for f in comp._fns.values()} == {"cell"}
    assert abs(energies["CUDA"] - energies["Reference"]) <= 1e-5 * abs(
        energies["Reference"])
