"""The port's XmlSerializer, checkpoints and timing harness on the CPU.

Twins of tests/test_api.py::test_serialization_round_trip and
::test_deserialize_robustness (the port's serializer writes the JAX
package's XML to the character, and each reads the other's), and of
tests/test_runtime.py (checkpoint round trip, the wrong-system refusal,
a resumed trajectory equal to the uninterrupted one, ``time_fn``).
"""

import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import nonbondedslicing_tpu as nbs
import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu_torch.runtime import profiling

torch.set_num_threads(2)


def _populated_force(api):
    """The force of tests/test_api.py::test_serialization_round_trip."""
    force = api.SlicedNonbondedForce(3)
    force.setForceGroup(3)
    force.setName("custom name")
    force.setNonbondedMethod(api.SlicedNonbondedForce.LJPME)
    force.setCutoffDistance(2.0)
    force.setUseSwitchingFunction(True)
    force.setSwitchingDistance(1.5)
    force.setEwaldErrorTolerance(1e-3)
    force.setReactionFieldDielectric(50.0)
    force.setUseDispersionCorrection(False)
    force.setIncludeDirectSpace(False)
    force.setPMEParameters(0.3, 20, 20, 20)
    force.setLJPMEParameters(0.27, 24, 24, 24)
    force.setReciprocalSpaceForceGroup(1)
    force.setExceptionsUsePeriodicBoundaryConditions(True)
    force.addGlobalParameter("lambda01", 0.5)
    force.addGlobalParameter("lambda11", 0.25)
    force.addGlobalParameter("offsetP", 1.0)
    for i in range(5):
        force.addParticle(0.1 * i, 1.0 + 0.1 * i, 0.2 * i)
    force.setParticleSubset(1, 1)
    force.setParticleSubset(2, 2)
    force.addException(0, 1, 0.5, 1.2, 0.3)
    force.addException(2, 3, 0.0, 1.0, 0.0)
    force.addParticleParameterOffset("offsetP", 0, 1.0, 0.5, 0.25)
    force.addExceptionParameterOffset("offsetP", 0, 0.5, 0.1, 0.2)
    force.addScalingParameter("lambda01", 0, 1, True, True)
    force.addScalingParameter("lambda11", 1, 1, True, False)
    force.addEnergyParameterDerivative("lambda01")
    return force


def test_serialization_round_trip():
    force = _populated_force(nbt)
    xml = nbt.XmlSerializer.serialize(force)
    assert xml == nbs.XmlSerializer.serialize(_populated_force(nbs))
    copy = nbt.XmlSerializer.deserialize(xml)
    assert isinstance(copy, nbt.SlicedNonbondedForce)
    assert nbt.XmlSerializer.serialize(copy) == xml
    assert nbs.XmlSerializer.serialize(nbs.XmlSerializer.deserialize(
        xml)) == xml
    for getter in ("getNumSubsets", "getForceGroup", "getName",
                   "getNonbondedMethod", "getCutoffDistance",
                   "getSwitchingDistance", "getPMEParameters",
                   "getLJPMEParameters", "getReciprocalSpaceForceGroup",
                   "getIncludeDirectSpace", "getNumScalingParameters"):
        assert getattr(copy, getter)() == getattr(force, getter)()
    for i in range(force.getNumParticles()):
        assert copy.getParticleParameters(i) == force.getParticleParameters(i)
        assert copy.getParticleSubset(i) == force.getParticleSubset(i)
    assert copy.getExceptionParameterOffset(0) == \
        force.getExceptionParameterOffset(0)
    with pytest.raises(nbt.OpenMMException):
        nbt.XmlSerializer.serialize(nbt.HarmonicBondForce())


def test_deserialize_robustness():
    force = nbt.SlicedNonbondedForce(2)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.PME)
    force.addParticle(0.1, 0.3, 0.5)
    force.addParticle(-0.1, 0.3, 0.5)
    force.addException(0, 1, 0.0, 1.0, 0.0)
    force.addGlobalParameter("lam", 1.0)
    force.addScalingParameter("lam", 0, 1, True, True)
    xml = nbt.XmlSerializer.serialize(force)
    for bad in ("<unclosed", "<NonbondedForce version='1'/>",
                re.sub(r'version="1"', 'version="2"', xml),
                xml.replace('cutoff="', 'cutoff="not-a-number')):
        with pytest.raises(nbt.OpenMMException):
            nbt.XmlSerializer.deserialize(bad)
    for section in ("GlobalParameters", "ParticleOffsets", "ExceptionOffsets",
                    "Particles", "Exceptions", "Subsets", "scalingParameters",
                    "energyParameterDerivatives"):
        node = ET.fromstring(xml)
        node.remove(node.find(section))
        with pytest.raises(nbt.OpenMMException):
            nbt.XmlSerializer.deserialize(ET.tostring(node,
                                                      encoding="unicode"))
    for attr, required in (("cutoff", True), ("method", True),
                           ("ewaldTolerance", True), ("rfDielectric", True),
                           ("dispersionCorrection", True),
                           ("exceptionsUsePeriodic", True),
                           ("forceGroup", False), ("recipForceGroup", False),
                           ("useSwitchingFunction", False),
                           ("switchingDistance", False), ("alpha", False)):
        node = ET.fromstring(xml)
        del node.attrib[attr]
        text = ET.tostring(node, encoding="unicode")
        if required:
            with pytest.raises(nbt.OpenMMException):
                nbt.XmlSerializer.deserialize(text)
        else:
            nbt.XmlSerializer.deserialize(text)


def _make_context(n=24):
    """Twin of tests/test_runtime.py::_make_context on the port's CPU
    Reference platform."""
    rng = np.random.default_rng(0)
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((3, 0, 0), (0, 3, 0), (0, 0, 3))
    force = nbt.SlicedNonbondedForce(2)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.CutoffPeriodic)
    force.setCutoffDistance(1.0)
    for i in range(n):
        system.addParticle(1.0)
        force.addParticle((-1) ** i * 0.1, 0.3, 0.2)
        force.setParticleSubset(i, i % 2)
    force.addGlobalParameter("lam", 0.5)
    force.addScalingParameter("lam", 0, 1, True, True)
    system.addForce(force)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.001),
                      nbt.Platform.getPlatformByName("Reference"),
                      {"Device": "cpu"})
    ctx.setPositions(rng.random((n, 3)) * 3)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    return ctx


def test_checkpoint_round_trip():
    ctx = _make_context()
    ctx.setParameter("lam", 0.25)
    e0 = ctx.getState(getEnergy=True).getPotentialEnergy()
    blob = ctx.createCheckpoint()
    ctx.getIntegrator().step(5)
    ctx.setParameter("lam", 1.0)
    assert ctx.getState(getEnergy=True).getPotentialEnergy() != e0
    ctx.loadCheckpoint(blob)
    assert ctx.getParameter("lam") == 0.25
    assert ctx.getState(getEnergy=True).getPotentialEnergy() == e0
    with pytest.raises(nbt.OpenMMException, match="predates"):
        ctx.loadCheckpoint(b"not a checkpoint")


def test_checkpoint_wrong_system_rejected():
    blob = _make_context(n=24).createCheckpoint()
    with pytest.raises(nbt.OpenMMException, match="different System"):
        _make_context(n=30).loadCheckpoint(blob)


def test_checkpoint_resume_trajectory_identical():
    ctx = _make_context()
    blob = ctx.createCheckpoint()
    ctx.getIntegrator().step(10)
    ref = np.asarray(ctx.getState(getPositions=True).getPositions())
    ctx.loadCheckpoint(blob)
    ctx.getIntegrator().step(4)
    mid = ctx.createCheckpoint()
    ctx.loadCheckpoint(mid)
    ctx.getIntegrator().step(6)
    got = np.asarray(ctx.getState(getPositions=True).getPositions())
    np.testing.assert_array_equal(got, ref)


def test_time_fn_returns_positive(tmp_path):
    x = torch.arange(1000.0)
    dt = profiling.time_fn(lambda v: torch.sum(v * v), x, warmup=1, reps=3)
    assert dt > 0
    with profiling.trace(tmp_path) as prof:
        torch.sum(x * x)
    assert (tmp_path / "trace.json").is_file()
    assert len(prof.key_averages()) > 0
