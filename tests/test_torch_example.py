"""examples/lambda_sweep_torch.py, the port's twin of
examples/lambda_sweep.py, on the CPU (Platform "Reference", Device "cpu"):
its build() and lambda sweep at the example's own size (61 dimers, 122
atoms) against the JAX example's system through the JAX package's
Reference platform, E(lambda) and dE/dlambda to 1e-9 relative; and the
whole example (sweep, linearity assertion, 50 MD steps) as a user runs it
with ``--platform Reference``."""

import importlib.util
import os

import numpy as np
import pytest

import nonbondedslicing_tpu as nbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def examples():
    return _example("lambda_sweep_torch"), _example("lambda_sweep")


def test_sweep_matches_jax_example(examples):
    port, jax_example = examples
    system, positions = port.build()
    assert system.getNumParticles() == 122
    energies, derivs = port.sweep(
        port.make_context(system, positions, "Reference"))

    j_system, j_positions = jax_example.build()
    np.testing.assert_array_equal(positions, j_positions)
    context = nbs.Context(j_system, nbs.VerletIntegrator(0.001),
                          nbs.Platform.getPlatformByName("Reference"))
    context.setPositions(j_positions)
    j_energies, j_derivs = [], []
    for lam in port.LAMBDAS:
        context.setParameter("lambda_sv", lam)
        state = context.getState(getEnergy=True, getParameterDerivatives=True)
        j_energies.append(state.getPotentialEnergy())
        j_derivs.append(state.getEnergyParameterDerivatives()["lambda_sv"])
    np.testing.assert_allclose(energies, j_energies, rtol=1e-9)
    np.testing.assert_allclose(derivs, j_derivs, rtol=1e-9)


def test_example_runs_on_reference(examples, capsys):
    energies, derivs, e_md = examples[0].main(["--platform", "Reference"])
    assert len(energies) == 5 and np.isfinite(e_md)
    assert "dE/dlambda at every window" in capsys.readouterr().out
