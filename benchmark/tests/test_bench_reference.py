"""The plain reference against a small hand-computed sliced Ewald sum, its
identities, and against the port's own float64 platform at a tiny box."""

import io
import math

import numpy as np
import pytest
import torch

from harness import catalog
from harness.spec import Spec, build, spec_of
from reference.md import Constraints, Integrator, small_solve
from reference.precision import tf32_round
from reference.sliced import ONE_4PI_EPS0, SlicedPME, dispersion_coefficients


L = 2.5
RC = 1.0


def hand_spec(lam=0.6, eps=(0.5, 0.0, 0.3, 0.0)):
    """Four charges in two subsets in a 2.5 nm box: (0, 1) in subset 0,
    (2, 3) in subset 1; lambda scales the Coulomb and LJ of slice (0, 1)."""
    pos = np.array([[0.3, 0.4, 0.5], [1.1, 0.2, 0.9], [1.9, 1.6, 0.4],
                    [0.6, 1.8, 2.1]])
    return Spec(box=np.full(3, L), masses=np.full(4, 10.0),
                charges=np.array([0.5, -0.3, 0.4, -0.6]),
                sigmas=np.full(4, 0.3), epsilons=np.asarray(eps, float),
                subsets=np.array([0, 0, 1, 1]), n_subsets=2,
                exceptions=np.zeros((0, 2), dtype=np.int64),
                exception_params=np.zeros((0, 3)), method="PME", cutoff=RC,
                tolerance=1e-6, globals={"lam": lam},
                scaling=[("lam", 0, 1, True, True)], derivatives=["lam"],
                constraints=np.zeros((0, 2), dtype=np.int64),
                constraint_dists=np.zeros(0), bonds=np.zeros((0, 4)),
                positions=pos)


def ewald_slices(spec, alpha, kmax=12):
    """Per-slice (Coulomb, LJ) energies by the Ewald sum written out: the
    real-space pairs within the cutoff (minimum image), the k-vectors, the
    self energy; no dispersion correction."""
    pos, q, sub = spec.positions, spec.charges, spec.subsets
    out = np.zeros((3, 2))

    def sl(a, b):
        hi, lo = max(a, b), min(a, b)
        return hi * (hi + 1) // 2 + lo

    n = len(q)
    for i in range(n):
        for j in range(i + 1, n):
            d = pos[j] - pos[i]
            d -= L * np.round(d / L)
            r = np.linalg.norm(d)
            if r < RC:
                s = sl(sub[i], sub[j])
                out[s, 0] += ONE_4PI_EPS0 * q[i] * q[j] * math.erfc(
                    alpha * r) / r
                sig = 0.5 * (spec.sigmas[i] + spec.sigmas[j])
                e = math.sqrt(spec.epsilons[i] * spec.epsilons[j])
                out[s, 1] += 4 * e * ((sig / r) ** 12 - (sig / r) ** 6)
    V = L ** 3
    ks = np.array([(a, b, c) for a in range(-kmax, kmax + 1)
                   for b in range(-kmax, kmax + 1)
                   for c in range(-kmax, kmax + 1) if (a, b, c) != (0, 0, 0)])
    m = ks / L
    m2 = np.sum(m * m, axis=1)
    pref = ONE_4PI_EPS0 * np.exp(-math.pi ** 2 * m2 / alpha ** 2) / (
        2 * math.pi * V * m2)
    S = [np.exp(2j * math.pi * (m @ pos[sub == s].T)) @ q[sub == s]
         for s in range(2)]
    out[0, 0] += np.sum(pref * np.abs(S[0]) ** 2)
    out[2, 0] += np.sum(pref * np.abs(S[1]) ** 2)
    out[1, 0] += np.sum(pref * 2 * np.real(S[0] * np.conj(S[1])))
    for s in range(2):
        out[sl(s, s), 0] -= ONE_4PI_EPS0 * alpha / math.sqrt(math.pi) * \
            np.sum(q[sub == s] ** 2)
    return out


def test_pme_against_a_hand_ewald_sum():
    spec = hand_spec()
    ref = SlicedPME(spec, "cpu")
    slice_e, _ = ref.evaluate(spec.positions)
    got = slice_e.numpy()
    got[:, 1] -= dispersion_coefficients(spec) / L ** 3
    hand = ewald_slices(spec, ref.alpha)
    # the charges are not neutral: the plasma term of each slice
    qs = [spec.charges[spec.subsets == s].sum() for s in range(2)]
    for a, b, s, mult in ((0, 0, 0, 1), (0, 1, 1, 2), (1, 1, 2, 1)):
        hand[s, 0] -= mult * ONE_4PI_EPS0 * math.pi * qs[a] * qs[b] / (
            2 * L ** 3 * ref.alpha ** 2)
    np.testing.assert_allclose(got, hand, rtol=2e-5, atol=2e-4)


def test_energy_is_linear_in_lambda_and_gives_its_derivative():
    spec = hand_spec(lam=1.0)
    e1, d1 = _energy(spec)
    spec0 = hand_spec(lam=0.0)
    e0, _ = _energy(spec0)
    assert e1 - e0 == pytest.approx(d1["lam"], rel=1e-12, abs=1e-9)


def _energy(spec):
    ref = SlicedPME(spec, "cpu")
    slice_e, _ = ref.evaluate(spec.positions)
    return ref.energy(slice_e), ref.derivatives(slice_e)


def test_forces_are_minus_the_gradient():
    spec = hand_spec()
    ref = SlicedPME(spec, "cpu")
    _, forces = ref.evaluate(spec.positions)
    h = 1e-5
    for atom, axis in ((0, 0), (2, 1), (3, 2)):
        plus, minus = spec.positions.copy(), spec.positions.copy()
        plus[atom, axis] += h
        minus[atom, axis] -= h
        ep = ref.energy(ref.evaluate(plus)[0])
        em = ref.energy(ref.evaluate(minus)[0])
        assert -(ep - em) / (2 * h) == pytest.approx(
            float(forces[atom, axis]), rel=1e-6, abs=1e-6)


def test_dispersion_coefficients_by_hand():
    spec = hand_spec(eps=(0.5, 0.5, 0.5, 0.5))
    # one class per subset of two particles: 3 pairs in each diagonal
    # slice, 4 across; n (n + 1) / 2 = 10 interactions
    sig, eps, n = 0.3, 0.5, 4
    per = 8 * math.pi * n * n * (eps * sig ** 12 / (9 * RC ** 9)
                                 - eps * sig ** 6 / (3 * RC ** 3)) / 10
    np.testing.assert_allclose(dispersion_coefficients(spec),
                               [3 * per, 4 * per, 3 * per], rtol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0,
                      1.0 + 2 ** -10], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0,
                                      1.0 + 2 ** -10]


def test_small_solve():
    A = torch.tensor([[[4.0, 1, 0], [1, 3, 1], [0, 1, 2]]],
                     dtype=torch.float64)
    b = torch.tensor([[1.0, 2, 3]], dtype=torch.float64)
    np.testing.assert_allclose(small_solve(A, b)[0].numpy(),
                               np.linalg.solve(A[0].numpy(), b[0].numpy()))


CONFIGS = [c["name"] for c in catalog.benchmark()["configs"]]


def _tiny(config_name):
    config = catalog.config(config_name)
    config = dict(config, stated={}, cube_edge_nm=config["tiny_cube_edge_nm"])
    return config, spec_of(config)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_against_the_port_in_float64(config_name):
    import nonbondedslicing_tpu_torch as nbt
    from reference.md import bond_terms
    config, spec = _tiny(config_name)
    system, pos = build(config, nbt)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.002),
                      nbt.Platform.getPlatformByName("Reference"),
                      {"Device": "cpu"})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, 5)
    ctx.getIntegrator().step(3)
    state = ctx.getState(getEnergy=True, getForces=True,
                         getParameterDerivatives=True, getPositions=True)
    x = np.array(state.getPositions())
    ref = catalog.reference(config)(spec, "cpu")
    slice_e, forces = ref.evaluate(x)
    bonds, bond_f = bond_terms(spec, torch.as_tensor(x))
    assert ref.energy(slice_e) + bonds == pytest.approx(
        state.getPotentialEnergy(), rel=1e-12)
    for name, value in ref.derivatives(slice_e).items():
        assert value == pytest.approx(
            state.getEnergyParameterDerivatives()[name], rel=1e-10,
            abs=1e-9)
    np.testing.assert_allclose((forces + bond_f).numpy(),
                               np.array(state.getForces()), atol=1e-8)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_md_step_against_the_port_in_float64(config_name):
    import nonbondedslicing_tpu_torch as nbt
    config, spec = _tiny(config_name)
    system, pos = build(config, nbt)
    ctx = nbt.Context(system, nbt.VerletIntegrator(0.002),
                      nbt.Platform.getPlatformByName("Reference"),
                      {"Device": "cpu"})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, 6)
    ctx.getIntegrator().step(2)
    start = np.load(io.BytesIO(ctx.createCheckpoint()))
    x0, v0 = start["positions"], start["velocities"]
    ctx.getIntegrator().step(5)
    end = np.load(io.BytesIO(ctx.createCheckpoint()))
    model = catalog.reference(config)(spec, "cpu", skin=0.1)
    x, v = Integrator(spec, model, 0.002).steps(x0, v0, 5)
    # the port's M-SHAKE stops after 8 sweeps, the reference's SHAKE at
    # 1e-13: 1e-8 nm
    np.testing.assert_allclose(x.numpy(), end["positions"], atol=1e-8)
    np.testing.assert_allclose(v.numpy(), end["velocities"], atol=1e-5)
    cons = Constraints(spec, "cpu")
    d = x[cons.i] - x[cons.j]
    np.testing.assert_allclose(
        (torch.sum(d * d, -1) * cons.valid).numpy(),
        (cons.d2 * cons.valid).numpy(), rtol=1e-12)
