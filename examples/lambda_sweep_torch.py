"""Alchemical lambda sweep with a sliced nonbonded force through the
PyTorch/CUDA port, end to end through its public API: the twin of
examples/lambda_sweep.py (same system, same windows, same steps).

A box of "solvent" molecules (subset 0) plus one "solute" molecule
(subset 1).  The solute-solvent slice (0,1) is scaled by a global
parameter ``lambda_sv``; because the total energy is linear in the
scaling parameter, dE/dlambda comes out of the same evaluation exactly
(no finite differences), and E(lambda) interpolates linearly between the
decoupled and fully-coupled endpoints.  Five windows, the linearity
check, then 50 MD steps at lambda = 0.5.

Run:  python examples/lambda_sweep_torch.py
          on the GPU: Platform "CUDA"; without a CUDA device it raises
      python examples/lambda_sweep_torch.py --platform Reference
          on the CPU: Platform "Reference", Device "cpu"

Both run in float64 (Precision "double"), as the JAX example runs its
Reference oracle.  The system's dimers are placed at random, unbonded, and
excluded from their partners: within the 50 steps some partners drift more
than a cell width apart, which the single-precision MD step of the fused
engine refuses (it corrects only the excluded pairs of neighbouring
cells), while the float64 step evaluates ``make_compute`` every step,
which takes any exclusion.
"""

import argparse
import os
import sys

import numpy as np

# runnable in-place from a source checkout (python
# examples/lambda_sweep_torch.py) without an installed wheel
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nonbondedslicing_tpu_torch as nbt  # noqa: E402

LAMBDAS = (0.0, 0.25, 0.5, 0.75, 1.0)
MD_STEPS = 50
LINEARITY_TOL = 1e-6   # dE/dlambda against E(1) - E(0), relative


def build(n_solvent=60, box=3.6, seed=7):
    rng = np.random.default_rng(seed)
    system = nbt.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    force = nbt.SlicedNonbondedForce(2)
    force.setNonbondedMethod(nbt.SlicedNonbondedForce.PME)
    force.setCutoffDistance(1.0)
    force.setEwaldErrorTolerance(5e-4)

    positions = []
    # solvent: neutral LJ dimers with partial charges, subset 0 (default)
    for k in range(n_solvent):
        a = system.addParticle(16.0)
        b = system.addParticle(1.0)
        force.addParticle(-0.4, 0.31, 0.65)
        force.addParticle(0.4, 0.12, 0.05)
        force.addException(a, b, 0.0, 1.0, 0.0)
        base = rng.random(3) * box
        positions += [base, base + rng.normal(scale=0.04, size=3)]
    # solute: one charged dimer, subset 1
    s0 = system.addParticle(16.0)
    s1 = system.addParticle(16.0)
    force.addParticle(0.6, 0.35, 0.8)
    force.addParticle(-0.6, 0.35, 0.8)
    force.addException(s0, s1, 0.0, 1.0, 0.0)
    force.setParticleSubset(s0, 1)
    force.setParticleSubset(s1, 1)
    center = np.full(3, box / 2)
    positions += [center, center + (0.25, 0.0, 0.0)]

    # lambda_sv scales the solute-solvent slice (subsets 0 x 1), both
    # Coulomb and LJ; request its exact derivative
    force.addGlobalParameter("lambda_sv", 1.0)
    force.addScalingParameter("lambda_sv", 0, 1, True, True)
    force.addEnergyParameterDerivative("lambda_sv")
    system.addForce(force)
    return system, np.asarray(positions)


def make_context(system, positions, platform_name="CUDA"):
    """A float64 Context on ``platform_name``: "CUDA" runs on the GPU (and
    raises without one), "Reference" on the CPU."""
    platform = nbt.Platform.getPlatformByName(platform_name)
    properties = {"Precision": "double"}
    if platform_name == "Reference":
        properties["Device"] = "cpu"
    context = nbt.Context(system, nbt.VerletIntegrator(0.001), platform,
                          properties)
    context.setPositions(positions)
    return context


def sweep(context, lambdas=LAMBDAS):
    """E(lambda) and the exact dE/dlambda at each window."""
    energies, derivs = [], []
    for lam in lambdas:
        context.setParameter("lambda_sv", lam)
        state = context.getState(getEnergy=True, getParameterDerivatives=True)
        energies.append(state.getPotentialEnergy())
        derivs.append(state.getEnergyParameterDerivatives()["lambda_sv"])
    return energies, derivs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--platform", choices=("CUDA", "Reference"),
                        default="CUDA",
                        help="CUDA: the GPU (default); Reference: the CPU")
    args = parser.parse_args(argv)
    system, positions = build()
    context = make_context(system, positions, args.platform)

    energies, derivs = sweep(context)
    print(f"platform {args.platform} ({context._device}, float64)")
    print(" lambda    E(lambda) [kJ/mol]    dE/dlambda (exact)")
    for lam, e, d in zip(LAMBDAS, energies, derivs):
        print(f"  {lam:4.2f}   {e:18.6f}   {d:18.6f}")

    # linearity: every dE/dlambda equals the endpoint difference
    de = energies[-1] - energies[0]
    assert all(abs(d - de) < LINEARITY_TOL * max(abs(de), 1)
               for d in derivs), derivs
    print(f"\n E(1) - E(0) = {de:.6f} = dE/dlambda at every window "
          "(energy is lambda-linear; free-energy gradients are exact)")

    # short MD at the half-coupled state
    context.setParameter("lambda_sv", 0.5)
    context.getIntegrator().step(MD_STEPS)
    e_md = context.getState(getEnergy=True).getPotentialEnergy()
    assert np.isfinite(e_md), e_md
    print(f" {MD_STEPS} MD steps at lambda=0.5: E = {e_md:.4f}")
    return energies, derivs, e_md


if __name__ == "__main__":
    main()
