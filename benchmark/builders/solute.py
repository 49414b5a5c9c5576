"""The decoupled solute: a 12-site chain in a cavity of the state's
waters, harmonic bonds, 2 subsets (``harness.systems.build_solute_system``)."""

from harness import systems


def build(api, water, box, method):
    system, _, positions, _, constraints, bonds, _ = \
        systems.build_solute_system(api, water, box, method)
    systems.add_constraints(system, constraints)
    systems.add_bonds(api, system, bonds)
    return system, positions
