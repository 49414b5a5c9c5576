"""A box of rigid waters: the state's waters, 3 subsets, 2 lambdas
(``harness.systems.water_system``)."""

from harness import systems


def build(api, water, box, method):
    system, _, constraints = systems.water_system(api, len(water) // 3, box,
                                                  method)
    systems.add_constraints(system, constraints)
    return system, water
