"""The least time of the PME spread and interpolation: the bytes each
needs, each input read once and each output written once, in float32,
over the card's memory bandwidth (``peaks.json``).

* spread: per atom its position (12 bytes), charge (4) and subset (4) in;
  one grid per subset out (4 bytes a point);
* interpolation: per atom its position, charge and subset in, and the
  subsets' potential grids in; per atom its force (12 bytes) out.

The grid is the evaluation's, from the cutoff and the tolerance
(``reference.ewald.eval_grid``).  It does not depend on how the program
pads its grid or groups its atoms."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ATOM_IN = 12 + 4 + 4
FORCE_OUT = 12
POINT = 4


def spread_bytes(atoms, subsets, grid_points):
    return atoms * ATOM_IN + subsets * grid_points * POINT


def interp_bytes(atoms, subsets, grid_points):
    return atoms * (ATOM_IN + FORCE_OUT) + subsets * grid_points * POINT


def least_seconds(atoms, subsets, grid_points, spreads, interps):
    with open(os.path.join(HERE, "peaks.json")) as fh:
        bandwidth = json.load(fh)["hbm_bytes_per_s"]
    return (spreads * spread_bytes(atoms, subsets, grid_points)
            + interps * interp_bytes(atoms, subsets, grid_points)) / bandwidth
