"""The owner decomposition of the whole-grid spread kernel
(``csrc/pme_spread.cu``), on the CPU with its plain-torch helpers.

The kernel gives each slot group (a cell, or a brick of cells) the grid
points of its fractional range, ``cuda_pme.spread_owned_ranges``, and sums
there the contributions of the slots of the groups within
``cuda_pme.spread_radius`` of its own (each group once where the
neighbourhood covers an axis).  Here that decomposition is written out in
plain torch: per group, the plain spread of its neighbourhood's slots,
clipped to the group's owned points, summed over the groups.  It must give
the plain spread of all slots, ``pme_spread_plain``, to 1e-12 of the grid's
largest value in float64 (the same contributions, summed in another
order): for a cubic box whose grid is a multiple of the lattice, a grid of
28 points on 6 groups (owned ranges of 4 and 5 points), a triclinic box,
atoms displaced by half the skin towards every face after the slot table
was built (one across the box face), and brick-major groups
(``tests/torch_spread_cases.py``, which the kernel is held to on the card
as well).  One case is
also held to the JAX package's XLA brick oracle
(``pme_bricks.spread_bricks``) to 1e-10, as ``test_torch_pme_windows.py``
holds the window pipeline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonbondedslicing_tpu_torch as nbt
from nonbondedslicing_tpu.ops import pme_bricks as jbricks

from nonbondedslicing_tpu_torch.ops import cuda_pme, fused
from nonbondedslicing_tpu_torch.ops import plan as tplan
from nonbondedslicing_tpu_torch.runtime.fastpath import DEFAULT_SKIN

from torch_spread_cases import SPREAD_CASES, spread_case_slots

torch.set_num_threads(2)


def _neighbours(c, r, nc):
    """The groups around group c on an axis, as the kernel walks them:
    2r + 1 of them, periodic, or every group once when they cover it."""
    span = min(2 * r + 1, nc)
    return [j if span == nc else (c - r + j) % nc for j in range(span)]


def owner_spread(s, radius):
    """The kernel's decomposition in plain torch: every group's owned points
    of the plain spread of its neighbourhood's slots."""
    lattice, grid = s["lattice"], s["grid"]
    ranges = [cuda_pme.spread_owned_ranges(n, nc).tolist()
              for n, nc in zip(grid, lattice)]
    out = torch.zeros((s["nsub"],) + tuple(grid), dtype=torch.float64)
    for cx in range(lattice[0]):
        for cy in range(lattice[1]):
            for cz in range(lattice[2]):
                groups = torch.as_tensor(
                    [(gx * lattice[1] + gy) * lattice[2] + gz
                     for gx in _neighbours(cx, radius[0], lattice[0])
                     for gy in _neighbours(cy, radius[1], lattice[1])
                     for gz in _neighbours(cz, radius[2], lattice[2])])
                part = cuda_pme.pme_spread_plain(
                    s["pos"][groups], s["q"][groups], s["sub"][groups],
                    s["recip"], grid, s["nsub"])
                (x0, x1), (y0, y1), (z0, z1) = (
                    (r[c], r[c + 1]) for r, c in zip(ranges, (cx, cy, cz)))
                out[:, x0:x1, y0:y1, z0:z1] += part[:, x0:x1, y0:y1, z0:z1]
    return out


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_owner_decomposition_equals_plain_spread(case):
    s = spread_case_slots(case)
    radius = cuda_pme.spread_radius(s["grid"], s["lattice"], s["skin"],
                                    s["box"])
    # the neighbourhood leaves groups out on some axis: the radius matters
    assert any(2 * r + 1 < nc for r, nc in zip(radius, s["lattice"]))
    plain = cuda_pme.pme_spread_plain(s["pos"], s["q"], s["sub"], s["recip"],
                                      s["grid"], s["nsub"])
    owned = owner_spread(s, radius)
    scale = float(plain.abs().max())
    assert float((owned - plain).abs().max()) <= 1e-12 * scale
    # every spline weight sums to 1: the grids hold the subsets' charges
    q_sub = torch.stack([s["q"][s["sub"] == k].sum()
                         for k in range(s["nsub"])])
    torch.testing.assert_close(owned.sum(dim=(1, 2, 3)), q_sub, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("case", ["drift", "triclinic_drift"])
def test_owner_decomposition_needs_its_radius(case):
    """One group fewer on any axis loses the contributions of the atoms
    that drifted across the group faces: the cases above test R."""
    s = spread_case_slots(case)
    radius = cuda_pme.spread_radius(s["grid"], s["lattice"], s["skin"],
                                    s["box"])
    plain = cuda_pme.pme_spread_plain(s["pos"], s["q"], s["sub"], s["recip"],
                                      s["grid"], s["nsub"])
    for axis in range(3):
        short = tuple(r - (a == axis) for a, r in enumerate(radius))
        err = float((owner_spread(s, short) - plain).abs().max())
        assert err > 1e-3 * float(plain.abs().max())


def test_spread_radius_grows_with_the_drift():
    """R covers the stencil's 4 points above its base plus the drift:
    1 group of 5 points for up to 0.95 points of drift, 2 beyond."""
    box = np.diag([3.0] * 3)
    spacing = 3.0 / 30
    for drift_points, expect in ((0.0, 1), (0.9, 1), (0.97, 2), (5.0, 2),
                                 (6.0, 3)):
        skin = 2.0 * drift_points * spacing
        assert cuda_pme.spread_radius((30, 30, 30), (6, 6, 6), skin,
                                      box) == (expect,) * 3
    # owned ranges: ceil(c n / nc), of 4 and 5 points for 28 on 6
    assert cuda_pme.spread_owned_ranges(28, 6).tolist() == [
        0, 5, 10, 14, 19, 24, 28]


@pytest.mark.parametrize("method", ["PME", "LJPME"])
def test_spread_radius_is_one_at_the_benchmark(method):
    """The benchmark's 60^3 PME grid and 30^3 dispersion grid on its 6^3
    cells (and bricks), at the skin its MD step runs with: one neighbour
    group per side, 27 groups a block."""
    import port_systems
    system, force, _, _ = port_systems.build_system(nbt, method)
    plan = tplan.build_plan(force, system)
    cfg = fused.fused_config(plan, target_skin=DEFAULT_SKIN)
    assert cfg["counts"] == cfg["bricks"] == (6, 6, 6)
    grids = [cfg["pme_grid"]] + ([cfg["dispersion_grid"]]
                                 if method == "LJPME" else [])
    assert grids == [(60, 60, 60), (30, 30, 30)][:len(grids)]
    for grid in grids:
        assert cuda_pme.spread_radius(grid, cfg["counts"], cfg["skin"],
                                      plan.box0) == (1, 1, 1)


def test_owner_decomposition_matches_jax_brick_oracle():
    """Brick-major groups: the summed grid against the JAX package's XLA
    brick spread to 1e-10 of its largest value (float64)."""
    s = spread_case_slots("bricks")
    radius = cuda_pme.spread_radius(s["grid"], s["lattice"], s["skin"],
                                    s["box"])
    owned = owner_spread(s, radius).numpy()
    nsub = s["nsub"]
    soh = (s["sub"].numpy()[:, None, :] == np.arange(nsub)[None, :, None])
    grid_j = np.asarray(jbricks.spread_bricks(
        jnp.asarray(s["pos"].numpy()),
        jnp.asarray(soh * s["q"].numpy()[:, None, :]),
        jnp.asarray(s["box"]), s["lattice"], s["grid"]))
    np.testing.assert_allclose(owned, grid_j, rtol=0,
                               atol=1e-10 * np.abs(grid_j).max())
