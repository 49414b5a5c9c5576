"""PME bricks: grid sizing aligned with the cell grid, and the brick-major
slot layout of the window pipeline.

The PME grid is cut into bricks aligned with the cell grid (``p`` grid
points per brick and axis, a brick holding ``f`` cells per axis).  Both PME
pipelines of the port use the cell-aligned grid size, so that their numbers
equal the JAX package's.  The window pipeline (``pme_pipeline="grid"``,
``ops/cuda_pme.py``) also works brick by brick: each brick's atoms spread
into, and read their forces from, a window of ``w = p + order + 1`` points
per axis that starts one point before the brick, and ``cells_to_bricks`` /
``bricks_to_cells`` regroup the cell-major slot tensors of the pair kernels
for it.
"""


def brick_window(grid_shape, counts, order=5):
    """Per-axis (points-per-cell, window) sizes; grid must align with cells."""
    out = []
    for n, c in zip(grid_shape, counts):
        if n % c != 0:
            raise ValueError(f"grid axis {n} not divisible by cell count {c}")
        p = n // c
        out.append((p, p + order + 1))
    return tuple(out)


def aligned_grid(raw_grid, counts):
    """Smallest per-axis grid >= raw that is a multiple of the cell count."""
    return tuple(int(-(-n // c) * c) for n, c in zip(raw_grid, counts))


def check_two_piece_windows(grid_shape, bricks, order=5):
    """Raise ValueError unless every brick window spans at most two bricks
    per axis (w <= 2p, i.e. p >= order + 1), which the fold and extract
    kernels of the window pipeline require."""
    for p, w in brick_window(grid_shape, bricks, order):
        if w > 2 * p:
            raise ValueError(
                f"the window PME pipeline needs w <= 2p on every axis (at "
                f"least {order + 1} grid points per brick), got grid "
                f"{tuple(grid_shape)} over bricks {tuple(bricks)}; use the "
                f"default pipeline (pme_pipeline=\"stencil\")")


def cells_to_bricks(x, counts, bricks):
    """(g_cells, F, C) cell-major slot tensor -> (g_bricks, F, C*f^3)
    brick-major, where f = counts/bricks per axis."""
    ncx, ncy, ncz = counts
    bx, by, bz = bricks
    fx, fy, fz = ncx // bx, ncy // by, ncz // bz
    _, F, C = x.shape
    t = x.reshape(bx, fx, by, fy, bz, fz, F, C)
    t = t.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return t.reshape(bx * by * bz, F, fx * fy * fz * C)


def bricks_to_cells(x, counts, bricks):
    """Inverse of :func:`cells_to_bricks` for (g_bricks, C*f^3, F) tensors
    (slot-major, as forces are unsorted): -> (g_cells, C, F)."""
    ncx, ncy, ncz = counts
    bx, by, bz = bricks
    fx, fy, fz = ncx // bx, ncy // by, ncz // bz
    _, CF, F = x.shape
    C = CF // (fx * fy * fz)
    t = x.reshape(bx, by, bz, fx, fy, fz, C, F)
    t = t.permute(0, 3, 1, 4, 2, 5, 6, 7)
    return t.reshape(ncx * ncy * ncz, C, F)
