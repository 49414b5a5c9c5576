"""PME grid sizing aligned with the cell grid.

The JAX package decomposes the PME grid into per-cell bricks; the port's
kernels spread into and read from the whole grid, but keep the same
cell-aligned grid size so that its numbers equal the JAX package's.
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
