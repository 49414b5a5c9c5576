"""Slice-index helpers.

A system of ``n`` disjoint particle subsets defines ``n*(n+1)/2`` slices; the
unordered subset pair (i, j) maps to a flat slice id via the triangular-number
formula used throughout the reference plugin
(openmmapi/include/SlicedNonbondedForce.h:22).
"""

import numpy as np


def slice_index(i, j):
    """Flat slice id of the unordered subset pair (i, j).

    Works on Python ints and on numpy integer arrays.
    """
    lo = np.minimum(i, j) if not isinstance(i, int) or not isinstance(j, int) else min(i, j)
    hi = np.maximum(i, j) if not isinstance(i, int) or not isinstance(j, int) else max(i, j)
    return hi * (hi + 1) // 2 + lo


def num_slices(num_subsets: int) -> int:
    return num_subsets * (num_subsets + 1) // 2


def diagonal_slice(subset: int):
    """Slice id of the (subset, subset) pair: subset*(subset+3)/2.

    Reference: ReferenceSlicedLJCoulombIxn.cpp:209.
    """
    return subset * (subset + 3) // 2


def slice_pair_table(num_subsets: int) -> np.ndarray:
    """(num_subsets, num_subsets) table mapping (i, j) -> slice id."""
    idx = np.arange(num_subsets)
    return slice_index(idx[:, None], idx[None, :])


def slice_subsets(num_subsets: int) -> np.ndarray:
    """(num_slices, 2) table mapping slice id -> (i, j) with i <= j."""
    out = np.zeros((num_slices(num_subsets), 2), dtype=np.int64)
    for j in range(num_subsets):
        for i in range(j + 1):
            out[j * (j + 1) // 2 + i] = (i, j)
    return out
