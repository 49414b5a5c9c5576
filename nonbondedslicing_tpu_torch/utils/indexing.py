"""Slice-index helpers.

A system of ``n`` disjoint particle subsets defines ``n*(n+1)/2`` slices; the
unordered subset pair (i, j) maps to a flat slice id via the triangular-number
formula used throughout the reference plugin
(openmmapi/include/SlicedNonbondedForce.h:22).
"""

import weakref

import numpy as np
import torch


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


def incidence_table(index, n, keep=None):
    """The scatter of a static index as a gather: (targets (T,) int64, the
    t in [0, n) that ``index`` names, in increasing order; table (T, w)
    int64, for each target the positions k of ``index`` with
    index[k] == t, in increasing order, padded with ``len(index)``).
    ``keep`` (bool, the shape of ``index``) leaves entries out.

    :func:`incidence_sums` then sums each target's values in a fixed
    order, without atomics, so the sums repeat to the bit on a GPU."""
    index = np.asarray(index).reshape(-1)
    pos = (np.arange(index.size) if keep is None
           else np.nonzero(np.asarray(keep).reshape(-1))[0])
    target = index[pos]
    counts = np.bincount(target, minlength=n)
    targets = np.nonzero(counts)[0]
    row = np.zeros(n, dtype=np.int64)
    row[targets] = np.arange(targets.size)
    table = np.full((targets.size, max(1, int(counts.max(initial=0)))),
                    index.size, dtype=np.int64)
    order = np.argsort(target, kind="stable")
    rank = np.arange(order.size) - (np.cumsum(counts) - counts)[target[order]]
    table[row[target[order]], rank] = pos[order]
    return targets.astype(np.int64), table


def incidence_sums(values, table):
    """(T, ...) the sums of the rows of ``values`` (len(index), ...) that
    each target's row of ``table`` names (:func:`incidence_table`)."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[table].sum(dim=1)


_TENSOR_TABLES = {}


def pair_incidence(pairs, n):
    """:func:`incidence_table` of the atoms of a (P, 2) index tensor, first
    every pair's first atom, then every second one, as tensors on its
    device.  Built on the host once for each tensor and each write to it
    (its version counter): the first call copies ``pairs`` to the host,
    a synchronisation; later calls cost nothing and may run inside a CUDA
    graph's capture."""
    key = id(pairs)
    stamp = (pairs._version, n, tuple(pairs.shape))
    hit = _TENSOR_TABLES.get(key)
    if hit is not None and hit[0]() is pairs and hit[1] == stamp:
        return hit[2]
    host = pairs.detach().cpu().numpy().astype(np.int64)
    targets, table = incidence_table(host.T.reshape(-1), n)
    out = (torch.as_tensor(targets, device=pairs.device),
           torch.as_tensor(table, device=pairs.device))
    _TENSOR_TABLES[key] = (
        weakref.ref(pairs, lambda _, key=key: _TENSOR_TABLES.pop(key, None)),
        stamp, out)
    return out
