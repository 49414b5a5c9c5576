"""Atom-sharded sliced PME and Ewald over a ``torch.distributed`` group
(the JAX package's ``parallel/pme_shard.py``).

The reference's multi-GPU scheme computes the whole reciprocal space on one
device (CommonNonbondedSlicingKernels.cpp:388,416,465).  Here each rank
takes a range of ceil(N / size) atoms:

* **spread**: it spreads its atoms into full per-subset int64
  fixed-point grids at the scale of all atoms (``ops/pme.spread_fixed``),
  and the grids are summed over the group as integers (an all-reduce of
  (nsub, nx, ny, nz) int64 values; in float32 also the grid of the slice
  energies' float64 spread, D1), so the summed grids equal the single
  device's to the bit at any group size;
* **convolution + slice energies**: the FFTs, the convolution and the slice
  energies run on every rank, on the summed grids;
* **interpolate**: each rank interpolates the forces of its own atoms, and
  the forces are assembled over the group (``collectives.assemble``), or
  (the device terms, :func:`make_pme_device_term` and
  :func:`make_ewald_device_term`) returned as the rank's range, which the
  slab MD step writes into its own force sum.  Force-only calls skip the
  slice energies and, in float32, their float64 grid.

Bare Ewald sums each k-chunk's per-subset structure factors over the group
(``ops/ewald.ewald_reciprocal(group=)``), with every rank's range padded
to ceil(N / size) atoms of zero charge, as in the JAX package, so that the
ranks cut the k-vectors into the same chunks.
"""

import numpy as np
import torch

from ..ops import ewald, pme
from . import collectives


def _on(dev, cache, arrays):
    """``arrays`` (numpy or tensors; a tuple of them for the moduli) as
    tensors on ``dev``, copied once per device."""
    if dev not in cache:
        cache[dev] = tuple(
            tuple(torch.as_tensor(np.asarray(m), device=dev) for m in x)
            if isinstance(x, tuple) else
            torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)
            for x in arrays)
    return cache[dev]


def make_pme_device_term(group, num_particles, *, alpha, grid_shape, moduli,
                         num_subsets, slice_subset_pairs, slice_table,
                         dispersion=False, order=5):
    """One rank's share of a sliced-PME term (Coulomb, or LJPME's C6 with
    ``dispersion``): spread its atom range, sum the grids over ``group``,
    the FFTs and the convolution on every rank, interpolate the forces of
    its range only.

    Returns (rows, n_pad, f) where
    f(positions (N, 3), box, charges (N,), subsets (N,), lam_s,
      energies=True, eterm=None)
      -> (slice_energies (S,) float64 or None, forces of the range
          (end - start, 3), start)
    with rows = ceil(N / size) atoms a rank and n_pad = rows * size; the
    last ranks' ranges are short (the JAX package pads them with zero
    charges).  ``moduli``, ``slice_subset_pairs`` and ``slice_table`` may be
    numpy arrays; ``eterm`` is ``ops/pme.pme_reciprocal``'s."""
    _, size = collectives.rank_and_size(group)
    rows = -(-num_particles // size)
    n_pad = rows * size
    start, end = collectives.share(num_particles, group)
    cache = {}

    def term(positions, box, charges, subsets, lam_s, energies=True,
             eterm=None):
        mod, pairs, table = _on(positions.device, cache,
                                (tuple(moduli), slice_subset_pairs,
                                 slice_table))
        slice_e, f_s = pme.pme_reciprocal(
            positions[start:end], box, charges[start:end],
            subsets[start:end], lam_s, alpha=alpha, grid_shape=grid_shape,
            moduli=mod, num_subsets=num_subsets, slice_subset_pairs=pairs,
            slice_table=table, dispersion=dispersion, order=order,
            eterm=eterm, group=group, energies=energies,
            scale=pme.fixed_point_scale(charges))
        return slice_e, f_s, start

    return rows, n_pad, term


def make_sharded_pme(group, num_particles, *, alpha, grid_shape, moduli,
                     num_subsets, slice_subset_pairs, slice_table,
                     dispersion=False, order=5):
    """Returns f(positions, box, charges, subsets, lam_s, eterm=None) ->
    (slice_energies (S,) float64, forces (N, 3)) computing one sliced-PME
    term sharded over ``group`` by atom range; inputs are replicated and
    every rank returns the same full result.  The summed grids equal
    ``ops/pme.pme_reciprocal``'s to the bit, and so do the slice energies;
    a rank's forces are those of its atoms in the unsharded call, up to
    the order in which the interpolation of a shorter atom array sums."""
    _, _, term = make_pme_device_term(
        group, num_particles, alpha=alpha, grid_shape=grid_shape,
        moduli=moduli, num_subsets=num_subsets,
        slice_subset_pairs=slice_subset_pairs, slice_table=slice_table,
        dispersion=dispersion, order=order)

    def run(positions, box, charges, subsets, lam_s, eterm=None):
        slice_e, f_s, start = term(positions, box, charges, subsets, lam_s,
                                   eterm=eterm)
        return slice_e, collectives.assemble(f_s, start, num_particles,
                                             group)

    return run


def make_ewald_device_term(group, num_particles, *, kvec_ints, alpha,
                           num_subsets, slice_table, slice_subset_pairs):
    """One rank's share of the bare-Ewald k-space sum: it takes ceil(N /
    size) atoms (padded with zero charges), the per-subset structure
    factors of every k-chunk are summed over ``group``, the slice energies
    run on every rank and the forces cover the rank's atoms.

    Returns f(positions, box, charges, subsets, lam_s, energies=True)
      -> (slice_energies (S,) float64 or None, forces of the range
          (end - start, 3), start).
    ``kvec_ints`` and the tables may be numpy arrays."""
    _, size = collectives.rank_and_size(group)
    rows = -(-num_particles // size)
    start, end = collectives.share(num_particles, group)
    pad = rows - (end - start)
    cache = {}

    def term(positions, box, charges, subsets, lam_s, energies=True):
        kv, table, pairs = _on(positions.device, cache,
                               (kvec_ints, slice_table, slice_subset_pairs))

        def mine(x):
            x = x[start:end]
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

        slice_e, f_s = ewald.ewald_reciprocal(
            mine(positions), box, mine(charges), mine(subsets), lam_s,
            kvec_ints=kv, alpha=alpha, num_subsets=num_subsets,
            slice_table=table, slice_subset_pairs=pairs, energies=energies,
            group=group)
        return slice_e, f_s[:end - start], start

    return term


def make_sharded_ewald(group, num_particles, *, kvec_ints, alpha,
                       num_subsets, slice_table, slice_subset_pairs):
    """Bare-Ewald k-space sum sharded over ``group`` by atom range
    (:func:`make_ewald_device_term`), the forces assembled over the group.
    Same return contract as ``ops/ewald.ewald_reciprocal``."""
    term = make_ewald_device_term(
        group, num_particles, kvec_ints=kvec_ints, alpha=alpha,
        num_subsets=num_subsets, slice_table=slice_table,
        slice_subset_pairs=slice_subset_pairs)

    def run(positions, box, charges, subsets, lam_s):
        slice_e, f_s, start = term(positions, box, charges, subsets, lam_s)
        return slice_e, collectives.assemble(f_s, start, num_particles,
                                             group)

    return run
