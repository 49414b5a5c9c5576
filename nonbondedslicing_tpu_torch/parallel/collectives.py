"""The collectives of the sharded evaluation, and how work is cut among
the ranks of a process group.

Only ``all_reduce`` (a sum) is used: gloo takes ``all_reduce`` and
``broadcast`` on CUDA tensors and NCCL every collective, so the sharded
evaluation runs on both backends, several ranks on one card over gloo
included.  A rank's share of a per-atom result is written into a
zero-filled array and summed over the group: every other rank adds zeros,
so the sum is exact.  The atom-space PME's grids are summed as int64
fixed point (``ops/pme.spread_fixed``; NCCL and gloo both sum int64),
exact in any order too: only the sums of float partial results (the slab
step's forces and slice energies, the sharded direct space's energies)
round in the order of the ranks.
"""

import torch
import torch.distributed as dist


def rank_and_size(group):
    """(this process's rank in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def share(total, group, quantum=1):
    """[begin, end) of this rank's share of ``total`` items: ranks take
    ceil(total / size) items rounded up to a multiple of ``quantum`` in
    rank order, so the last ranks' shares may be short or empty (the JAX
    package pads them with items that add nothing)."""
    rank, size = rank_and_size(group)
    per = -(-total // (size * quantum)) * quantum
    begin = min(rank * per, total)
    return begin, min(begin + per, total)


def all_reduce(tensor, group):
    """Sum ``tensor`` over ``group`` in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def assemble(part, begin, total, group):
    """The (total, ...) sum over ``group`` of zero-filled arrays, each rank
    holding its ``part`` at rows [begin, begin + len(part))."""
    full = part.new_zeros((total,) + tuple(part.shape[1:]))
    full[begin:begin + part.shape[0]] = part
    return all_reduce(full, group)
