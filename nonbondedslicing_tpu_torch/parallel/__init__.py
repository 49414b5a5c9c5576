"""Several devices on ``torch.distributed``: the JAX package's
``parallel/mesh.py``, ``parallel/pme_shard.py`` and
``parallel/fused_shard.py``.

A rank is one process with its own device; the JAX package's mesh axis is
a ``torch.distributed`` process group, passed as ``shard=`` to
``ops.engine.make_compute`` and as ``group`` to
:func:`.mesh.make_sharded_compute` (the sharded evaluation) and
:func:`.fused_shard.make_sharded_md_step` (the MD step, x-slabs of cells a
rank; None: the world group).  The caller initializes the process group
(its backend, its rendezvous) and picks each rank's device; the port never
calls ``init_process_group``.  Every input is replicated: each rank
computes its share (a range of cells of the cell list, a range of rows of
the all-pairs blocks, a range of atoms of the reciprocal part) and the
shares are summed over the group, so that every rank returns the same full
result.  Every collective goes through :mod:`.collectives`.
"""


def __getattr__(name):
    # imported on first use: the ops modules import .collectives, and the
    # MD step imports them
    if name == "make_sharded_md_step":
        from .fused_shard import make_sharded_md_step
        return make_sharded_md_step
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
