"""Multi-device evaluation on ``torch.distributed``: the JAX package's
``parallel/mesh.py`` and ``parallel/pme_shard.py``.

A rank is one process with its own device; the JAX package's mesh axis is
a ``torch.distributed`` process group, passed as ``shard=`` to
``ops.engine.make_compute`` and as ``group`` to
:func:`.mesh.make_sharded_compute` (None: the world group).  The caller
initializes the process group (its backend, its rendezvous) and picks each
rank's device; the port never calls ``init_process_group``.  Every input is
replicated: each rank computes its share (a range of cells of the cell
list, a range of rows of the all-pairs blocks, a range of atoms of the
reciprocal part) and the shares are summed over the group, so that every
rank returns the same full slice energies and forces.  Every collective
goes through :mod:`.collectives`.
"""
