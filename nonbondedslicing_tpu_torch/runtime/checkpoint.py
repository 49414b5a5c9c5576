"""Context checkpoint / resume (a copy of the JAX package's
``runtime/checkpoint.py``).

The reference relies on OpenMM core for positions/velocities checkpointing
and on its XML proxy for the force definition.  Here
both live in the framework: ``create_checkpoint`` captures the full dynamic
state of a Context (positions, velocities, box vectors, global parameters)
into a portable npz blob; ``load_checkpoint`` restores it into a compatible
Context.  The force definition itself round-trips through
``serialization.XmlSerializer``.
"""

import io

import numpy as np

from ..models.force import OpenMMException


def create_checkpoint(context) -> bytes:
    """Serialize a Context's dynamic state into a bytes blob."""
    buf = io.BytesIO()
    params = context.getParameters()
    np.savez(
        buf,
        positions=np.asarray(context._positions, dtype=np.float64),
        velocities=np.asarray(context._velocities, dtype=np.float64),
        box=np.asarray(context._box, dtype=np.float64),
        # fixed-width unicode (not object) so the npz round-trips without
        # pickle — np.load(allow_pickle=True) on untrusted blobs would allow
        # arbitrary code execution
        param_names=np.array(list(params.keys()), dtype=np.str_),
        param_values=np.array(list(params.values()), dtype=np.float64),
    )
    return buf.getvalue()


def load_checkpoint(context, blob: bytes) -> None:
    """Restore a Context's dynamic state from ``create_checkpoint`` output."""
    try:
        data = np.load(io.BytesIO(blob), allow_pickle=False)
        param_names = data["param_names"]
    except ValueError as exc:
        # pre-hardening checkpoints stored param_names with object dtype,
        # which allow_pickle=False rejects with an opaque numpy error
        raise OpenMMException(
            "loadCheckpoint: this checkpoint predates the non-pickled "
            "format (or is corrupted) and cannot be loaded safely; "
            "re-create it with createCheckpoint()") from exc
    n = context.getSystem().getNumParticles()
    positions = data["positions"]
    if positions.shape != (n, 3):
        raise OpenMMException(
            "loadCheckpoint: checkpoint was created with a different System "
            f"({positions.shape[0]} particles, expected {n})")
    context._positions = positions.copy()
    context._velocities = data["velocities"].copy()
    context._box = data["box"].copy()
    for name, value in zip(param_names, data["param_values"]):
        if str(name) in context._parameters:
            context._parameters[str(name)] = float(value)
