"""Periodic geometry helpers (minimum image, reciprocal box vectors)."""

import torch


def min_image(dr, box):
    """OpenMM's reduced-form triclinic minimum image: subtract rounded
    multiples of the box row vectors in the order c, b, a
    (``ReferenceForce::getDeltaRPeriodic``).  ``dr`` is (..., 3)."""
    for axis in (2, 1, 0):
        n = torch.floor(dr[..., axis] / box[axis, axis] + 0.5)
        dr = dr - n[..., None] * box[axis]
    return dr


def recip_box_vectors(box):
    """Reciprocal (inverse-transpose) row vectors of a reduced triclinic box
    (invert_box_vectors, ReferencePME.cpp:186-194); fractional coordinates
    are ``positions @ recip``."""
    scale = 1.0 / (box[0, 0] * box[1, 1] * box[2, 2])
    zero = torch.zeros((), dtype=box.dtype, device=box.device)
    r0 = torch.stack([box[1, 1] * box[2, 2], zero, zero]) * scale
    r1 = torch.stack([-box[1, 0] * box[2, 2], box[0, 0] * box[2, 2],
                      zero]) * scale
    r2 = torch.stack([box[1, 0] * box[2, 1] - box[1, 1] * box[2, 0],
                      -box[0, 0] * box[2, 1], box[0, 0] * box[1, 1]]) * scale
    return torch.stack([r0, r1, r2])


def box_volume(box):
    return box[0, 0] * box[1, 1] * box[2, 2]
