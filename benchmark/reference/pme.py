"""The plain reference of a configuration whose ``method`` is ``"PME"``:
the sliced Coulomb and Lennard-Jones model of :mod:`reference.sliced`."""

from reference.sliced import SlicedPME


def model(spec, device, mode="f64", skin=0.0):
    """A :class:`reference.sliced.SlicedPME` of ``spec`` on the
    evaluation's grid (what it gives: :mod:`reference`)."""
    return SlicedPME(spec, device, mode, skin=skin)
