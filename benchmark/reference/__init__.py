"""The plain reference of the benchmark: the sliced nonbonded energy, its
per-slice dE/dlambda and forces under PME, and the constrained leapfrog
step, in plain PyTorch and float64.  It imports nothing of the program
under test or of JAX, and works out again what the program derives at
set-up (the Ewald alpha, the PME grids, the slices, the exclusions).

A configuration's ``"method"`` names its reference: the module
``reference/<method in lower case>.py`` (``"PME"``: :mod:`reference.pme`),
which :func:`harness.catalog.reference` finds.  Such a module exposes one
function, ``model(spec, device, mode="f64", skin=0.0)``, of the
configuration's :class:`harness.spec.Spec` on the torch device
``device``, in the arithmetic ``mode`` of :mod:`reference.precision`
(``"f64"``, or ``"tf32"`` for the control), with the Verlet-list skin
``skin`` in nm (0: a fresh pair search at every call).  It returns an
object with:

* ``evaluate(pos, energies=True)``: (slice energies (S, 2) float64, or
  None without ``energies``; forces (N, 3) in ``dtype``) at ``pos``;
* ``energy(slice_e)``: the total energy, each slice scaled by its lambda;
* ``derivatives(slice_e)``: {parameter name: dE/dlambda};
* ``device``, ``dtype``, ``mode`` and ``R``, the rounding of ``mode``
  (:func:`reference.precision.rounder`), which :class:`reference.md.Integrator`
  applies to each step;
* ``box64``: the box edges, (3,) float64 on ``device``;
* ``excluded_keys``: the sorted keys i * N + j (i < j) of the pairs that
  the pair sums leave out, for :func:`reference.pairs.count_within`.

The bonds are not the model's: :func:`reference.md.bond_terms` adds them."""
