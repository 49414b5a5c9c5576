"""The plain reference of the benchmark: the sliced nonbonded energy, its
per-slice dE/dlambda and forces under PME, and the constrained leapfrog
step, in plain PyTorch and float64.  It imports nothing of the program
under test or of JAX, and works out again what the program derives at
set-up (the Ewald alpha, the PME grids, the slices, the exclusions)."""
