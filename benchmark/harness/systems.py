"""The benchmark's systems, built through any API of the port's shape (the
port's ``System`` / ``SlicedNonbondedForce`` / ``HarmonicBondForce``, or
the recording API of :mod:`harness.spec`, passed in as ``api``).

A frozen copy of the repository's ``port_systems.py`` builders, so that the
benchmark's inputs stay what they are when that file changes:

* ``water_system``: ``n_mol`` rigid 3-site waters (23,289 atoms in the
  6.1484 nm box of the benchmark state), 3 subsets, two lambda scaling
  parameters, PME (cutoff 0.9 nm, Ewald tolerance 5e-4).
* ``build_solute_system``: a flexible 12-site united-atom chain in a cavity
  of that box, decoupled by lambda_elec / lambda_vdw, with harmonic bonds.
* ``water_cube``: a smaller periodic cube cut from the state, for the
  tests' tiny boxes.
"""

import numpy as np

D_OH, D_HH = 0.09572, 0.15139
WATER_MASSES = (15.999, 1.008, 1.008)
# (charge, sigma nm, epsilon kJ/mol) of O, H, H
WATER_PARAMS = ((-0.834, 0.3151, 0.6364), (0.417, 0.04, 0.192),
                (0.417, 0.04, 0.192))

# the solute: a 12-site united-atom chain (TraPPE CH2)
SOLUTE_SITES = 12
SOLUTE_MASS, SOLUTE_SIGMA, SOLUTE_EPSILON = 14.027, 0.395, 0.382
SOLUTE_CHARGE = 0.25              # alternating +-, net 0
BOND_R0, BOND_K = 0.154, 2.5e5    # nm, kJ/mol/nm^2 (1-2)
ANGLE_R0, ANGLE_K = 0.258, 1.0e5  # 1-3 springs in place of angles
CAVITY_NM = 0.40                  # waters this close to a site are removed
SOLUTE_LAMBDAS = (0.5, 0.8)       # lambda_elec, lambda_vdw


def water_system(api, n_mol, box, method="PME"):
    """``n_mol`` rigid 3-site waters in a cubic ``box``: particles, the
    water-triangle exclusions, the subsets (first, second and last third of
    the molecules), the scaling parameters ``lambda01`` and ``lambda12``
    with their dE/dlambda requests.  Returns (system, force, constraints
    (pairs, dists)), the constraints not yet in the System
    (:func:`add_constraints`)."""
    force = api.SlicedNonbondedForce(3)
    force.setNonbondedMethod(getattr(api.SlicedNonbondedForce, method))
    force.setCutoffDistance(0.9)
    force.setEwaldErrorTolerance(5e-4)
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0), (0, 0, box))
    c_pairs, c_dists = [], []
    for k in range(n_mol):
        for mass, (q, sig, eps) in zip(WATER_MASSES, WATER_PARAMS):
            system.addParticle(mass)
            force.addParticle(q, sig, eps)
        o = 3 * k
        force.addException(o, o + 1, 0, 1, 0)
        force.addException(o, o + 2, 0, 1, 0)
        force.addException(o + 1, o + 2, 0, 1, 0)
        c_pairs.append([[o, o + 1], [o, o + 2], [o + 1, o + 2]])
        c_dists.append([D_OH, D_OH, D_HH])
    for k in range(n_mol):
        subset = 0 if k < n_mol // 3 else (1 if k < 2 * n_mol // 3 else 2)
        for a in range(3):
            force.setParticleSubset(3 * k + a, subset)
    force.addGlobalParameter("lambda01", 1.0)
    force.addScalingParameter("lambda01", 0, 1, True, True)
    force.addGlobalParameter("lambda12", 1.0)
    force.addScalingParameter("lambda12", 1, 2, True, True)
    force.addEnergyParameterDerivative("lambda01")
    force.addEnergyParameterDerivative("lambda12")
    system.addForce(force)
    return system, force, (c_pairs, c_dists)


def add_constraints(system, constraints):
    """The (pairs, dists) triangles of :func:`water_system` or
    :func:`build_solute_system` as the System's constraints, which a
    Context reads."""
    for tri, dists in zip(*constraints):
        for (i, j), d in zip(tri, dists):
            system.addConstraint(i, j, d)


def add_bonds(api, system, bonds):
    """The (M, 4) harmonic bonds (i, j, r0, k) of
    :func:`build_solute_system` as a HarmonicBondForce of the System."""
    force = api.HarmonicBondForce()
    for i, j, r0, k in bonds:
        force.addBond(int(i), int(j), float(r0), float(k))
    system.addForce(force)


def water_cube(water_positions, box_len, edge):
    """A periodic cube cut from the rigid-water box ``water_positions`` (3
    sites per molecule, cubic box ``box_len``) at that box's density.

    Each molecule is moved by whole box vectors to put its oxygen in the
    primary box, and the molecules whose oxygen lies in [0, edge) on every
    axis are kept, whole.  Across the faces of the new periodic box a kept
    pair may overlap: a molecule is removed, the one with the most such
    contacts first, while any pair across a face has two atoms closer than
    the closest pair of their kinds (O-O, O-H, H-H) of different molecules
    inside the cut.  The molecules are then moved rigidly, their oxygens
    scaled about the origin, into the cube whose edge gives the kept atoms
    the density of ``box_len``.  Returns (positions, edge)."""
    waters = np.asarray(water_positions, dtype=np.float64).reshape(-1, 3, 3)
    waters = waters - box_len * np.floor(waters[:, :1] / box_len)
    waters = waters[np.all(waters[:, 0] < edge, axis=1)]
    shift = -edge * np.round((waters[None, :, 0] - waters[:, None, 0]) / edge)
    d = (waters[None, :, None, :, :] + shift[:, :, None, None, :]
         - waters[:, None, :, None, :])
    r = np.sqrt(np.sum(d * d, axis=-1))           # (m, m, 3, 3) atom pairs
    kinds = np.minimum(np.arange(3), 1)           # O, H, H
    kind_pair = kinds[:, None] + kinds[None, :]   # 0 O-O, 1 O-H, 2 H-H
    across = np.any(shift != 0.0, axis=-1)
    inside = ~across & ~np.eye(len(waters), dtype=bool)
    closest = np.array([r[inside][:, kind_pair == k].min() for k in range(3)])
    contact = across & np.any(r < closest[kind_pair], axis=(2, 3))
    alive = np.ones(len(waters), dtype=bool)
    while True:
        counts = np.sum(contact & alive[None, :], axis=1) * alive
        if counts.max() == 0:
            break
        alive[counts.argmax()] = False
    waters = waters[alive]
    density = 3 * (len(water_positions) // 3) / box_len ** 3
    new_edge = float(np.cbrt(3 * len(waters) / density))
    waters = waters + (new_edge / edge - 1.0) * waters[:, :1]
    return waters.reshape(-1, 3), new_edge


def zigzag_chain(center):
    """(SOLUTE_SITES, 3) planar zig-zag chain centred on ``center``: 1-2
    distances BOND_R0, 1-3 distances ANGLE_R0, along x."""
    half = 0.5 * ANGLE_R0
    rise = np.sqrt(BOND_R0 ** 2 - half ** 2)
    k = np.arange(SOLUTE_SITES)
    chain = np.stack([(k - 0.5 * (SOLUTE_SITES - 1)) * half,
                      np.where(k % 2, 0.5 * rise, -0.5 * rise),
                      np.zeros(SOLUTE_SITES)], axis=1)
    return chain + np.asarray(center, dtype=np.float64)


def build_solute_system(api, water_positions, box_len, method="PME"):
    """One flexible 12-site united-atom chain (TraPPE CH2 LJ, charges
    +-0.25) at the box centre in a cavity of the rigid-water box
    ``water_positions`` (3 sites per molecule, cubic box ``box_len``): every
    water with an atom within CAVITY_NM of a chain site (minimum image) is
    removed.  Chain atoms come first (subset 0), then the kept waters
    (subset 1).  ``lambda_elec`` scales only the Coulomb part of slice
    (0, 1), ``lambda_vdw`` only its LJ part; dE/dlambda is requested for
    both.

    Returns (system, force, positions, masses, constraints, bonds, kept):
    ``constraints`` the water triangles (pairs, dists), ``bonds`` the (M, 4)
    harmonic 1-2 and 1-3 bonds (i, j, r0, k), ``kept`` the indices of the
    kept water atoms in ``water_positions``."""
    chain = zigzag_chain(np.full(3, 0.5 * box_len))
    waters = np.asarray(water_positions, dtype=np.float64).reshape(-1, 3, 3)
    d = waters[:, :, None, :] - chain[None, None]
    d -= box_len * np.round(d / box_len)
    keep = np.linalg.norm(d, axis=-1).min(axis=(1, 2)) >= CAVITY_NM
    kept = (3 * np.nonzero(keep)[0][:, None] + np.arange(3)).reshape(-1)
    ns = SOLUTE_SITES
    positions = np.concatenate([chain, waters[keep].reshape(-1, 3)])

    force = api.SlicedNonbondedForce(2)
    force.setNonbondedMethod(getattr(api.SlicedNonbondedForce, method))
    force.setCutoffDistance(0.9)
    force.setEwaldErrorTolerance(5e-4)
    system = api.System()
    system.setDefaultPeriodicBoxVectors((box_len, 0, 0), (0, box_len, 0),
                                        (0, 0, box_len))
    charges = SOLUTE_CHARGE * np.where(np.arange(ns) % 2, -1.0, 1.0)
    for i in range(ns):
        system.addParticle(SOLUTE_MASS)
        force.addParticle(float(charges[i]), SOLUTE_SIGMA, SOLUTE_EPSILON)
        force.setParticleSubset(i, 0)
    bonds = []
    for i in range(ns - 1):
        force.addException(i, i + 1, 0.0, 1.0, 0.0)
        bonds.append((i, i + 1, BOND_R0, BOND_K))
    for i in range(ns - 2):
        force.addException(i, i + 2, 0.0, 1.0, 0.0)
        bonds.append((i, i + 2, ANGLE_R0, ANGLE_K))
    for i in range(ns - 3):
        force.addException(i, i + 3, float(charges[i] * charges[i + 3]) / 1.2,
                           SOLUTE_SIGMA, 0.5 * SOLUTE_EPSILON)
    c_pairs, c_dists = [], []
    n_kept = int(keep.sum())
    for k in range(n_kept):
        o = ns + 3 * k
        for a, (mass, (q, sig, eps)) in enumerate(zip(WATER_MASSES,
                                                      WATER_PARAMS)):
            system.addParticle(mass)
            force.addParticle(q, sig, eps)
            force.setParticleSubset(o + a, 1)
        force.addException(o, o + 1, 0, 1, 0)
        force.addException(o, o + 2, 0, 1, 0)
        force.addException(o + 1, o + 2, 0, 1, 0)
        c_pairs.append([[o, o + 1], [o, o + 2], [o + 1, o + 2]])
        c_dists.append([D_OH, D_OH, D_HH])
    force.addGlobalParameter("lambda_elec", SOLUTE_LAMBDAS[0])
    force.addScalingParameter("lambda_elec", 0, 1, True, False)
    force.addGlobalParameter("lambda_vdw", SOLUTE_LAMBDAS[1])
    force.addScalingParameter("lambda_vdw", 0, 1, False, True)
    force.addEnergyParameterDerivative("lambda_elec")
    force.addEnergyParameterDerivative("lambda_vdw")
    system.addForce(force)
    masses = np.concatenate([np.full(ns, SOLUTE_MASS),
                             np.tile(WATER_MASSES, n_kept)])
    return (system, force, positions, masses, (c_pairs, c_dists),
            np.asarray(bonds, dtype=np.float64), kept)
