"""Holonomic distance constraints.

Two solvers, chosen by ``make_constrainer`` as the JAX package chooses them
(its ``runtime/constraints.py:139-177``):

* SETTLE for isoceles rigid triangles on contiguous atom triples that cover
  every particle (the rigid-water box): closed-form positions (Miyamoto &
  Kollman, J. Comput. Chem. 13:952, 1992) and the one-shot 3x3 RATTLE
  velocity solve, in molecule-major dense layout with no gathers or
  scatters.  The reference plugin takes SETTLE from OpenMM core.
* Iterative M-SHAKE / RATTLE over gathered clusters of coupled constraints
  for every other layout (waters beside a solute, chains, wider clusters):
  a closed-form 3x3 solve for clusters of width 3, for wider ones a fixed
  number of CGLS iterations (the minimum-norm solution, as the JAX
  package's pseudo-inverse gives it), padded rows masked out.  Neither
  reads back to the host, so the MD step captures both in its CUDA
  graphs.

The JAX package's dense M-SHAKE triangle solver (contiguous triangles that
are not isoceles) has no copy here: such triangles take the gather solver,
whose width-3 solve is the same iteration in another data layout.
"""

import numpy as np
import torch

# M-SHAKE sweeps of the gather solver (the JAX package's default)
MSHAKE_ITERATIONS = 8


def cgls_iterations(width):
    """CGLS iterations of a width-C cluster's solve.  In exact arithmetic
    CGLS ends within rank(J) <= C iterations; in float32 the search
    directions lose their orthogonality and it takes up to four more (to
    come within 1e-6 of the pseudo-inverse's answer: rigid CH4, C = 10,
    14 at the position stage; an 11-wide chain 12; two waters joined by a
    constraint, C = 7, 10), so 3C/2, which
    tests/test_torch_wide_constraints.py holds to 1e-5 in float32."""
    return (3 * width + 1) // 2


def cgls_solve(J, b, iterations):
    """Minimum-norm least-squares solutions of the batched systems
    J x = b (J (..., C, C), b (..., C)) by ``iterations`` steps of CGLS,
    conjugate gradients on Jᵀ J x = Jᵀ b from x = 0: every iterate lies in
    the range of Jᵀ, so a singular but consistent block (rigid CH4: 10
    constraints on 9 internal degrees of freedom) gets pinv(J) b.  Only
    elementwise work and sums over the blocks, a fixed number of them:
    no host sync, and the same operations in the same order every call.
    A block whose residual vanishes stops moving (its step sizes are
    0 / tiny)."""
    tiny = torch.finfo(J.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    s = torch.sum(J * r[..., :, None], dim=-2)                  # Jᵀ r
    p = s
    gamma = torch.sum(s * s, dim=-1, keepdim=True)
    for _ in range(iterations):
        q = torch.sum(J * p[..., None, :], dim=-1)              # J p
        alpha = gamma / torch.clamp(torch.sum(q * q, dim=-1, keepdim=True),
                                    min=tiny)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, q, value=-1.0)
        s = torch.sum(J * r[..., :, None], dim=-2)
        gamma_new = torch.sum(s * s, dim=-1, keepdim=True)
        p = torch.addcmul(s, gamma_new / torch.clamp(gamma, min=tiny), p)
        gamma = gamma_new
    return x


def _contiguous_triangles(pairs, n_particles):
    """True if cluster m constrains exactly atoms (3m, 3m+1, 3m+2) as the
    triangle [[0,1],[0,2],[1,2]] and every particle belongs to one cluster —
    the rigid-water layout."""
    m = pairs.shape[0]
    if n_particles != 3 * m:
        return False
    base = 3 * np.arange(m, dtype=pairs.dtype)[:, None, None]
    expect = base + np.array([[[0, 1], [0, 2], [1, 2]]], dtype=pairs.dtype)
    return bool(np.array_equal(pairs, expect))


def cluster_constraints(constraints, n_particles):
    """Group (i, j, distance) constraints into independent clusters of
    coupled constraints, each padded to the widest cluster C >= 3 with inert
    rows (pair (0, 0), distance 0, mask 0).

    Returns (pairs (M, C, 2) int32, dists (M, C) f64, mask (M, C) f64), or
    None when ``constraints`` is empty.
    """
    cons = [(int(i), int(j), float(d)) for i, j, d in constraints]
    if not cons:
        return None
    parent = list(range(len(cons)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    atom_owner = {}
    for k, (i, j, _) in enumerate(cons):
        for a in (i, j):
            if a in atom_owner:
                ra, rk = find(atom_owner[a]), find(k)
                if ra != rk:
                    parent[rk] = ra
            else:
                atom_owner[a] = k
    clusters = {}
    for k in range(len(cons)):
        clusters.setdefault(find(k), []).append(k)
    width = max(3, max(len(members) for members in clusters.values()))
    pairs, dists, mask = [], [], []
    for members in clusters.values():
        p = [[cons[k][0], cons[k][1]] for k in members]
        d = [cons[k][2] for k in members]
        m = [1.0] * len(members)
        while len(p) < width:
            p.append([0, 0])
            d.append(0.0)
            m.append(0.0)
        pairs.append(p)
        dists.append(d)
        mask.append(m)
    return (np.asarray(pairs, dtype=np.int32),
            np.asarray(dists, dtype=np.float64),
            np.asarray(mask, dtype=np.float64))


def _isoceles_triangles(pairs, dists, masses):
    """True when every contiguous-triangle cluster is a SETTLE-shaped rigid
    body: |AB| == |AC| (two equal legs) and m_B == m_C."""
    d = np.asarray(dists, dtype=np.float64).reshape(-1, 3)
    m3 = np.asarray(masses, dtype=np.float64).reshape(-1, 3)
    return bool(np.all(np.abs(d[:, 0] - d[:, 1]) <= 1e-12 * d[:, 0])
                and np.all(m3[:, 1] == m3[:, 2])
                and np.all(m3 > 0.0))


def _rows(x):
    """(3M, 3) -> (3, M, 3): atoms a, b, c of every molecule."""
    return x.reshape(-1, 3, 3).transpose(0, 1)


def _dot(u, v):
    return torch.sum(u * v, dim=-1, keepdim=True)


def _solve3(J, b):
    """Closed-form solve of the per-molecule 3x3 systems J x = b; J is a 3x3
    nested list and b a list of 3 of (M, 1) tensors."""
    c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
    c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
    c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
    c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
    c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
    c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
    c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
    c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
    c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
    inv_det = 1.0 / (J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02)
    return [(c00 * b[0] + c01 * b[1] + c02 * b[2]) * inv_det,
            (c10 * b[0] + c11 * b[1] + c12 * b[2]) * inv_det,
            (c20 * b[0] + c21 * b[1] + c22 * b[2]) * inv_det]


class SettleConstrainer:
    """SETTLE positions and RATTLE velocities for isoceles rigid triangles
    on contiguous atom triples.  Per-molecule geometry and masses are kept
    as float64 host arrays and moved to the positions' device and dtype on
    first use."""

    # no host sync: the MD step captures it in its CUDA graphs
    capturable = True

    def __init__(self, dists, masses):
        d = np.asarray(dists, dtype=np.float64).reshape(-1, 3)
        m3 = np.asarray(masses, dtype=np.float64).reshape(-1, 3)
        ma, mb = m3[:, 0], m3[:, 1]               # m_C == m_B (checked)
        # canonical triangle: A at (0, ra), B/C at (-+rc, -rb); COM at origin
        rc = 0.5 * d[:, 2]
        t = np.sqrt(d[:, 0] ** 2 - rc ** 2)
        ra = 2.0 * mb * t / (ma + 2.0 * mb)
        inv3 = 1.0 / m3
        li, lj = (0, 0, 1), (1, 2, 2)
        # RATTLE coupling S[k][l] of constraints k and l through shared atoms
        s = [[inv3[:, li[k]] * ((li[k] == li[l]) - (li[k] == lj[l]))
              - inv3[:, lj[k]] * ((lj[k] == li[l]) - (lj[k] == lj[l]))
              for l in range(3)] for k in range(3)]
        self._host = dict(
            ra=ra, rb=t - ra, rc=rc, wa=ma / (ma + 2.0 * mb),
            wb=mb / (ma + 2.0 * mb), inv_m=inv3.T[..., None],
            s=np.asarray(s)[..., None])
        self._cache = {}

    def consts(self, like):
        """The per-molecule constants in the dtype and on the device of
        ``like``, made once for each: ``ra``, ``rb``, ``rc``, ``wa``,
        ``wb`` (M, 1), the inverse masses ``inv_m`` (3, M, 1) of atoms a,
        b, c and RATTLE's coupling ``s`` (3, 3, M, 1)."""
        key = (like.device, like.dtype)
        if key not in self._cache:
            consts = {}
            for name, v in self._host.items():
                t = torch.as_tensor(v, device=like.device).to(like.dtype)
                consts[name] = t[:, None] if t.dim() == 1 else t  # (M, 1)
            self._cache[key] = consts
        return self._cache[key]

    def project_positions(self, pos_ref, pos_new):
        """Constrained positions from the unconstrained update ``pos_new``
        of the constrained ``pos_ref`` (both (3M, 3))."""
        c = self.consts(pos_new)
        ra, rb, rc = c["ra"], c["rb"], c["rc"]
        a0, b0, c0 = _rows(pos_ref)
        a1, b1, c1 = _rows(pos_new)
        com = c["wa"] * a1 + c["wb"] * (b1 + c1)
        a1, b1, c1 = a1 - com, b1 - com, c1 - com
        b0a = b0 - a0
        c0a = c0 - a0
        # primed frame: Z' normal to the OLD triangle plane, X' = a1 x Z'
        # (so the new A sits in the Y'Z' plane), Y' = Z' x X'
        ez = torch.cross(b0a, c0a, dim=-1)
        ez = ez * torch.rsqrt(_dot(ez, ez))
        ex = torch.cross(a1, ez, dim=-1)
        ex = ex * torch.rsqrt(_dot(ex, ex))
        ey = torch.cross(ez, ex, dim=-1)

        def rot(v):                               # world -> primed
            return _dot(ex, v), _dot(ey, v), _dot(ez, v)

        xb0, yb0, _ = rot(b0a)
        xc0, yc0, _ = rot(c0a)
        _, ya1, za1 = rot(a1)
        xb1, yb1, zb1 = rot(b1)
        xc1, yc1, zc1 = rot(c1)

        # out-of-plane tilt phi and HH twist psi from the unconstrained
        # z-coordinates (momentum conservation along the old plane normal)
        sinphi = za1 / ra
        cosphi = torch.sqrt(torch.clamp(1.0 - sinphi * sinphi, min=0.0))
        sinpsi = (zb1 - zc1) / (2.0 * rc * cosphi)
        cospsi = torch.sqrt(torch.clamp(1.0 - sinpsi * sinpsi, min=0.0))

        ya2 = ra * cosphi
        xb2 = -rc * cospsi
        yb2 = -rb * cosphi - rc * sinpsi * sinphi
        yc2 = -rb * cosphi + rc * sinpsi * sinphi

        # in-plane rotation theta from the SHAKE-displacement condition
        al = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
        be = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
        ga = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0
        a2b2 = al * al + be * be
        sinth = ((al * ga - be * torch.sqrt(torch.clamp(a2b2 - ga * ga,
                                                        min=0.0))) / a2b2)
        costh = torch.sqrt(torch.clamp(1.0 - sinth * sinth, min=0.0))

        xa3 = -ya2 * sinth
        ya3 = ya2 * costh
        za3 = ra * sinphi
        xb3 = xb2 * costh - yb2 * sinth
        yb3 = xb2 * sinth + yb2 * costh
        zb3 = -rb * sinphi + rc * sinpsi * cosphi
        xc3 = -xb2 * costh - yc2 * sinth
        yc3 = -xb2 * sinth + yc2 * costh
        zc3 = -rb * sinphi - rc * sinpsi * cosphi

        def unrot(x, y, z):                       # primed -> world + COM
            return ex * x + ey * y + ez * z + com

        out = torch.stack([unrot(xa3, ya3, za3), unrot(xb3, yb3, zb3),
                           unrot(xc3, yc3, zc3)], dim=1)
        return out.reshape(-1, 3)

    def project_velocities(self, pos, vel):
        """RATTLE: remove the velocity components along the constraints."""
        c = self.consts(vel)
        a, b, cc = _rows(pos)
        va, vb, vc = _rows(vel)
        rn = [a - b, a - cc, b - cc]
        vrel = [va - vb, va - vc, vb - vc]
        rhs = [_dot(rn[k], vrel[k]) for k in range(3)]
        s = c["s"]
        J = [[s[k, l] * _dot(rn[k], rn[l]) for l in range(3)]
             for k in range(3)]
        lam = _solve3(J, rhs)
        t = [lam[k] * rn[k] for k in range(3)]
        inv_m = c["inv_m"]
        va = va - (t[0] + t[1]) * inv_m[0]
        vb = vb - (-t[0] + t[2]) * inv_m[1]
        vc = vc - (-t[1] - t[2]) * inv_m[2]
        return torch.stack([va, vb, vc], dim=1).reshape(-1, 3)


class GatherConstrainer:
    """M-SHAKE positions and RATTLE velocities over clusters of coupled
    distance constraints, gathered from and scattered to the atom array
    (``_make_gather_constrainer``, JAX ``runtime/constraints.py:430-535``).
    Clusters of width 3 take a closed-form solve, wider ones
    :func:`cgls_solve` where the JAX package takes ``jnp.linalg.pinv``.

    ``pairs`` (M, C, 2) atom pairs, ``dists`` (M, C) target distances,
    ``mask`` (M, C) with 0 on the inert padded rows of clusters narrower
    than C (or None).  Constants are float64 host arrays, moved to the
    positions' device and dtype on first use.
    """

    # no host sync at any width: the MD step captures it in its CUDA graphs
    capturable = True

    def __init__(self, pairs, dists, masses, mask=None):
        m, width = pairs.shape[0], pairs.shape[1]
        self.width = width
        i_idx = pairs[..., 0].astype(np.int64)
        j_idx = pairs[..., 1].astype(np.int64)
        masses = np.asarray(masses, dtype=np.float64)
        inv_mass = np.where(masses > 0, 1.0 / np.maximum(masses, 1e-300), 0.0)
        # coupling S[k, l] of constraints k and l through shared atoms
        s = np.zeros((m, width, width))
        for k in range(width):
            for l in range(width):
                ik, jk = i_idx[:, k], j_idx[:, k]
                il, jl = i_idx[:, l], j_idx[:, l]
                s[:, k, l] = (inv_mass[ik] * (ik == il)
                              - inv_mass[ik] * (ik == jl)
                              - inv_mass[jk] * (jk == il)
                              + inv_mass[jk] * (jk == jl))
        host = dict(d2=np.asarray(dists, dtype=np.float64).reshape(m, width)
                    ** 2, im_i=inv_mass[i_idx], im_j=inv_mass[j_idx], s=s)
        self._masked = mask is not None
        if self._masked:
            # padded rows: unit diagonal + zero rhs -> lambda = 0, and zero
            # coupling so they never perturb the real constraints; their
            # inverse masses are zeroed so a round-off lambda moves nothing
            mask = np.asarray(mask, dtype=np.float64).reshape(m, width)
            host["mm"] = mask[:, :, None] * mask[:, None, :]
            host["jfill"] = np.eye(width)[None] * (1.0 - mask[:, :, None])
            host["row_mask"] = mask
            host["im_i"] = host["im_i"] * mask
            host["im_j"] = host["im_j"] * mask
        self._host = host
        # each cluster's atoms (in the order they first appear; a cluster
        # names each atom once and no atom lies in two clusters) and the
        # map from its constraints' corrections to them, P[m, a, k] =
        # invM_a (+1 if atom a is constraint k's i, -1 if its j): an atom's
        # correction is a sum over its own cluster in a fixed order, and
        # each atom receives one add
        live = (np.ones((m, width)) if mask is None
                else np.asarray(mask).reshape(m, width)) != 0
        members = [list(dict.fromkeys(
            a for k in range(width) if live[c, k]
            for a in (i_idx[c, k], j_idx[c, k]))) for c in range(m)]
        size = max(1, max(len(a) for a in members))
        atoms = np.full((m, size), -1, dtype=np.int64)
        P = np.zeros((m, size, width))
        for c, names in enumerate(members):
            atoms[c, :len(names)] = names
            for k in range(width):
                if live[c, k]:
                    P[c, names.index(i_idx[c, k]), k] += inv_mass[i_idx[c, k]]
                    P[c, names.index(j_idx[c, k]), k] -= inv_mass[j_idx[c, k]]
        flat = atoms.reshape(-1)
        named = np.nonzero(flat >= 0)[0]
        if np.unique(flat[named]).size != named.size:
            raise ValueError("GatherConstrainer: an atom lies in two "
                             "constraint clusters")
        host["P"] = P
        self._index = dict(i=i_idx, j=j_idx, atoms=flat[named])
        if named.size != flat.size:
            self._index["named"] = named
        self._cache = {}

    def _consts(self, like):
        key = (like.device, like.dtype)
        if key not in self._cache:
            c = {k: torch.as_tensor(v, device=like.device).to(like.dtype)
                 for k, v in self._host.items()}
            c.update({k: torch.as_tensor(v, device=like.device)
                      for k, v in self._index.items()})
            self._cache[key] = c
        return self._cache[key]

    def _solve(self, J, b):
        if self.width == 3:
            x = _solve3([[J[..., k, l:l + 1] for l in range(3)]
                         for k in range(3)],
                        [b[..., k:k + 1] for k in range(3)])
            return torch.cat(x, dim=-1)
        # minimum-norm least squares: wide clusters are often redundant
        # (rigid CH4: 10 distance constraints on 9 internal DOF), making
        # the Newton matrix singular but the system consistent
        return cgls_solve(J, b, cgls_iterations(self.width))

    def _mask(self, c, J, rhs):
        if not self._masked:
            return J, rhs
        return J * c["mm"] + c["jfill"], rhs * c["row_mask"]

    def _scatter(self, c, x, lam, r_dir):
        """x - invM * sum_k lam_k r_dir_k on both atoms of every pair."""
        # (a broadcast product and a sum: cuBLAS's batched product of the
        # many 3 x 3 blocks took 16 us a call on an H100)
        w = lam[..., None] * r_dir                              # (M, C, 3)
        delta = torch.sum(c["P"][..., None] * w[:, None], dim=2)
        delta = delta.reshape(-1, 3)
        if "named" in c:
            delta = delta[c["named"]]
        return x.index_add(0, c["atoms"], delta, alpha=-1)

    def project_positions(self, pos_ref, pos_new):
        """Iteratively restore |r_ij| = d along the reference directions."""
        c = self._consts(pos_new)
        i, j = c["i"], c["j"]
        r_ref = pos_ref[i] - pos_ref[j]                         # (M, C, 3)
        pos = pos_new
        for _ in range(MSHAKE_ITERATIONS):
            r_now = pos[i] - pos[j]
            sigma = torch.sum(r_now * r_now, dim=-1) - c["d2"]
            dots = torch.einsum("mkx,mlx->mkl", r_now, r_ref)
            J, rhs = self._mask(c, 4.0 * c["s"] * dots, sigma)
            pos = self._scatter(c, pos, 2.0 * self._solve(J, rhs), r_ref)
        return pos

    def project_velocities(self, pos, vel):
        """RATTLE: remove the velocity components along the constraints."""
        c = self._consts(vel)
        i, j = c["i"], c["j"]
        r_now = pos[i] - pos[j]
        v_rel = vel[i] - vel[j]
        rhs = torch.sum(r_now * v_rel, dim=-1)
        dots = torch.einsum("mkx,mlx->mkl", r_now, r_now)
        J, rhs = self._mask(c, c["s"] * dots, rhs)
        return self._scatter(c, vel, self._solve(J, rhs), r_now)


def make_constrainer(pairs, dists, masses, n_particles, mask=None):
    """(project_positions, project_velocities) for clustered constraints
    ``pairs`` (M, C, 2) with target ``dists`` (M, C) and padded-row
    ``mask`` (M, C) or None.  SETTLE takes contiguous isoceles triangles
    that cover every particle; every other layout takes the gather solver
    (MSHAKE_ITERATIONS sweeps), contiguous triangles that are not isoceles
    included: its closed-form solve of width-3 clusters is the M-SHAKE
    iteration of the JAX package's dense triangle solver in another data
    layout."""
    pairs = np.asarray(pairs, dtype=np.int32)
    if pairs.ndim != 3:
        pairs = pairs.reshape(-1, 3, 2)
    if mask is not None and np.all(np.asarray(mask) == 1.0):
        mask = None
    if (pairs.shape[1] == 3 and mask is None
            and _contiguous_triangles(pairs, n_particles)
            and _isoceles_triangles(pairs, dists, masses)):
        settle = SettleConstrainer(dists, masses)
        return settle.project_positions, settle.project_velocities
    solver = GatherConstrainer(pairs, dists, masses, mask=mask)
    return solver.project_positions, solver.project_velocities
