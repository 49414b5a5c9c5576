"""Holonomic distance constraints for rigid 3-site water.

Positions are projected with closed-form SETTLE (Miyamoto & Kollman,
J. Comput. Chem. 13:952, 1992) and velocities with the one-shot 3x3 RATTLE
solve, both in molecule-major dense layout over contiguous atom triples
(molecule m = atoms 3m, 3m+1, 3m+2): no gathers or scatters.  The reference
plugin takes SETTLE from OpenMM core for rigid waters.

Other solvers of the JAX package (iterative M-SHAKE triangles, general
clusters) are not ported yet (ROADMAP A11); ``make_constrainer`` raises for
the layouts that need them.
"""

import numpy as np
import torch


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

    def _consts(self, like):
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
        c = self._consts(pos_new)
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
        c = self._consts(vel)
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


def make_constrainer(pairs, dists, masses, n_particles, mask=None):
    """(project_positions, project_velocities) for rigid-water constraints:
    ``pairs`` (M, 3, 2) contiguous triangles with isoceles geometry and
    equal hydrogen masses.  Other layouts raise NotImplementedError."""
    pairs = np.asarray(pairs, dtype=np.int32)
    if pairs.ndim != 3:
        pairs = pairs.reshape(-1, 3, 2)
    if mask is not None and np.all(np.asarray(mask) == 1.0):
        mask = None
    if (pairs.shape[1] != 3 or mask is not None
            or not _contiguous_triangles(pairs, n_particles)
            or not _isoceles_triangles(pairs, dists, masses)):
        raise NotImplementedError(
            "constraints: only SETTLE on contiguous isoceles water "
            "triangles is ported; M-SHAKE triangles and general clusters "
            "are not yet (ROADMAP A11)")
    settle = SettleConstrainer(dists, masses)
    return settle.project_positions, settle.project_velocities
