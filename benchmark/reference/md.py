"""The MD step of the reference: leapfrog Verlet with distance
constraints and harmonic bonds, in float64 (in TF32 for the control).

    v' = v + dt F(x) / m
    x' = SHAKE(x, x + dt v')        corrections along the bonds at x
    v'' = RATTLE((x' - x) / dt)     no velocity along a bond at x'

SHAKE is solved by Newton's method on each cluster of coupled constraints
until every bond length is right to 1e-13, and RATTLE exactly, so that the
step is the one that SETTLE and converged M-SHAKE take.  Bond vectors are
taken as they are (a HarmonicBondForce without periodic conditions).
"""

import numpy as np
import torch


class NotConverged(RuntimeError):
    """SHAKE found no positions that hold every bond in float64."""


def clusters(constraints, n_atoms):
    """(cons (M, C) constraint indices, padded with -1) of the connected
    groups of ``constraints`` (K, 2)."""
    parent = np.arange(n_atoms)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in constraints:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri
    groups = {}
    for c, (i, _) in enumerate(constraints):
        groups.setdefault(find(int(i)), []).append(c)
    width = max(len(g) for g in groups.values())
    return np.array([g + [-1] * (width - len(g)) for g in groups.values()],
                    dtype=np.int64)


def small_solve(A, b):
    """x of A x = b for a batch of small matrices A (M, C, C), b (M, C), by
    Gauss-Jordan elimination without pivoting in elementwise operations
    (SHAKE's and RATTLE's matrices have a dominant positive diagonal).  A
    pivot that vanishes in float32 (the control's rounded state) is held
    at the smallest normal number."""
    A = A.clone()
    b = b.clone()
    tiny = torch.finfo(A.dtype).tiny
    C = A.shape[-1]
    for k in range(C):
        piv = A[:, k, k]
        piv = torch.where(piv.abs() < tiny, torch.full_like(piv, tiny), piv)
        A[:, k, k] = piv
        for r in range(C):
            if r != k:
                f = A[:, r, k] / piv
                A[:, r, :] -= f[:, None] * A[:, k, :]
                b[:, r] -= f * b[:, k]
    return b / torch.diagonal(A, dim1=-2, dim2=-1)


class Constraints:
    """SHAKE and RATTLE over the clusters of ``spec``'s constraints."""

    def __init__(self, spec, device, dtype=torch.float64):
        cons = np.asarray(spec.constraints, dtype=np.int64)
        self.empty = len(cons) == 0
        if self.empty:
            return
        groups = clusters(cons, spec.n_atoms)
        valid = groups >= 0
        g = np.where(valid, groups, 0)
        t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)  # noqa
        self.i = t(cons[g, 0], torch.int64)                  # (M, C)
        self.j = t(cons[g, 1], torch.int64)
        self.d2 = t(np.where(valid, spec.constraint_dists[g], 1.0) ** 2,
                    dtype)
        self.valid = t(valid, dtype)
        inv_m = 1.0 / np.asarray(spec.masses, dtype=np.float64)
        self.inv_m = t(inv_m, dtype)
        # coef[m, c, c']: d(x_i(c) - x_j(c)) / d g(c') in units of r(c')
        ic, jc = cons[g, 0], cons[g, 1]
        coef = ((ic[:, :, None] == ic[:, None, :]) * inv_m[ic][:, :, None]
                - (ic[:, :, None] == jc[:, None, :]) * inv_m[ic][:, :, None]
                - (jc[:, :, None] == ic[:, None, :]) * inv_m[jc][:, :, None]
                + (jc[:, :, None] == jc[:, None, :]) * inv_m[jc][:, :, None])
        coef = coef * valid[:, :, None] * valid[:, None, :]
        self.coef = t(coef, dtype)
        self.eye = t(np.eye(groups.shape[1])[None] * (~valid)[:, :, None],
                     dtype)

    def _apply(self, x, g, vec):
        """x with the corrections g (M, C) along vec (M, C, 3)."""
        w = (g * self.valid)[..., None] * vec
        out = x.clone()
        out.index_add_(0, self.i.reshape(-1),
                       (w * self.inv_m[self.i][..., None]).reshape(-1, 3))
        out.index_add_(0, self.j.reshape(-1),
                       -(w * self.inv_m[self.j][..., None]).reshape(-1, 3))
        return out

    def positions(self, x_ref, x_new, max_iter=50):
        """SHAKE: to 1e-13 of every squared length in float64; in float32
        (the control) as far as float32 comes in ``max_iter`` steps."""
        if self.empty:
            return x_new
        double = x_new.dtype == torch.float64
        tol = 1e-13 if double else 1e-6
        r = x_ref[self.i] - x_ref[self.j]                    # (M, C, 3)
        g = torch.zeros(self.i.shape, dtype=x_new.dtype,
                        device=x_new.device)
        for _ in range(max_iter):
            x = self._apply(x_new, g, r)
            s = x[self.i] - x[self.j]
            f = (torch.sum(s * s, dim=-1) - self.d2) * self.valid
            if float(torch.max(torch.abs(f) / self.d2)) < tol:
                return x
            J = 2.0 * torch.einsum("mak,mab,mbk->mab", s, self.coef, r)
            g = g - small_solve(J + self.eye, f)
        if double:
            raise NotConverged("SHAKE did not converge")
        return self._apply(x_new, g, r)

    def velocities(self, x, v):
        if self.empty:
            return v
        s = x[self.i] - x[self.j]
        rel = torch.sum(s * (v[self.i] - v[self.j]), dim=-1) * self.valid
        A = torch.einsum("mak,mab,mbk->mab", s, self.coef, s)
        mu = small_solve(A + self.eye, -rel)
        return self._apply(v, mu, s)


def bond_terms(spec, pos):
    """(energy, forces) of the harmonic bonds k / 2 (r - r0)^2."""
    forces = torch.zeros_like(pos)
    if len(spec.bonds) == 0:
        return 0.0, forces
    b = torch.as_tensor(spec.bonds, device=pos.device).to(pos.dtype)
    i, j = b[:, 0].long(), b[:, 1].long()
    d = pos[i] - pos[j]
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    energy = float(torch.sum(0.5 * b[:, 3] * (r - b[:, 2]) ** 2))
    f = -(b[:, 3] * (r - b[:, 2]) / r)[:, None] * d
    forces.index_add_(0, i, f)
    forces.index_add_(0, j, -f)
    return energy, forces


class Integrator:
    """``steps(x, v, n)``: n leapfrog steps of the reference model ``model``
    (what a reference module's ``model`` returns: :mod:`reference`) with the
    system's bonds and constraints.  The update and the constraints run in
    the model's dtype."""

    def __init__(self, spec, model, dt):
        self.spec = spec
        self.model = model
        self.dt = float(dt)
        dev, dtype = model.device, model.dtype
        self.inv_m = torch.as_tensor(1.0 / np.asarray(spec.masses),
                                     device=dev).to(dtype)[:, None]
        self.cons = Constraints(spec, dev, dtype)

    def steps(self, x, v, n, stop_speed=None):
        """``n`` steps from (x, v); every result rounded as the model's
        arithmetic rounds (TF32 storage of the state for the control).
        With ``stop_speed`` (nm/ps) the steps end early, at the state
        reached, once an atom moves faster: a trajectory that has blown
        up, which the control's can."""
        dev, dtype, R = self.model.device, self.model.dtype, self.model.R
        x = R(torch.as_tensor(x, device=dev).to(dtype))
        v = R(torch.as_tensor(v, device=dev).to(dtype))
        for _ in range(int(n)):
            _, f = self.model.evaluate(x, energies=False)
            f = R(f + R(bond_terms(self.spec, x)[1]))
            v = R(v + R(self.dt * R(f * self.inv_m)))
            x_new = R(self.cons.positions(x, R(x + R(self.dt * v))))
            v = R(self.cons.velocities(x_new, R(R(x_new - x) / self.dt)))
            x = x_new
            if stop_speed is not None and not bool(
                    torch.all(torch.abs(v) < stop_speed)):
                break
        return x, v
