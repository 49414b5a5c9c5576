"""The sliced nonbonded energy under PME, in plain PyTorch.

The atoms fall into subsets; a slice is an unordered pair of subsets
(s, t), numbered t (t + 1) / 2 + s for s <= t.  Each slice has a Coulomb
and a Lennard-Jones energy, and each is scaled by the value of the scaling
parameter bound to it (1 where none is):

    E = sum over slices and terms of lambda[slice, term] E[slice, term]
    dE/dlambda_p = sum of the unscaled E[slice, term] bound to p.

The terms, with f = 138.935456 kJ mol^-1 nm e^-2 (OpenMM's 1 / 4 pi eps0):

* direct space, the pairs within the cutoff that are not exceptions:
  f q_i q_j erfc(alpha r) / r and 4 eps ((sig / r)^12 - (sig / r)^6),
  sig = (sig_i + sig_j) / 2, eps = sqrt(eps_i eps_j) (Lorentz-Berthelot);
* reciprocal space, smooth PME of order 5 on one charge grid per subset:
  E[(s, t)] = sum_k eterm(k) Re(Q_s(k) Q_t(k)*), halved for s = t;
* for every exception (excluded pairs included) the reciprocal space's
  share taken back, -f q_i q_j erf(alpha r) / r, and its own terms,
  f qq / r and 4 eps ((sig / r)^12 - (sig / r)^6), at any distance;
* the self energy -f alpha / sqrt(pi) sum q^2 and the neutralising plasma
  -f pi Q_s Q_t / (2 V alpha^2) (twice for s != t);
* the long-range dispersion correction of OpenMM's sliced force, per slice
  over the classes of equal (sigma, epsilon, subset), divided by the
  volume.

Forces are minus the gradient of E.  Every step runs in the precision of
:mod:`reference.precision`.
"""

import math

import numpy as np
import torch

from . import ewald, pairs
from .precision import dtype_of, rounder

ONE_4PI_EPS0 = 138.935456
# nm beyond cutoff + skin of the outer pair list a Verlet list is cut from
OUTER_SKIN = 0.5


def slice_sums(slice_e, sl, e_c, e_lj):
    """Adds the pair energies ``e_c`` and ``e_lj`` into their slices
    ``sl`` of ``slice_e`` (S, 2), one masked sum per slice (an
    ``index_add_`` onto S addresses would serialize its atomics)."""
    for s in range(slice_e.shape[0]):
        mask = sl == s
        slice_e[s, 0] += torch.sum(torch.where(mask, e_c, 0.0)
                                   .to(torch.float64))
        slice_e[s, 1] += torch.sum(torch.where(mask, e_lj, 0.0)
                                   .to(torch.float64))


def slice_index(s, t):
    """The slice of subsets ``s`` and ``t`` (ints, numpy arrays or
    tensors)."""
    if torch.is_tensor(s):
        hi, lo = torch.maximum(s, t), torch.minimum(s, t)
    else:
        hi, lo = np.maximum(s, t), np.minimum(s, t)
    return hi * (hi + 1) // 2 + lo


class SlicedPME:
    """The energy, the per-slice energies and the forces of one system
    (:class:`harness.spec.Spec`) at given positions.  ``grid`` is the PME
    grid (default: the evaluation's, :func:`reference.ewald.eval_grid`);
    ``skin`` widens the pair search so that :meth:`forces` can reuse a
    pair list while no atom has moved skin / 2."""

    def __init__(self, spec, device, mode="f64", grid=None, skin=0.0):
        if spec.method != "PME":
            raise ValueError(f"the reference computes PME, not {spec.method}")
        self.mode = mode
        self.R = rounder(mode)
        self.dtype = dtype_of(mode)
        self.device = torch.device(device)
        self.n = spec.n_atoms
        self.cutoff = spec.cutoff
        self.skin = float(skin)
        self.box64 = torch.as_tensor(spec.box, dtype=torch.float64,
                                     device=self.device)
        self.volume = float(np.prod(spec.box))
        self.alpha = ewald.alpha(spec.cutoff, spec.tolerance)
        self.grid = tuple(grid or ewald.eval_grid(spec.box, spec.cutoff,
                                                  spec.tolerance))
        S = spec.n_subsets * (spec.n_subsets + 1) // 2
        self.n_subsets = spec.n_subsets
        self.n_slices = S
        t = lambda a, dt=self.dtype: torch.as_tensor(  # noqa: E731
            np.asarray(a), device=self.device).to(dt)
        self.q = t(spec.charges)
        self.sig = t(spec.sigmas)
        self.eps = t(spec.epsilons)
        self.subset = t(spec.subsets, torch.int64)
        self.box = t(spec.box)

        # lambda per (slice, term) and the derivative masks
        lam = np.ones((S, 2))
        self.deriv_names = list(spec.derivatives)
        masks = {name: np.zeros((S, 2)) for name in self.deriv_names}
        for name, s1, s2, coul, lj in spec.scaling:
            sl = int(slice_index(s1, s2))
            for term, on in ((0, coul), (1, lj)):
                if on:
                    lam[sl, term] = spec.globals[name]
                    if name in masks:
                        masks[name][sl, term] = 1.0
        self.lam64 = torch.as_tensor(lam, dtype=torch.float64,
                                     device=self.device)
        self.lam = self.lam64.to(self.dtype)
        self.masks = {k: torch.as_tensor(v, dtype=torch.float64,
                                         device=self.device)
                      for k, v in masks.items()}

        # exceptions: excluded from the pair sums, corrected and added
        exc = np.asarray(spec.exceptions, dtype=np.int64).reshape(-1, 2)
        lo, hi = np.minimum(exc[:, 0], exc[:, 1]), np.maximum(exc[:, 0],
                                                              exc[:, 1])
        self.excluded_keys = torch.as_tensor(
            np.unique(lo * self.n + hi), device=self.device)
        self.exc_i = t(lo, torch.int64)
        self.exc_j = t(hi, torch.int64)
        self.exc_params = t(spec.exception_params)
        self.exc_slice = t(slice_index(spec.subsets[lo], spec.subsets[hi]),
                           torch.int64)

        # energies that do not depend on the positions (float64 always)
        q64 = np.asarray(spec.charges, dtype=np.float64)
        sub = np.asarray(spec.subsets)
        const = np.zeros((S, 2))
        qs = np.array([q64[sub == s].sum() for s in range(spec.n_subsets)])
        for s in range(spec.n_subsets):
            d = int(slice_index(s, s))
            const[d, 0] -= (ONE_4PI_EPS0 * self.alpha / math.sqrt(math.pi)
                            * np.sum(q64[sub == s] ** 2))
            for u in range(s, spec.n_subsets):
                mult = 1.0 if u == s else 2.0
                const[int(slice_index(s, u)), 0] -= (
                    mult * ONE_4PI_EPS0 * math.pi * qs[s] * qs[u]
                    / (2.0 * self.volume * self.alpha ** 2))
        const[:, 1] += dispersion_coefficients(spec) / self.volume
        self.const = torch.as_tensor(const, dtype=torch.float64,
                                     device=self.device)

        # reciprocal space: eterm on the z-half spectrum and its weights
        nx, ny, nz = self.grid
        L = spec.box

        def freq(n, length):
            k = np.arange(n)
            return np.where(k < (n + 1) // 2, k, k - n) / length

        mx, my = freq(nx, L[0]), freq(ny, L[1])
        mz = np.arange(nz // 2 + 1) / L[2]
        m2 = (mx[:, None, None] ** 2 + my[None, :, None] ** 2
              + mz[None, None, :] ** 2)
        mods = (ewald.moduli(nx)[:, None, None]
                * ewald.moduli(ny)[None, :, None]
                * ewald.moduli(nz)[None, None, :nz // 2 + 1])
        with np.errstate(divide="ignore", invalid="ignore"):
            eterm = (ONE_4PI_EPS0 * np.exp(-math.pi ** 2 * m2
                                           / self.alpha ** 2)
                     / (math.pi * self.volume * m2 * mods))
        eterm[0, 0, 0] = 0.0
        weight = np.full(nz // 2 + 1, 2.0)
        weight[0] = 1.0
        if nz % 2 == 0:
            weight[-1] = 1.0
        self.eterm = t(eterm)
        self.eweight = t(eterm * weight[None, None, :])
        self._pairs = self._pairs_at = None
        self._outer = self._outer_at = None

    # ------------------------------------------------------------ pieces

    def _pair_list(self, pos):
        """The pairs that may lie within the cutoff.  Without a skin, the
        pairs within the cutoff now.  With one, a Verlet list of the pairs
        within cutoff + skin, rebuilt once an atom has moved skin / 2; it
        is filtered from an outer list within cutoff + OUTER_SKIN, rebuilt
        by the full search once an atom has moved OUTER_SKIN / 2."""
        if self.skin <= 0.0:
            return pairs.find_pairs(pos, self.box64, self.cutoff,
                                    self.excluded_keys)
        pos64 = pos.to(torch.float64)
        if self._pairs is not None and self._moved(pos64, self._pairs_at) \
                < 0.5 * self.skin:
            return self._pairs
        # the outer reach stays within half the box (the minimum image)
        outer = max(self.skin, min(OUTER_SKIN, 0.5 * float(self.box64.min())
                                   - self.cutoff))
        if self._outer is None or self._moved(pos64, self._outer_at) \
                >= 0.5 * (outer - self.skin):
            self._outer = pairs.find_pairs(pos, self.box64,
                                           self.cutoff + outer,
                                           self.excluded_keys)
            self._outer_at = pos64.clone()
        i, j = self._outer
        d = pairs.min_image(pos64[j] - pos64[i], self.box64)
        near = torch.sum(d * d, dim=-1) <= (self.cutoff + self.skin) ** 2
        self._pairs = (i[near], j[near])
        self._pairs_at = pos64.clone()
        return self._pairs

    def _moved(self, pos64, at):
        d = pairs.min_image(pos64 - at, self.box64)
        return float(torch.sqrt(torch.max(torch.sum(d * d, dim=-1))))

    def _direct(self, pos, slice_e, forces):
        R = self.R
        i, j = self._pair_list(pos)
        d = R(pairs.min_image(pos[j] - pos[i], self.box))
        r2 = R(torch.sum(d * d, dim=-1))
        # pairs of the Verlet list beyond the cutoff add nothing
        inside = (r2 < self.cutoff ** 2).to(self.dtype)
        r = R(torch.sqrt(r2))
        inv_r = R(1.0 / r)
        ar = R(self.alpha * r)
        qq = R(ONE_4PI_EPS0 * R(self.q[i] * self.q[j]))
        erfc = R(torch.special.erfc(ar))
        e_c = R(qq * R(erfc * inv_r))
        gauss = R(2.0 * self.alpha / math.sqrt(math.pi)
                  * R(torch.exp(-R(ar * ar))))
        de_c = R(-qq * R(R(erfc * inv_r) + gauss) * inv_r)   # dE/dr
        sig = R(0.5 * (self.sig[i] + self.sig[j]))
        eps = R(torch.sqrt(R(self.eps[i] * self.eps[j])))
        s2 = R(R(sig * sig) / r2)
        s6 = R(R(s2 * s2) * s2)
        s12 = R(s6 * s6)
        e_lj = R(4.0 * eps * R(s12 - s6))
        de_lj = R(-24.0 * eps * R(2.0 * s12 - s6) * inv_r)
        e_c, de_c, e_lj, de_lj = (x * inside for x in (e_c, de_c, e_lj,
                                                         de_lj))
        sl = slice_index(self.subset[i], self.subset[j])
        if slice_e is not None:
            slice_sums(slice_e, sl, e_c, e_lj)
        de = R(R(self.lam[sl, 0] * de_c) + R(self.lam[sl, 1] * de_lj))
        f = R(R(de * inv_r)[:, None] * d)          # on i: dE/dr d / r
        forces.index_add_(0, i, f)
        forces.index_add_(0, j, -f)

    def _exceptions(self, pos, slice_e, forces):
        R = self.R
        i, j = self.exc_i, self.exc_j
        if len(i) == 0:
            return
        d = R(pairs.min_image(pos[j] - pos[i], self.box))
        r2 = R(torch.sum(d * d, dim=-1))
        r = R(torch.sqrt(r2))
        inv_r = R(1.0 / r)
        ar = R(self.alpha * r)
        qq = R(ONE_4PI_EPS0 * R(self.q[i] * self.q[j]))
        erf = R(torch.special.erf(ar))
        gauss = R(2.0 * self.alpha / math.sqrt(math.pi)
                  * R(torch.exp(-R(ar * ar))))
        e_c = R(-qq * R(erf * inv_r))
        de_c = R(-qq * R(gauss - R(erf * inv_r)) * inv_r)
        qq_ex, sig, eps = (self.exc_params[:, 0], self.exc_params[:, 1],
                           self.exc_params[:, 2])
        qq_ex = R(ONE_4PI_EPS0 * qq_ex)
        e_c = R(e_c + R(qq_ex * inv_r))
        de_c = R(de_c - R(R(qq_ex * inv_r) * inv_r))
        s2 = R(R(sig * sig) / r2)
        s6 = R(R(s2 * s2) * s2)
        s12 = R(s6 * s6)
        e_lj = R(4.0 * eps * R(s12 - s6))
        de_lj = R(-24.0 * eps * R(2.0 * s12 - s6) * inv_r)
        sl = self.exc_slice
        if slice_e is not None:
            slice_sums(slice_e, sl, e_c, e_lj)
        de = R(R(self.lam[sl, 0] * de_c) + R(self.lam[sl, 1] * de_lj))
        f = R(R(de * inv_r)[:, None] * d)
        forces.index_add_(0, i, f)
        forces.index_add_(0, j, -f)

    def _reciprocal(self, pos, slice_e, forces):
        R = self.R
        nx, ny, nz = self.grid
        K = torch.as_tensor(self.grid, device=self.device).to(self.dtype)
        frac = pos / self.box
        frac = frac - torch.floor(frac)
        u = R(frac * K)
        base = torch.floor(u)
        tt = R(u - base)
        base = base.to(torch.int64)
        w, dw = ewald.bspline(tt)                       # lists over k
        w = torch.stack([R(x) for x in w], dim=-1)       # (N, 3, order)
        dw = torch.stack([R(x) for x in dw], dim=-1)
        order = w.shape[-1]
        k = torch.arange(order, device=self.device)
        idx = [(base[:, a, None] + k[None, :]) % self.grid[a]
               for a in range(3)]
        flat = ((idx[0][:, :, None, None] * ny + idx[1][:, None, :, None])
                * nz + idx[2][:, None, None, :])          # (N, o, o, o)
        wxyz = R(R(w[:, 0, :, None, None] * w[:, 1, None, :, None])
                 * w[:, 2, None, None, :])
        ns = self.n_subsets
        flat_s = flat + (self.subset * (nx * ny * nz))[:, None, None, None]
        Q = torch.zeros(ns * nx * ny * nz, dtype=self.dtype,
                        device=self.device)
        Q.index_add_(0, flat_s.reshape(-1),
                     R(self.q[:, None, None, None] * wxyz).reshape(-1))
        Q = R(Q).reshape(ns, nx, ny, nz)
        FQ = torch.fft.rfftn(Q, dim=(1, 2, 3))
        if self.mode == "tf32":
            FQ = torch.complex(R(FQ.real), R(FQ.imag))
        for s in range(ns if slice_e is not None else 0):
            for t_ in range(s, ns):
                prod = (FQ[s] * torch.conj(FQ[t_])).real
                e = torch.sum((self.eweight * prod).to(torch.float64))
                sl = int(slice_index(s, t_))
                slice_e[sl, 0] += 0.5 * e if s == t_ else e
        # potential of each subset: eterm * sum_t lambda_st Q_t
        phis = []
        for s in range(ns):
            acc = torch.zeros_like(FQ[0])
            for t_ in range(ns):
                acc = acc + self.lam[int(slice_index(s, t_)), 0] * FQ[t_]
            g = acc * self.eterm
            phi = torch.fft.irfftn(g, s=(nx, ny, nz)) * (nx * ny * nz)
            phis.append(R(phi).reshape(-1))
        phi = torch.stack(phis)                          # (ns, G)
        vals = phi[self.subset[:, None, None, None],
                   flat]                                  # (N, o, o, o)
        scale = K / self.box
        gx = R(R(dw[:, 0, :, None, None] * w[:, 1, None, :, None])
               * w[:, 2, None, None, :])
        gy = R(R(w[:, 0, :, None, None] * dw[:, 1, None, :, None])
               * w[:, 2, None, None, :])
        gz = R(R(w[:, 0, :, None, None] * w[:, 1, None, :, None])
               * dw[:, 2, None, None, :])
        grad = torch.stack([R(torch.sum(R(g * vals), dim=(1, 2, 3)))
                            for g in (gx, gy, gz)], dim=-1)
        forces.add_(R(-R(self.q[:, None] * grad) * scale))

    # ---------------------------------------------------------- entries

    def evaluate(self, pos, energies=True):
        """(slice energies (S, 2) float64, or None without ``energies``;
        forces (N, 3) in the reference's dtype) at ``pos``."""
        pos = torch.as_tensor(pos, device=self.device).to(self.dtype)
        slice_e = None
        if energies:
            slice_e = torch.zeros((self.n_slices, 2), dtype=torch.float64,
                                  device=self.device)
        forces = torch.zeros((self.n, 3), dtype=self.dtype,
                             device=self.device)
        self._direct(pos, slice_e, forces)
        self._exceptions(pos, slice_e, forces)
        self._reciprocal(pos, slice_e, forces)
        return (None if slice_e is None else slice_e + self.const), forces

    def energy(self, slice_e):
        return float(torch.sum(self.lam64 * slice_e))

    def derivatives(self, slice_e):
        return {name: float(torch.sum(mask * slice_e))
                for name, mask in self.masks.items()}


def dispersion_coefficients(spec):
    """Per-slice coefficients (kJ/mol nm^3) of OpenMM's long-range
    dispersion correction for a sliced force without switching: over the
    classes of equal (sigma, epsilon, subset), a class with itself c (c +
    1) / 2 times into its subset's diagonal slice, two classes c1 c2 times
    into their slice, with mixed sigma and epsilon; each sum over
    n (n + 1) / 2 interactions, times 8 pi n^2 (S1 / (9 rc^9) - S2 /
    (3 rc^3))."""
    S = spec.n_subsets * (spec.n_subsets + 1) // 2
    keys = np.stack([spec.sigmas, spec.epsilons,
                     spec.subsets.astype(np.float64)], axis=1)
    classes, counts = np.unique(keys, axis=0, return_counts=True)
    s1 = np.zeros(S)
    s2 = np.zeros(S)
    for a in range(len(classes)):
        for b in range(a + 1):
            sa, ea, ua = classes[a]
            sb, eb, ub = classes[b]
            if a == b:
                n_pairs = counts[a] * (counts[a] + 1) / 2
            else:
                n_pairs = counts[a] * counts[b]
            sig = 0.5 * (sa + sb)
            eps = math.sqrt(ea * eb)
            sl = int(slice_index(int(ua), int(ub)))
            s1[sl] += n_pairs * eps * sig ** 12
            s2[sl] += n_pairs * eps * sig ** 6
    n = spec.n_atoms
    interactions = n * (n + 1) / 2
    rc = spec.cutoff
    return 8.0 * n * n * math.pi * (s1 / interactions / (9.0 * rc ** 9)
                                    - s2 / interactions / (3.0 * rc ** 3))
