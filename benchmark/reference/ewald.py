"""Ewald and PME parameters from the cutoff and the error tolerance, as
OpenMM sizes them, and the cardinal B-splines of smooth PME (Essmann et
al., J. Chem. Phys. 103:8577, 1995).

* ``alpha = sqrt(-ln(2 tol)) / cutoff``.
* The grid: ``ceil(2 alpha L / (3 tol^(1/5)))`` points per axis, at
  least 6, rounded up to a size whose prime factors are at most 13
  (OpenMM's GPU platforms).
"""

import math

import numpy as np

ORDER = 5


def alpha(cutoff, tol):
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def legal_size(n, max_factor=13):
    while True:
        m = n
        for f in (2, 3, 5, 7, 11, 13):
            if f > max_factor:
                break
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def eval_grid(box, cutoff, tol):
    a = alpha(cutoff, tol)
    return tuple(legal_size(max(6, int(math.ceil(2.0 * a * float(L)
                                                 / (3.0 * tol ** 0.2)))))
                 for L in box)


def bspline(t, order=ORDER):
    """Weights and derivatives (..., order) of the cardinal B-spline of
    ``order`` at the points t + order - 1 - k, k = 0..order-1, for the
    fractional offsets ``t`` in [0, 1) (any array module's tensors)."""
    one = t * 0 + 1
    w = [one - t, t]                      # order 2
    for n in range(3, order + 1):
        new = [None] * n
        new[n - 1] = t * w[n - 2] / (n - 1)
        for k in range(n - 2, 0, -1):
            new[k] = ((t + n - 1 - k) * w[k - 1]
                      + (k + 1 - t) * w[k]) / (n - 1)
        new[0] = (one - t) * w[0] / (n - 1)
        if n == order:
            d = [w[0] * -1]
            d += [w[k - 1] - w[k] for k in range(1, n - 1)]
            d += [w[n - 2]]
        w = new
    return w, d


def moduli(n, order=ORDER):
    """|sum_k M(k+1) exp(2 pi i m k / n)|^2 for m = 0..n-1, the B-spline
    values at the integers, with a vanishing modulus replaced by the mean
    of its neighbours (OpenMM's reference PME)."""
    if n < order:
        raise ValueError(f"a PME grid of {n} points is below the order")
    w, _ = bspline(np.float64(0.0), order)
    vals = np.zeros(n)
    vals[:order] = np.asarray(w, dtype=np.float64)[::-1]   # M(0..order-1)
    m = np.arange(n)
    ang = 2.0 * np.pi * np.outer(m, np.arange(n)) / n
    mod = (vals @ np.cos(ang).T) ** 2 + (vals @ np.sin(ang).T) ** 2
    small = mod < 1e-7
    fixed = mod.copy()
    for i in np.nonzero(small)[0]:
        fixed[i] = 0.5 * (mod[(i - 1) % n] + mod[(i + 1) % n])
    return fixed
