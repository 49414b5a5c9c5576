// Order-5 cardinal B-splines shared by the PME spread and interpolation
// kernels (whole-grid and window forms): the recursions of ReferencePME.cpp:264-317, written out for one
// atom and one axis, in the operation order of
// nonbondedslicing_tpu/ops/pallas_pme.py::_bspline_lists.
#pragma once

#include <cuda_runtime.h>

namespace nbs {

constexpr int kPmeOrder = 5;

__device__ __forceinline__ float floor_real(float x) { return floorf(x); }
__device__ __forceinline__ double floor_real(double x) { return ::floor(x); }

// Values (and, when dtheta is not null, derivatives) at fractional offset
// `frac` in [0, 1), in Real (float, or double for energy evaluations).
template <typename Real>
__device__ inline void bspline5(Real frac, Real* theta, Real* dtheta) {
    Real data[kPmeOrder];
#pragma unroll
    for (int k = 0; k < kPmeOrder; ++k) data[k] = Real(0);
    data[1] = frac;
    data[0] = Real(1) - frac;
#pragma unroll
    for (int k = 3; k < kPmeOrder; ++k) {
        const Real div = Real(1) / static_cast<Real>(k - 1);
        data[k - 1] = div * frac * data[k - 2];
#pragma unroll
        for (int l = 1; l < k - 1; ++l) {
            data[k - l - 1] = div * ((frac + l) * data[k - l - 2]
                                     + (k - l - frac) * data[k - l - 1]);
        }
        data[0] = div * (Real(1) - frac) * data[0];
    }
    if (dtheta != nullptr) {
        dtheta[0] = -data[0];
#pragma unroll
        for (int k = 1; k < kPmeOrder; ++k) dtheta[k] = data[k - 1] - data[k];
    }
    const Real div = Real(1) / static_cast<Real>(kPmeOrder - 1);
    data[kPmeOrder - 1] = div * frac * data[kPmeOrder - 2];
#pragma unroll
    for (int l = 1; l < kPmeOrder - 1; ++l) {
        data[kPmeOrder - l - 1] =
            div * ((frac + l) * data[kPmeOrder - l - 2]
                   + (kPmeOrder - l - frac) * data[kPmeOrder - l - 1]);
    }
    data[0] = div * (Real(1) - frac) * data[0];
#pragma unroll
    for (int k = 0; k < kPmeOrder; ++k) theta[k] = data[k];
}

// Grid base index and spline fraction along one axis for a position given
// as its three Cartesian components; recip is the row-major (3, 3)
// reciprocal box.  Points base + k (mod n), k < kPmeOrder, carry the
// weights theta[k].
template <typename Real>
__device__ inline void grid_base(Real x, Real y, Real z, const Real* recip,
                                 int axis, int n, int* base, Real* frac) {
    const Real f = x * recip[axis] + y * recip[3 + axis] + z * recip[6 + axis];
    const Real t = (f - floor_real(f)) * static_cast<Real>(n);
    const Real ti = floor_real(t);
    *frac = t - ti;
    *base = static_cast<int>(ti) % n;
}

// Window row of an atom's first spline point in the window of brick
// `brick` (its coordinate along this axis; p grid points per brick, n on the
// axis): the window starts one point before the brick, at grid line
// brick * p - 1, so spline point k lies at row rel + k, in [0, n).  Rows at
// or beyond the window's width are outside it and drop out, as in
// nonbondedslicing_tpu/ops/pallas_pme.py::_axis_splines and _axis_T.
__device__ __forceinline__ int window_rel(int base, int brick, int p, int n) {
    return (base - brick * p + 1 + n) % n;
}

}  // namespace nbs
