// Order-5 cardinal B-splines shared by the PME spread and interpolation
// kernels: the recursions of ReferencePME.cpp:264-317, written out for one
// atom and one axis, in the operation order of
// nonbondedslicing_tpu/ops/pallas_pme.py::_bspline_lists.
#pragma once

#include <cuda_runtime.h>

namespace nbs {

constexpr int kPmeOrder = 5;

// Values (and, when dtheta is not null, derivatives) at fractional offset
// `frac` in [0, 1).
__device__ inline void bspline5(float frac, float* theta, float* dtheta) {
    float data[kPmeOrder];
#pragma unroll
    for (int k = 0; k < kPmeOrder; ++k) data[k] = 0.0f;
    data[1] = frac;
    data[0] = 1.0f - frac;
#pragma unroll
    for (int k = 3; k < kPmeOrder; ++k) {
        const float div = 1.0f / static_cast<float>(k - 1);
        data[k - 1] = div * frac * data[k - 2];
#pragma unroll
        for (int l = 1; l < k - 1; ++l) {
            data[k - l - 1] = div * ((frac + l) * data[k - l - 2]
                                     + (k - l - frac) * data[k - l - 1]);
        }
        data[0] = div * (1.0f - frac) * data[0];
    }
    if (dtheta != nullptr) {
        dtheta[0] = -data[0];
#pragma unroll
        for (int k = 1; k < kPmeOrder; ++k) dtheta[k] = data[k - 1] - data[k];
    }
    const float div = 1.0f / static_cast<float>(kPmeOrder - 1);
    data[kPmeOrder - 1] = div * frac * data[kPmeOrder - 2];
#pragma unroll
    for (int l = 1; l < kPmeOrder - 1; ++l) {
        data[kPmeOrder - l - 1] =
            div * ((frac + l) * data[kPmeOrder - l - 2]
                   + (kPmeOrder - l - frac) * data[kPmeOrder - l - 1]);
    }
    data[0] = div * (1.0f - frac) * data[0];
#pragma unroll
    for (int k = 0; k < kPmeOrder; ++k) theta[k] = data[k];
}

// Grid base index and spline fraction along one axis for a position given
// as its three Cartesian components; recip is the row-major (3, 3)
// reciprocal box.  Points base + k (mod n), k < kPmeOrder, carry the
// weights theta[k].
__device__ inline void grid_base(float x, float y, float z,
                                 const float* recip, int axis, int n,
                                 int* base, float* frac) {
    const float f = x * recip[axis] + y * recip[3 + axis] + z * recip[6 + axis];
    const float t = (f - floorf(f)) * static_cast<float>(n);
    const float ti = floorf(t);
    *frac = t - ti;
    *base = static_cast<int>(ti) % n;
}

}  // namespace nbs
