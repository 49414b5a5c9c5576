// PME charge spreading into per-subset grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_spread_kernel
// (pallas_call at pallas_pme.py:156), which builds per-brick charge windows
// W = sum q * onehot_s * T_x (x) T_y (x) T_z as bf16x3 MXU products.  Here
// each slot atom adds q * theta_x * theta_y * theta_z straight into its
// subset's (nx, ny, nz) grid at the 125 points (base + k) mod n, the grid
// index convention the window origin b*p - 1 of the TPU kernel gives.
//
// What bounds it on an H100: the 125 global atomics per atom (23,289 atoms
// -> 2.9 M atomics on a 3 x 60^3 grid at the benchmark shapes), not the
// spline arithmetic.  Atomics are 64-bit integer adds in fixed point (2^32,
// as the reference's realToFixedPoint, for the float variant), so the grid
// is bitwise repeatable whatever the order of the adds; a second pass
// converts it to float.  Slot order is cell order, so neighbouring threads
// hit neighbouring grid lines.  The weights are any per-slot value: charges,
// or LJPME's C6 on its dispersion grid.
//
// Evaluations with energies take the double variant: fractional
// coordinates, splines and weights in double from a double reciprocal box,
// and a double grid, in 2^40 fixed point.  A weakly coupled slice's
// reciprocal energy (a solute's with the water around it) is a small cross
// term of two large grids, which float spline weights would blur by about
// as much as its dE/dlambda is allowed to err.  The finer step keeps the
// double grid's rounding (about a hundred adds a point of half a step each)
// far below 1e-7 of its largest value for weights as small as C6 (about
// 0.05 for a water oxygen, where a grid's largest value is 0.02; 2^32 left
// 1.3e-7); grid values up to 2^23 still fit the 64-bit adds.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

// the fixed-point step of the float variant (2^-32) and the double (2^-40)
template <typename Real>
struct Fixed;
template <>
struct Fixed<float> {
    static constexpr double kInv = 1.0 / 4294967296.0;
    static __device__ __forceinline__ long long to(float v) {
        return __float2ll_rn(v * 4294967296.0f);
    }
};
template <>
struct Fixed<double> {
    static constexpr double kInv = 1.0 / 1099511627776.0;
    static __device__ __forceinline__ long long to(double v) {
        return __double2ll_rn(v * 1099511627776.0);
    }
};

template <typename Real>
__global__ void spread_kernel(const float* __restrict__ pos,
                              const float* __restrict__ charge,
                              const int* __restrict__ subset,
                              const Real* __restrict__ recip_g,
                              unsigned long long* __restrict__ acc,
                              int n_cells, int capacity, int nx, int ny,
                              int nz) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_cells * capacity) return;
    const Real q = charge[s];
    if (q == Real(0)) return;   // pad slots (and neutral atoms) add nothing
    const int cell = s / capacity;
    const int k = s - cell * capacity;
    const Real x = pos[(cell * 3 + 0) * capacity + k];
    const Real y = pos[(cell * 3 + 1) * capacity + k];
    const Real z = pos[(cell * 3 + 2) * capacity + k];
    Real recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
    int bx, by, bz;
    Real fx, fy, fz;
    nbs::grid_base<Real>(x, y, z, recip, 0, nx, &bx, &fx);
    nbs::grid_base<Real>(x, y, z, recip, 1, ny, &by, &fy);
    nbs::grid_base<Real>(x, y, z, recip, 2, nz, &bz, &fz);
    Real tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
    nbs::bspline5<Real>(fx, tx, nullptr);
    nbs::bspline5<Real>(fy, ty, nullptr);
    nbs::bspline5<Real>(fz, tz, nullptr);
    unsigned long long* grid =
        acc + static_cast<long long>(subset[s]) * nx * ny * nz;
    for (int a = 0; a < nbs::kPmeOrder; ++a) {
        const int gx = (bx + a) % nx;
        const Real qx = q * tx[a];
        for (int b = 0; b < nbs::kPmeOrder; ++b) {
            const int gy = (by + b) % ny;
            const Real qxy = qx * ty[b];
            unsigned long long* line = grid + (static_cast<long long>(gx) * ny + gy) * nz;
#pragma unroll
            for (int c = 0; c < nbs::kPmeOrder; ++c) {
                const int gz = (bz + c) % nz;
                const long long v = Fixed<Real>::to(qxy * tz[c]);
                atomicAdd(line + gz, static_cast<unsigned long long>(v));
            }
        }
    }
}

template <typename Real>
__global__ void fixed_to_real_kernel(const unsigned long long* __restrict__ acc,
                                     Real* __restrict__ grid, long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    grid[i] = static_cast<Real>(static_cast<double>(
        static_cast<long long>(acc[i])) * Fixed<Real>::kInv);
}

template <typename Real>
int spread(const void* pos, const void* charge, const void* subset,
           const void* recip, void* acc, void* grid, int n_cells,
           int capacity, int nsub, int nx, int ny, int nz,
           cudaStream_t st) {
    const int n_slots = n_cells * capacity;
    const int threads = 128;
    spread_kernel<Real><<<(n_slots + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const int*>(subset), static_cast<const Real*>(recip),
        static_cast<unsigned long long*>(acc), n_cells, capacity, nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_grid = static_cast<long long>(nsub) * nx * ny * nz;
    const int blocks = static_cast<int>((n_grid + 255) / 256);
    fixed_to_real_kernel<Real><<<blocks, 256, 0, st>>>(
        static_cast<const unsigned long long*>(acc), static_cast<Real*>(grid),
        n_grid);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc must be zeroed by the caller; grid receives the charge grids
// (nsub, nx, ny, nz), float with recip a float (3, 3), or double (splines
// and weights in double too) with recip a double (3, 3) when
// double_precision is nonzero.  Returns the cudaError_t of the launches.
extern "C" int nbs_pme_spread(const void* pos, const void* charge,
                              const void* subset, const void* recip,
                              void* acc, void* grid, int n_cells,
                              int capacity, int nsub, int nx, int ny, int nz,
                              int double_precision, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (double_precision) {
        return spread<double>(pos, charge, subset, recip, acc, grid, n_cells,
                              capacity, nsub, nx, ny, nz, st);
    }
    return spread<float>(pos, charge, subset, recip, acc, grid, n_cells,
                         capacity, nsub, nx, ny, nz, st);
}
