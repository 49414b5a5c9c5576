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
// spline arithmetic.  Atomics are 64-bit integer adds in 2^32 fixed point,
// as the reference's realToFixedPoint, so the grid is bitwise repeatable
// whatever the order of the adds; a second pass converts it to float.  Slot
// order is cell order, so neighbouring threads hit neighbouring grid lines.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

constexpr float kFixedScale = 4294967296.0f;          // 2^32
constexpr double kFixedInv = 1.0 / 4294967296.0;

__global__ void spread_kernel(const float* __restrict__ pos,
                              const float* __restrict__ charge,
                              const int* __restrict__ subset,
                              const float* __restrict__ recip_g,
                              unsigned long long* __restrict__ acc,
                              int n_cells, int capacity, int nx, int ny,
                              int nz) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_cells * capacity) return;
    const float q = charge[s];
    if (q == 0.0f) return;   // pad slots (and neutral atoms) add nothing
    const int cell = s / capacity;
    const int k = s - cell * capacity;
    const float x = pos[(cell * 3 + 0) * capacity + k];
    const float y = pos[(cell * 3 + 1) * capacity + k];
    const float z = pos[(cell * 3 + 2) * capacity + k];
    float recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
    int bx, by, bz;
    float fx, fy, fz;
    nbs::grid_base(x, y, z, recip, 0, nx, &bx, &fx);
    nbs::grid_base(x, y, z, recip, 1, ny, &by, &fy);
    nbs::grid_base(x, y, z, recip, 2, nz, &bz, &fz);
    float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
    nbs::bspline5(fx, tx, nullptr);
    nbs::bspline5(fy, ty, nullptr);
    nbs::bspline5(fz, tz, nullptr);
    unsigned long long* grid =
        acc + static_cast<long long>(subset[s]) * nx * ny * nz;
    for (int a = 0; a < nbs::kPmeOrder; ++a) {
        const int gx = (bx + a) % nx;
        const float qx = q * tx[a];
        for (int b = 0; b < nbs::kPmeOrder; ++b) {
            const int gy = (by + b) % ny;
            const float qxy = qx * ty[b];
            unsigned long long* line = grid + (static_cast<long long>(gx) * ny + gy) * nz;
#pragma unroll
            for (int c = 0; c < nbs::kPmeOrder; ++c) {
                const int gz = (bz + c) % nz;
                const long long v = __float2ll_rn(qxy * tz[c] * kFixedScale);
                atomicAdd(line + gz, static_cast<unsigned long long>(v));
            }
        }
    }
}

__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      float* __restrict__ grid, long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    grid[i] = static_cast<float>(static_cast<double>(
        static_cast<long long>(acc[i])) * kFixedInv);
}

}  // namespace

// acc must be zeroed by the caller; grid receives the float charge grids
// (nsub, nx, ny, nz).  Returns the cudaError_t of the launches.
extern "C" int nbs_pme_spread(const void* pos, const void* charge,
                              const void* subset, const void* recip,
                              void* acc, void* grid, int n_cells,
                              int capacity, int nsub, int nx, int ny, int nz,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_slots = n_cells * capacity;
    const int threads = 128;
    spread_kernel<<<(n_slots + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const int*>(subset), static_cast<const float*>(recip),
        static_cast<unsigned long long*>(acc), n_cells, capacity, nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_grid = static_cast<long long>(nsub) * nx * ny * nz;
    const int blocks = static_cast<int>((n_grid + 255) / 256);
    fixed_to_float_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const unsigned long long*>(acc), static_cast<float*>(grid),
        n_grid);
    return static_cast<int>(cudaGetLastError());
}
