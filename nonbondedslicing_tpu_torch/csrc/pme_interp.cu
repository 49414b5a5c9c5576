// PME force interpolation from lambda-combined potential grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_interp_kernel
// (pallas_call at pallas_pme.py:391), which contracts per-brick spline
// matrices against potential windows with bf16x3 MXU products.  Here each
// slot atom reads the 125 points (base + k) mod n of the combined grid
// C_s = sum_j lambda(s, j) * phi_j of its own subset s (the combination is
// done once per step in spectrum space by the caller), and forms
// F = -q * (dphi/du_k * n_k * recip rows) as pallas_pme.py:375-378 does.
// No atomics: one thread owns one atom's force.
//
// What bounds it on an H100: 125 scattered 4-byte reads per atom from a
// 2.6 MB grid (3 x 60^3 floats at the benchmark shapes), which stays in the
// 50 MB L2; slot order is cell order, so a warp's atoms share grid lines.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

__global__ void interp_kernel(const float* __restrict__ phi,
                              const float* __restrict__ pos,
                              const float* __restrict__ charge,
                              const int* __restrict__ subset,
                              const float* __restrict__ recip_g,
                              float* __restrict__ forces,
                              int n_cells, int capacity, int nx, int ny,
                              int nz) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_cells * capacity) return;
    const int cell = s / capacity;
    const int k = s - cell * capacity;
    float* out = forces + cell * 3 * capacity + k;
    const float q = charge[s];
    if (q == 0.0f) {   // pad slots (and neutral atoms) feel no force
        out[0] = 0.0f;
        out[capacity] = 0.0f;
        out[2 * capacity] = 0.0f;
        return;
    }
    const float x = pos[(cell * 3 + 0) * capacity + k];
    const float y = pos[(cell * 3 + 1) * capacity + k];
    const float z = pos[(cell * 3 + 2) * capacity + k];
    float recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
    int bx, by, bz;
    float ux, uy, uz;
    nbs::grid_base<float>(x, y, z, recip, 0, nx, &bx, &ux);
    nbs::grid_base<float>(x, y, z, recip, 1, ny, &by, &uy);
    nbs::grid_base<float>(x, y, z, recip, 2, nz, &bz, &uz);
    float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
    float dx[nbs::kPmeOrder], dy[nbs::kPmeOrder], dz[nbs::kPmeOrder];
    nbs::bspline5<float>(ux, tx, dx);
    nbs::bspline5<float>(uy, ty, dy);
    nbs::bspline5<float>(uz, tz, dz);
    const float* grid = phi + static_cast<long long>(subset[s]) * nx * ny * nz;
    float gx_sum = 0.0f, gy_sum = 0.0f, gz_sum = 0.0f;
    for (int a = 0; a < nbs::kPmeOrder; ++a) {
        const int gx = (bx + a) % nx;
        for (int b = 0; b < nbs::kPmeOrder; ++b) {
            const int gy = (by + b) % ny;
            const float* line = grid + (static_cast<long long>(gx) * ny + gy) * nz;
            float v = 0.0f, vd = 0.0f;   // sums over z of phi*theta_z, phi*dtheta_z
#pragma unroll
            for (int c = 0; c < nbs::kPmeOrder; ++c) {
                const float p = line[(bz + c) % nz];
                v += p * tz[c];
                vd += p * dz[c];
            }
            gx_sum += dx[a] * ty[b] * v;
            gy_sum += tx[a] * dy[b] * v;
            gz_sum += tx[a] * ty[b] * vd;
        }
    }
    const float fx = gx_sum * nx;
    const float fy = gy_sum * ny;
    const float fz = gz_sum * nz;
    out[0] = -q * (fx * recip[0]);
    out[capacity] = -q * (fx * recip[3] + fy * recip[4]);
    out[2 * capacity] = -q * (fx * recip[6] + fy * recip[7] + fz * recip[8]);
}

}  // namespace

// phi: combined potential grids (nsub, nx, ny, nz); forces: (n_cells, 3,
// capacity).  Returns the cudaError_t of the launch.
extern "C" int nbs_pme_interp(const void* phi, const void* pos,
                              const void* charge, const void* subset,
                              const void* recip, void* forces, int n_cells,
                              int capacity, int nx, int ny, int nz,
                              void* stream) {
    const int n_slots = n_cells * capacity;
    const int threads = 128;
    interp_kernel<<<(n_slots + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(phi), static_cast<const float*>(pos),
        static_cast<const float*>(charge), static_cast<const int*>(subset),
        static_cast<const float*>(recip), static_cast<float*>(forces),
        n_cells, capacity, nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}
