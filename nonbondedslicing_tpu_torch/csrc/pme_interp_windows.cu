// PME force interpolation from per-brick potential windows.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_interp_kernel
// (pallas_call at pallas_pme.py:391) in its own window form: there each
// brick contracts dense (w, C) spline matrices with its potential window as
// bf16x3 MXU products; here each slot atom of a brick reads the 125 points
// (rel + k) of its own subset's window of that brick (the lambda-combined
// potential, extracted by csrc/pme_extract.cu) and forms
// F = -q * (dphi/du_k * n_k * recip rows) as pallas_pme.py:373-379 does.  A
// point whose row rel + k lies outside the window drops out, as the one-hot
// rows of the TPU kernel's spline matrices do.  No atomics: one thread owns
// one atom's force.
//
// What bounds it on an H100: bytes.  The windows (10.6 MB at the benchmark
// shapes) are read once in all, 125 scattered 4-byte reads per atom; a
// brick's atoms are neighbours in slot order and share its 16 KB window.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

constexpr int kMargin = nbs::kPmeOrder + 1;

__global__ void interp_windows_kernel(const float* __restrict__ W,
                                      const float* __restrict__ pos,
                                      const float* __restrict__ charge,
                                      const int* __restrict__ subset,
                                      const float* __restrict__ recip_g,
                                      float* __restrict__ forces,
                                      int capacity, int nsub, int nbx,
                                      int nby, int nbz, int px, int py,
                                      int pz) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nbx * nby * nbz * capacity) return;
    const int brick = s / capacity;
    const int k = s - brick * capacity;
    float* out = forces + brick * 3 * capacity + k;
    const float q = charge[s];
    if (q == 0.0f) {   // pad slots (and neutral atoms) feel no force
        out[0] = 0.0f;
        out[capacity] = 0.0f;
        out[2 * capacity] = 0.0f;
        return;
    }
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const int nx = nbx * px, ny = nby * py, nz = nbz * pz;
    const float x = pos[(brick * 3 + 0) * capacity + k];
    const float y = pos[(brick * 3 + 1) * capacity + k];
    const float z = pos[(brick * 3 + 2) * capacity + k];
    float recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
    int bx, by, bz;
    float ux, uy, uz;
    nbs::grid_base<float>(x, y, z, recip, 0, nx, &bx, &ux);
    nbs::grid_base<float>(x, y, z, recip, 1, ny, &by, &uy);
    nbs::grid_base<float>(x, y, z, recip, 2, nz, &bz, &uz);
    const int rx = nbs::window_rel(bx, brick / (nbz * nby), px, nx);
    const int ry = nbs::window_rel(by, (brick / nbz) % nby, py, ny);
    const int rz = nbs::window_rel(bz, brick % nbz, pz, nz);
    float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
    float dx[nbs::kPmeOrder], dy[nbs::kPmeOrder], dz[nbs::kPmeOrder];
    nbs::bspline5<float>(ux, tx, dx);
    nbs::bspline5<float>(uy, ty, dy);
    nbs::bspline5<float>(uz, tz, dz);
    const float* win = W + (static_cast<long long>(brick) * nsub + subset[s])
                               * wx * wy * wz;
    float gx_sum = 0.0f, gy_sum = 0.0f, gz_sum = 0.0f;
    for (int a = 0; a < nbs::kPmeOrder; ++a) {
        if (rx + a >= wx) break;
        for (int b = 0; b < nbs::kPmeOrder; ++b) {
            if (ry + b >= wy) break;
            const float* line = win + (static_cast<long long>(rx + a) * wy + ry + b) * wz;
            float v = 0.0f, vd = 0.0f;   // sums over z of phi*theta_z, phi*dtheta_z
#pragma unroll
            for (int c = 0; c < nbs::kPmeOrder; ++c) {
                const float p = rz + c < wz ? line[rz + c] : 0.0f;
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

// W: combined potential windows (nbx, nby, nbz, nsub, wx, wy, wz), w = p + 6;
// pos (bricks, 3, capacity), charge and subset (bricks, capacity) brick-major;
// forces: (bricks, 3, capacity).  Returns the cudaError_t of the launch.
extern "C" int nbs_pme_interp_windows(const void* W, const void* pos,
                                      const void* charge, const void* subset,
                                      const void* recip, void* forces,
                                      int capacity, int nsub, int nbx,
                                      int nby, int nbz, int px, int py,
                                      int pz, void* stream) {
    const int n_slots = nbx * nby * nbz * capacity;
    const int threads = 128;
    interp_windows_kernel<<<(n_slots + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W), static_cast<const float*>(pos),
        static_cast<const float*>(charge), static_cast<const int*>(subset),
        static_cast<const float*>(recip), static_cast<float*>(forces),
        capacity, nsub, nbx, nby, nbz, px, py, pz);
    return static_cast<int>(cudaGetLastError());
}
