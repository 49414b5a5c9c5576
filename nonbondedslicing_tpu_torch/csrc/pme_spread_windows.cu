// PME charge spreading into per-brick windows.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_spread_kernel
// (pallas_call at pallas_pme.py:156) in its own window form: per brick,
// W[s, ux, uy, uz] = sum over the brick's atoms of q * onehot_s *
// T_x[ux] * T_y[uy] * T_z[uz], where T holds the atom's order-5 B-spline
// weights at rows rel + k and zeros elsewhere; a row outside the window
// drops out.  The TPU kernel forms dense (w, C) spline matrices and
// contracts them as bf16x3 MXU products.  Here one block owns one brick and
// keeps its window in shared memory:
//
//   1. the block's threads stage a chunk of the brick's atoms in shared
//      memory: the window rows rel of the three axes, the subset, and the 15
//      spline weights (the charge folded into the x weights);
//   2. each thread owns window lines (s, ux, uy, :) and walks the staged
//      atoms in slot order; an atom of subset s whose stencil covers (ux, uy)
//      adds its <= 5 z weights to the line;
//   3. the window is written to global memory, contiguously.
//
// A line has one owner and the atoms come in slot order, so there are no
// atomics, in shared or global memory, and two launches give the same bits.
// Pad slots and neutral atoms (q = 0) are skipped: the window starts from
// zeros, so they add exact zeros whatever their positions.
//
// What bounds it on an H100: bytes, the windows written once (10.6 MB at the
// benchmark shapes: 216 bricks x 3 subsets x 16^3 floats).  What it does in
// fact wait on is step 2: every line owner tests every staged atom (768
// lines x 136 atoms per brick), and an atom touches 25 lines.
//
// Shared memory: the staging area (20 KB) and the window of as many subsets
// as fit the opt-in limit of 227 KB a block (48 KB for 3 subsets of 16^3
// points); more subsets than fit take further passes over the atoms.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

constexpr int kMargin = nbs::kPmeOrder + 1;
constexpr int kChunk = 256;            // atoms staged at a time
constexpr int kWeights = 16;           // floats per staged atom (15 used)
constexpr int kStageBytes = kChunk * (kWeights * 4 + 16);
constexpr int kMaxSharedBytes = 232448;   // opt-in limit of a block on sm_90

__global__ void __launch_bounds__(1024)
spread_windows_kernel(const float* __restrict__ pos,
                      const float* __restrict__ charge,
                      const int* __restrict__ subset,
                      const float* __restrict__ recip_g,
                      float* __restrict__ W, int capacity, int nsub, int nbx,
                      int nby, int nbz, int px, int py, int pz,
                      int subsets_per_pass) {
    extern __shared__ __align__(16) unsigned char shared_raw[];
    float* weights = reinterpret_cast<float*>(shared_raw);
    int4* rows = reinterpret_cast<int4*>(shared_raw + kChunk * kWeights * 4);
    float* win = reinterpret_cast<float*>(shared_raw + kStageBytes);

    const int brick = blockIdx.x;
    const int Bx = brick / (nbz * nby);
    const int By = (brick / nbz) % nby;
    const int Bz = brick % nbz;
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const int nx = nbx * px, ny = nby * py, nz = nbz * pz;
    const int wvol = wx * wy * wz;
    float recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];

    for (int s0 = 0; s0 < nsub; s0 += subsets_per_pass) {
        const int ns = min(subsets_per_pass, nsub - s0);
        for (int i = threadIdx.x; i < ns * wvol; i += blockDim.x) win[i] = 0.0f;
        for (int c0 = 0; c0 < capacity; c0 += kChunk) {
            const int na = min(kChunk, capacity - c0);
            __syncthreads();   // the window is zeroed, the last chunk is used up
            // 1. stage the chunk's atoms
            for (int a = threadIdx.x; a < na; a += blockDim.x) {
                const int k = c0 + a;
                const float q = charge[brick * capacity + k];
                if (q == 0.0f) {
                    rows[a] = make_int4(0, 0, 0, -1);
                    continue;
                }
                const float x = pos[(brick * 3 + 0) * capacity + k];
                const float y = pos[(brick * 3 + 1) * capacity + k];
                const float z = pos[(brick * 3 + 2) * capacity + k];
                int bx, by, bz;
                float fx, fy, fz;
                nbs::grid_base<float>(x, y, z, recip, 0, nx, &bx, &fx);
                nbs::grid_base<float>(x, y, z, recip, 1, ny, &by, &fy);
                nbs::grid_base<float>(x, y, z, recip, 2, nz, &bz, &fz);
                float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
                nbs::bspline5<float>(fx, tx, nullptr);
                nbs::bspline5<float>(fy, ty, nullptr);
                nbs::bspline5<float>(fz, tz, nullptr);
                float* t = weights + a * kWeights;
#pragma unroll
                for (int i = 0; i < nbs::kPmeOrder; ++i) {
                    t[i] = q * tx[i];
                    t[nbs::kPmeOrder + i] = ty[i];
                    t[2 * nbs::kPmeOrder + i] = tz[i];
                }
                rows[a] = make_int4(nbs::window_rel(bx, Bx, px, nx),
                                    nbs::window_rel(by, By, py, ny),
                                    nbs::window_rel(bz, Bz, pz, nz),
                                    subset[brick * capacity + k]);
            }
            __syncthreads();
            // 2. each thread adds the staged atoms to the lines it owns
            for (int line_id = threadIdx.x; line_id < ns * wx * wy;
                 line_id += blockDim.x) {
                const int s = s0 + line_id / (wx * wy);
                const int ux = (line_id / wy) % wx;
                const int uy = line_id % wy;
                float* line = win + line_id * wz;
                for (int a = 0; a < na; ++a) {
                    const int4 r = rows[a];
                    if (r.w != s) continue;
                    const unsigned kx = static_cast<unsigned>(ux - r.x);
                    if (kx >= static_cast<unsigned>(nbs::kPmeOrder)) continue;
                    const unsigned ky = static_cast<unsigned>(uy - r.y);
                    if (ky >= static_cast<unsigned>(nbs::kPmeOrder)) continue;
                    const float* t = weights + a * kWeights;
                    const float v = t[kx] * t[nbs::kPmeOrder + ky];
#pragma unroll
                    for (int c = 0; c < nbs::kPmeOrder; ++c) {
                        if (r.z + c < wz) {
                            line[r.z + c] += v * t[2 * nbs::kPmeOrder + c];
                        }
                    }
                }
            }
        }
        __syncthreads();
        // 3. flush the window
        float* out = W + (static_cast<long long>(brick) * nsub + s0) * wvol;
        for (int i = threadIdx.x; i < ns * wvol; i += blockDim.x) out[i] = win[i];
        __syncthreads();
    }
}

}  // namespace

// pos (bricks, 3, capacity), charge and subset (bricks, capacity) brick-major
// slot tensors; W receives the windows (nbx, nby, nbz, nsub, wx, wy, wz),
// w = p + 6, every element written.  Returns the cudaError_t of the launch,
// cudaErrorInvalidValue when one subset's window does not fit a block's
// shared memory.
extern "C" int nbs_pme_spread_windows(const void* pos, const void* charge,
                                      const void* subset, const void* recip,
                                      void* W, int capacity, int nsub,
                                      int nbx, int nby, int nbz, int px,
                                      int py, int pz, void* stream) {
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const long long window_bytes = 4LL * wx * wy * wz;
    const long long fit = (kMaxSharedBytes - kStageBytes) / window_bytes;
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int subsets_per_pass = static_cast<int>(fit < nsub ? fit : nsub);
    const int shared_bytes = kStageBytes
        + static_cast<int>(subsets_per_pass * window_bytes);
    cudaError_t err = cudaFuncSetAttribute(
        spread_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int lines = subsets_per_pass * wx * wy;
    int threads = (lines + 31) / 32 * 32;
    threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
    spread_windows_kernel<<<nbx * nby * nbz, threads, shared_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const int*>(subset), static_cast<const float*>(recip),
        static_cast<float*>(W), capacity, nsub, nbx, nby, nbz, px, py, pz,
        subsets_per_pass);
    return static_cast<int>(cudaGetLastError());
}
