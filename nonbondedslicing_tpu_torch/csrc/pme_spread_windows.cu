// PME charge spreading into per-brick windows.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_spread_kernel
// (pallas_call at pallas_pme.py:156) in its own window form: per brick,
// W[s, ux, uy, uz] = sum over the brick's atoms of q * onehot_s *
// T_x[ux] * T_y[uy] * T_z[uz], where T holds the atom's order-5 B-spline
// weights at rows rel + k and zeros elsewhere; a row outside the window
// drops out.  The TPU kernel forms dense (w, C) spline matrices and
// contracts them as bf16x3 MXU products.
//
// Here the design of the whole-grid spread (spread_common.cuh) with a
// brick's window as the region: one block a brick and subset (and, where a
// window would not fit a block's shared memory, a slab of the window's x
// rows).  The block lists its brick's charged slots of its subset, stages
// them 128 at a time with a list of their (x point, y point) lines in the
// window, and one thread per listed line adds its <= 5 z weights to the
// window in 64-bit fixed point (2^-32 steps); every window element is then
// converted to float and stored once.  No global atomics; integer sums do
// not depend on their order, so two launches give the same bits.  Pad
// slots and neutral atoms (q = 0) are skipped: the window starts from
// zeros.
//
// What bounds it on an H100: bytes, the windows written once (10.6 MB at the
// benchmark shapes: 216 bricks x 3 subsets x 16^3 floats); the adds are a
// thread for each of the 25 lines of an atom, against the 768 line owners
// of a brick that each tested all its 136 atoms in the design before.
//
// Shared memory: the stage and the lists (19 KB) and the window of one
// subset in 64-bit sums, its rows padded against bank conflicts (35 KB at
// 16^3 points): four blocks an SM.

#include <cuda_runtime.h>

#include "spread_common.cuh"

namespace {

constexpr int kMargin = nbs::kPmeOrder + 1;
constexpr int kThreads = 256;   // and slots scanned into one list
constexpr int kStage = 128;     // atoms staged at a time
constexpr int kStageBytes =
    kStage * (nbs::kStageStride * 4 + 32 + 2 * nbs::kPmeOrder * nbs::kPmeOrder)
    + kThreads * 4;
// a block's opt-in limit on sm_90 (232,448 bytes), less room for the
// kernel's static shared memory
constexpr int kMaxSharedBytes = 232448 - 256;

__global__ void __launch_bounds__(kThreads, 4)
spread_windows_kernel(const float* __restrict__ pos,
                      const float* __restrict__ charge,
                      const int* __restrict__ subset,
                      const float* __restrict__ recip_g,
                      float* __restrict__ W, int capacity, int nsub, int nbx,
                      int nby, int nbz, int px, int py, int pz, int parts,
                      nbs::RegionLayout layout) {
    extern __shared__ __align__(16) unsigned char shared_raw[];
    __shared__ int n_listed, n_lines;
    __shared__ int warp_sums[kThreads / 32];
    nbs::Stage<float> st;
    st.t = reinterpret_cast<float*>(shared_raw);
    st.rows = reinterpret_cast<int4*>(st.t + kStage * nbs::kStageStride);
    st.pts = st.rows + kStage;
    st.lines = reinterpret_cast<unsigned short*>(st.pts + kStage);
    st.warps = warp_sums;
    st.n_lines = &n_lines;
    int* list = reinterpret_cast<int*>(
        st.lines + kStage * nbs::kPmeOrder * nbs::kPmeOrder);
    const nbs::FixedRegion acc{reinterpret_cast<unsigned*>(list + kThreads),
                               reinterpret_cast<unsigned*>(list + kThreads)
                                   + layout.ps};

    const int part = blockIdx.x % parts;
    const int s = (blockIdx.x / parts) % nsub;
    const int brick = blockIdx.x / (parts * nsub);
    const int Bx = brick / (nbz * nby);
    const int By = (brick / nbz) % nby;
    const int Bz = brick % nbz;
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const int3 n = make_int3(nbx * px, nby * py, nbz * pz);
    // this block's slab of the window's x rows
    const int x0 = part * wx / parts;
    const int3 m = make_int3((part + 1) * wx / parts - x0, wy, wz);
    const int3 no_wrap = make_int3(0, 0, 0);
    float recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];

    acc.zero(layout.ps);
    for (int c0 = 0; c0 < capacity; c0 += kThreads) {
        if (threadIdx.x == 0) n_listed = 0;
        __syncthreads();   // the window is zeroed, the last list used up
        // 1. list the brick's charged slots of this subset
        const int k = c0 + threadIdx.x;
        const int slot = brick * capacity + k;
        const bool keep =
            k < capacity && charge[slot] != 0.0f && subset[slot] == s;
        const int at = nbs::claim(keep ? 1 : 0, &n_listed);
        if (keep) list[at] = slot;
        __syncthreads();
        const int n_list = n_listed;
        // 2. stage them, list their lines in the window and add the lines'
        // points
        for (int a0 = 0; a0 < n_list; a0 += kStage) {
            const int na = min(kStage, n_list - a0);
            int count = 0;
            if (threadIdx.x < na) {
                count = nbs::stage_atom<float>(
                    st, threadIdx.x, list[a0 + threadIdx.x], capacity, pos,
                    charge, recip, n,
                    [&](const int* base, int) {
                        return make_int4(
                            nbs::window_rel(base[0], Bx, px, n.x) - x0,
                            nbs::window_rel(base[1], By, py, n.y),
                            nbs::window_rel(base[2], Bz, pz, n.z), 0);
                    },
                    m, no_wrap);
            }
            const int lines = nbs::list_lines(st, count, na);
            nbs::accumulate<float>(st, lines, no_wrap, layout, acc);
            __syncthreads();   // the stage is used up
        }
    }
    // 3. convert this block's window rows, a z line a thread, and store
    // them
    const float inv_wz = 1.0f / wz, inv_wy = 1.0f / wy;
    for (int line = threadIdx.x; line < m.x * wy; line += kThreads) {
        const int ux = nbs::div_small(line, wy, inv_wy);
        acc.round_line(layout.at(0, ux, line - ux * wy, 0), wz);
    }
    __syncthreads();
    float* out = W + ((static_cast<long long>(brick) * nsub + s) * wx + x0)
                     * wy * wz;
    for (int i = threadIdx.x; i < m.x * wy * wz; i += kThreads) {
        const int line = nbs::div_small(i, wz, inv_wz);
        const int uz = i - line * wz;
        const int ux = nbs::div_small(line, wy, inv_wy);
        const int uy = line - ux * wy;
        out[i] = acc.stored<float>(layout.at(0, ux, uy, uz));
    }
}

}  // namespace

// pos (bricks, 3, capacity), charge and subset (bricks, capacity) brick-major
// slot tensors; W receives the windows (nbx, nby, nbz, nsub, wx, wy, wz),
// w = p + 6, every element written.  Returns the cudaError_t of the launch,
// cudaErrorInvalidValue when one x row of a window does not fit a block's
// shared memory.
extern "C" int nbs_pme_spread_windows(const void* pos, const void* charge,
                                      const void* subset, const void* recip,
                                      void* W, int capacity, int nsub,
                                      int nbx, int nby, int nbz, int px,
                                      int py, int pz, void* stream) {
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const long long budget = kMaxSharedBytes - kStageBytes;
    int parts = 1;
    nbs::RegionLayout layout;
    for (;; ++parts) {
        layout = nbs::RegionLayout::cached((wx + parts - 1) / parts, wy, wz);
        if (parts >= wx || 8LL * layout.ps <= budget) break;
    }
    if (8LL * layout.ps > budget) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int shared_bytes = kStageBytes + 8 * layout.ps;
    cudaError_t err = cudaFuncSetAttribute(
        spread_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    spread_windows_kernel<<<nbx * nby * nbz * nsub * parts, kThreads,
                            shared_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const int*>(subset), static_cast<const float*>(recip),
        static_cast<float*>(W), capacity, nsub, nbx, nby, nbz, px, py, pz,
        parts, layout);
    return static_cast<int>(cudaGetLastError());
}
