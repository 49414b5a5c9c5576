// PME force interpolation from lambda-combined potential grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_interp_kernel
// (pallas_call at pallas_pme.py:391), which contracts per-brick spline
// matrices against potential windows with bf16x3 MXU products.  Here each
// slot atom reads the 125 points (base + k) mod n of the combined grid
// C_s = sum_j lambda(s, j) * phi_j of its own subset s (the combination is
// done once per step in spectrum space by the caller), and forms
// F = -q * (dphi/du_k * n_k * recip rows) as pallas_pme.py:375-378 does.
//
// What bounds it on an H100: not bytes (the 2.6 MB of grids at the benchmark
// shapes stay in the 50 MB L2) but latency and instruction count: 125
// scattered reads an atom, each a tag look-up in L1 for every distinct cache
// line a load instruction touches, and the splines and sums around them.
// So a line's 5 z points are read as the kVec-aligned chunks that hold them
// (two float4 where z rows start on 16 bytes, as on the 60^3 grids; three
// float2 on the 30^3 dispersion grids) against per-atom weights that are
// zero off the 5 points, and two threads in two warps take one atom and
// split its 25 (x, y) lines, numbered x plane by x plane: the warp of role 0
// reads lines 0-12 (planes 0 and 1 and three lines of plane 2), that of
// role 1 lines 13-24, all of a thread's loads independent.  The role is a
// warp's, so each warp runs one body whose x and y indices are compile-time
// constants: no divergence, and no run-time select of x weights, whose
// schedule under nvcc moved the 30^3 pass by 30% in a pair-of-lanes form.
// Two threads an atom double the warps of one thread an atom while only
// doubling the spline work; four lanes an atom measured slower (more
// instructions an atom than the latency they hide).  Each thread sums its
// lines in a fixed order and role 0 adds role 1's shares, read back from
// shared memory, so the forces are bitwise repeatable.  The wrapped grid
// indices are formed once per atom and axis by a compare and a subtraction.
// A pad slot (q = 0) skips the reads and writes its zero force.  No atomics:
// role 0 owns its atom's force.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAtoms = kThreads / 2;   // atoms a block: two warps per 32
constexpr int kPoints2d = nbs::kPmeOrder * nbs::kPmeOrder;   // (x, y) lines

__device__ __forceinline__ int wrap_once(int i, int n) {
    return i >= n ? i - n : i;
}

// Grid base and spline fraction along one axis, the arithmetic of
// bspline.cuh::grid_base, wrapped by a compare (t may round up to n).
__device__ __forceinline__ void axis_base(float x, float y, float z,
                                          const float* recip, int axis,
                                          int n, int* base, float* frac) {
    const float f = x * recip[axis] + y * recip[3 + axis] + z * recip[6 + axis];
    const float t = (f - floorf(f)) * static_cast<float>(n);
    const float ti = floorf(t);
    *frac = t - ti;
    *base = wrap_once(static_cast<int>(ti), n);
}

template <int kVec> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void unpack(float v, float* e) { e[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* e) {
    e[0] = v.x;
    e[1] = v.y;
}
__device__ __forceinline__ void unpack(float4 v, float* e) {
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
}

// An atom's z points base .. base + 4 lie in kChunks chunks of kVec floats,
// the first starting at base rounded down to kVec (z rows start on kVec
// floats and nz is a multiple of kVec, so a chunk never straddles the wrap).
template <int kVec>
struct ZChunks {
    static constexpr int kChunks = 1 + (nbs::kPmeOrder - 1 + kVec - 1) / kVec;
    static constexpr int kSpan = kChunks * kVec;
    int start[kChunks];
    float w[kSpan], dw[kSpan];   // theta_z, dtheta_z; 0 off the 5 points

    __device__ __forceinline__ ZChunks(int bz, int nz, const float* tz,
                                       const float* dz) {
        const int o = bz & (kVec - 1);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
            start[c] = wrap_once(bz - o + c * kVec, nz);
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
            w[i] = 0.0f;
            dw[i] = 0.0f;
#pragma unroll
            for (int oo = 0; oo < kVec; ++oo) {
                const int c = i - oo;
                if (c >= 0 && c < nbs::kPmeOrder && o == oo) {
                    w[i] = tz[c];
                    dw[i] = dz[c];
                }
            }
        }
    }

    // one (x, y) line: its 5 z points against theta_z and dtheta_z, added
    // to the lane's three gradient sums
    __device__ __forceinline__ void line(const float* __restrict__ row,
                                         float tx, float dx, float ty,
                                         float dy, float* g) const {
        using T = typename Vec<kVec>::T;
        float e[kSpan];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
            unpack(*reinterpret_cast<const T*>(row + start[c]), e + c * kVec);
        float v = 0.0f, vd = 0.0f;
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
            v += e[i] * w[i];
            vd += e[i] * dw[i];
        }
        g[0] += dx * ty * v;
        g[1] += tx * dy * v;
        g[2] += tx * ty * vd;
    }
};

// Lines [kFirst, kLast) of one atom's 25, line l in x plane l / 5 and y row
// l % 5, in order, added to the thread's three gradient sums.
template <int kVec, int kFirst, int kLast>
__device__ __forceinline__ void lines(const ZChunks<kVec>& zc,
                                     const float* grid, int bx, int nx,
                                     int plane_size, const int* yoff,
                                     const float* tx, const float* dx,
                                     const float* ty, const float* dy,
                                     float* g) {
#pragma unroll
    for (int l = kFirst; l < kLast; ++l) {
        const int a = l / nbs::kPmeOrder, b = l % nbs::kPmeOrder;
        zc.line(grid + wrap_once(bx + a, nx) * plane_size + yoff[b], tx[a],
                dx[a], ty[b], dy[b], g);
    }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
interp_kernel(const float* __restrict__ phi, const float* __restrict__ pos,
              const float* __restrict__ charge, const int* __restrict__ subset,
              const float* __restrict__ recip_g, float* __restrict__ forces,
              int n_cells, int capacity, int nx, int ny, int nz) {
    __shared__ float share[kAtoms / 32][3][32];   // role 1's sums
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int role = warp & 1;   // the warp's lines: 0-12 or 13-24
    const int pair = warp >> 1;
    const int s = blockIdx.x * kAtoms + pair * 32 + lane;
    const bool in_range = s < n_cells * capacity;
    const int cell = s / capacity;
    const int k = s - cell * capacity;
    const float q = in_range ? charge[s] : 0.0f;
    float g[3] = {0.0f, 0.0f, 0.0f};   // the thread's share of the gradient
    if (q != 0.0f) {   // pad slots (and neutral atoms) read no grid point
        const float* p = pos + cell * 3 * capacity + k;
        const float x = p[0], y = p[capacity], z = p[2 * capacity];
        float recip[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
        int bx, by, bz;
        float ux, uy, uz;
        axis_base(x, y, z, recip, 0, nx, &bx, &ux);
        axis_base(x, y, z, recip, 1, ny, &by, &uy);
        axis_base(x, y, z, recip, 2, nz, &bz, &uz);
        float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder], tz[nbs::kPmeOrder];
        float dx[nbs::kPmeOrder], dy[nbs::kPmeOrder], dz[nbs::kPmeOrder];
        nbs::bspline5<float>(ux, tx, dx);
        nbs::bspline5<float>(uy, ty, dy);
        nbs::bspline5<float>(uz, tz, dz);
        const ZChunks<kVec> zc(bz, nz, tz, dz);
        int yoff[nbs::kPmeOrder];
#pragma unroll
        for (int b = 0; b < nbs::kPmeOrder; ++b)
            yoff[b] = wrap_once(by + b, ny) * nz;
        const float* grid =
            phi + static_cast<long long>(subset[s]) * nx * ny * nz;
        constexpr int kSplit = (kPoints2d + 1) / 2;
        if (role == 0)   // uniform over the warp
            lines<kVec, 0, kSplit>(zc, grid, bx, nx, ny * nz, yoff, tx, dx, ty,
                                   dy, g);
        else
            lines<kVec, kSplit, kPoints2d>(zc, grid, bx, nx, ny * nz, yoff, tx,
                                           dx, ty, dy, g);
    }
    if (role == 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) share[pair][a][lane] = g[a];
    }
    __syncthreads();
    if (role == 1 || !in_range) return;
    // role 0's sums plus role 1's, in that order: the same bits every launch
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] += share[pair][a][lane];
    const float fx = g[0] * nx, fy = g[1] * ny, fz = g[2] * nz;
    float* f = forces + cell * 3 * capacity + k;
    f[0] = q == 0.0f ? 0.0f : -q * (fx * recip_g[0]);
    f[capacity] = q == 0.0f ? 0.0f : -q * (fx * recip_g[3] + fy * recip_g[4]);
    f[2 * capacity] = q == 0.0f ? 0.0f
                                : -q * (fx * recip_g[6] + fy * recip_g[7] +
                                        fz * recip_g[8]);
}

template <int kVec>
void launch(const void* phi, const void* pos, const void* charge,
            const void* subset, const void* recip, void* forces, int n_cells,
            int capacity, int nx, int ny, int nz, cudaStream_t stream) {
    const long long atoms = static_cast<long long>(n_cells) * capacity;
    interp_kernel<kVec><<<static_cast<int>((atoms + kAtoms - 1) / kAtoms),
                          kThreads, 0, stream>>>(
        static_cast<const float*>(phi), static_cast<const float*>(pos),
        static_cast<const float*>(charge), static_cast<const int*>(subset),
        static_cast<const float*>(recip), static_cast<float*>(forces),
        n_cells, capacity, nx, ny, nz);
}

}  // namespace

// phi: combined potential grids (nsub, nx, ny, nz), every axis at least 5
// points and fewer than 2^31 points a grid (checked by the wrapper); forces:
// (n_cells, 3, capacity).  Returns the cudaError_t of the launch.
extern "C" int nbs_pme_interp(const void* phi, const void* pos,
                              const void* charge, const void* subset,
                              const void* recip, void* forces, int n_cells,
                              int capacity, int nx, int ny, int nz,
                              void* stream) {
    const size_t at = reinterpret_cast<size_t>(phi);
    const auto st = static_cast<cudaStream_t>(stream);
    if (nz % 4 == 0 && at % 16 == 0)
        launch<4>(phi, pos, charge, subset, recip, forces, n_cells, capacity,
                  nx, ny, nz, st);
    else if (nz % 2 == 0 && at % 8 == 0)
        launch<2>(phi, pos, charge, subset, recip, forces, n_cells, capacity,
                  nx, ny, nz, st);
    else
        launch<1>(phi, pos, charge, subset, recip, forces, n_cells, capacity,
                  nx, ny, nz, st);
    return static_cast<int>(cudaGetLastError());
}
