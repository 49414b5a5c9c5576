// PME force interpolation from per-brick potential windows.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_interp_kernel
// (pallas_call at pallas_pme.py:391) in its own window form: there each
// brick contracts dense (w, C) spline matrices with its potential window as
// bf16x3 MXU products; here each slot atom of a brick reads the 125 points
// (rel + k) of its own subset's window of that brick (the lambda-combined
// potential, extracted by csrc/pme_extract.cu) and forms
// F = -q * (dphi/du_k * n_k * recip rows) as pallas_pme.py:373-379 does.  A
// point whose row rel + k lies at or past the window's width drops out, as
// the one-hot rows of the TPU kernel's spline matrices do.
//
// What bounds it on an H100: the windows (10.6 MB at the benchmark shapes)
// are read once in all, but an atom's 125 points are scattered over 25 rows,
// so latency and instruction count, as in the whole-grid kernel
// (csrc/pme_interp.cu), whose design this one takes: two threads an atom,
// in two warps, split its 25 (x, y) lines, numbered x plane by x plane (the
// warp of role 0 reads lines 0-12, role 1 lines 13-24, every line index a
// compile-time constant of the warp's body), and a line's 5 z points are
// read as the kVec-aligned chunks that hold them (two float4 where window
// rows start on 16 bytes, as with the 16-point rows of the benchmark)
// against weights that are zero off the 5 points.  Role 0 adds role 1's
// shares, read back from shared memory, in a fixed order: the forces are
// bitwise repeatable.  What differs from the whole grid: a window has edges
// instead of a wrap.  An atom's first row rel = (base - (B*p - 1)) mod n is
// formed once per atom and axis by compares; a line whose x or y row is at
// or past the window's width is not loaded, and neither is a z chunk that
// starts at or past it (it would read the next row, or past the last
// window), its weights zero.  The brick of a slot and its (X, Y, Z)
// coordinates come from three integer divisions per atom (64-bit
// multiply-high divisions by numbers made on the host measured slower),
// and 256 atoms a block measured faster than 64 or 128 (PERF.md §6).  A
// pad slot (q = 0) skips the reads and writes its zero force.  No atomics:
// role 0 owns its atom's force.

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace {

constexpr int kMargin = nbs::kPmeOrder + 1;   // w = p + 6
constexpr int kThreads = 512;
constexpr int kAtoms = kThreads / 2;   // atoms a block: two warps per 32
constexpr int kPoints2d = nbs::kPmeOrder * nbs::kPmeOrder;   // (x, y) lines
constexpr int kSplit = (kPoints2d + 1) / 2;   // role 0's lines: 0 .. 12

struct WindowShape {
    int capacity, nsub, nbx, nby, nbz, px, py, pz;
};

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

// Window row of an atom's first spline point: (base - (B*p - 1)) mod n for
// base in [0, n) and B*p - 1 in [-1, n - 1], by compares.
__device__ __forceinline__ int window_row(int base, int B, int p, int n) {
    const int r = base - B * p + 1;   // in [2 - n, n]
    return r < 0 ? r + n : wrap_once(r, n);
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

// An atom's z rows rz .. rz + 4 lie in kChunks chunks of kVec floats, the
// first starting at rz rounded down to kVec.  Rows start on kVec floats and
// wz is a multiple of kVec, so a chunk that starts before wz ends inside
// the row; one that starts at or past wz is dead: not loaded, weights 0.
template <int kVec>
struct ZChunks {
    static constexpr int kChunks = 1 + (nbs::kPmeOrder - 1 + kVec - 1) / kVec;
    static constexpr int kSpan = kChunks * kVec;
    int start[kChunks];
    bool live[kChunks];
    float w[kSpan], dw[kSpan];   // theta_z, dtheta_z; 0 off the live points

    __device__ __forceinline__ ZChunks(int rz, int wz, const float* tz,
                                       const float* dz) {
        const int o = rz & (kVec - 1);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            start[c] = rz - o + c * kVec;
            live[c] = start[c] < wz;
        }
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
            w[i] = 0.0f;
            dw[i] = 0.0f;
#pragma unroll
            for (int oo = 0; oo < kVec; ++oo) {
                const int c = i - oo;
                if (c >= 0 && c < nbs::kPmeOrder && o == oo
                    && live[i / kVec]) {
                    w[i] = tz[c];
                    dw[i] = dz[c];
                }
            }
        }
    }

    // one (x, y) line: its live z points against theta_z and dtheta_z,
    // added to the thread's three gradient sums; a line that is not live
    // (an x or y row past the window) loads nothing and adds zeros.  The
    // loads are predicated, not branched around, so that the loads of a
    // thread's lines stay in flight together.
    __device__ __forceinline__ void line(const float* __restrict__ row,
                                         bool line_live, float tx, float dx,
                                         float ty, float dy, float* g) const {
        using T = typename Vec<kVec>::T;
        float e[kSpan];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            T chunk{};
            if (line_live && live[c])
                chunk = *reinterpret_cast<const T*>(row + start[c]);
            unpack(chunk, e + c * kVec);
        }
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

// What a thread knows of its atom after the splines: its window rows and
// weights.  xoff / yoff are the offsets of x planes and y rows in the
// window; a row at or past the window's width is not live.
struct AtomRows {
    int xoff[nbs::kPmeOrder], yoff[nbs::kPmeOrder];
    bool xlive[nbs::kPmeOrder], ylive[nbs::kPmeOrder];
    float tx[nbs::kPmeOrder], ty[nbs::kPmeOrder];
    float dx[nbs::kPmeOrder], dy[nbs::kPmeOrder];
};

// Lines [kFirst, kLast) of one atom's 25, line l in x plane l / 5 and y row
// l % 5, in order, added to the thread's three gradient sums; a line with a
// dead x or y row reads nothing.
template <int kVec, int kFirst, int kLast>
__device__ __forceinline__ void lines(const ZChunks<kVec>& zc,
                                      const AtomRows& ar,
                                      const float* win, float* g) {
#pragma unroll
    for (int l = kFirst; l < kLast; ++l) {
        const int a = l / nbs::kPmeOrder, b = l % nbs::kPmeOrder;
        zc.line(win + ar.xoff[a] + ar.yoff[b], ar.xlive[a] && ar.ylive[b],
                ar.tx[a], ar.dx[a], ar.ty[b], ar.dy[b], g);
    }
}

// One thread's share of the gradient of the atom in slot k of brick
// `brick` (q != 0): its role's lines of the window `windows` + subset * size.
// (Written as functions apart from the kernel, this compiles to 104
// registers against 84 written inline, and reads 0.0065 against 0.0071 ms
// at the benchmark shapes; PERF.md §6.)
template <int kVec>
__device__ __forceinline__ void atom_share(
    const float* __restrict__ windows, const float* __restrict__ pos,
    const int* __restrict__ subset, const float* recip, int brick, int k,
    int role, const WindowShape& sh, float* g) {
    const int wx = sh.px + kMargin, wy = sh.py + kMargin, wz = sh.pz + kMargin;
    const int nx = sh.nbx * sh.px, ny = sh.nby * sh.py, nz = sh.nbz * sh.pz;
    const int X = brick / (sh.nbz * sh.nby);
    const int yz = brick - X * sh.nbz * sh.nby;
    const int Y = yz / sh.nbz, Z = yz - Y * sh.nbz;
    const float* p = pos + brick * 3 * sh.capacity + k;
    const float x = p[0], y = p[sh.capacity], z = p[2 * sh.capacity];
    int bx, by, bz;
    float ux, uy, uz;
    axis_base(x, y, z, recip, 0, nx, &bx, &ux);
    axis_base(x, y, z, recip, 1, ny, &by, &uy);
    axis_base(x, y, z, recip, 2, nz, &bz, &uz);
    const int rx = window_row(bx, X, sh.px, nx);
    const int ry = window_row(by, Y, sh.py, ny);
    const int rz = window_row(bz, Z, sh.pz, nz);
    AtomRows ar;
    float tz[nbs::kPmeOrder], dz[nbs::kPmeOrder];
    nbs::bspline5<float>(ux, ar.tx, ar.dx);
    nbs::bspline5<float>(uy, ar.ty, ar.dy);
    nbs::bspline5<float>(uz, tz, dz);
    const ZChunks<kVec> zc(rz, wz, tz, dz);
#pragma unroll
    for (int a = 0; a < nbs::kPmeOrder; ++a) {
        ar.xlive[a] = rx + a < wx;
        ar.ylive[a] = ry + a < wy;
        ar.xoff[a] = (rx + a) * wy * wz;
        ar.yoff[a] = (ry + a) * wz;
    }
    const float* win =
        windows + subset[brick * sh.capacity + k] * (wx * wy * wz);
    if (role == 0)   // uniform over the warp
        lines<kVec, 0, kSplit>(zc, ar, win, g);
    else
        lines<kVec, kSplit, kPoints2d>(zc, ar, win, g);
}

// Role 0's sums plus role 1's, in that order (the same bits every launch),
// turned into the atom's force by role 0.
__device__ __forceinline__ void write_force(float (*share)[3][32], int pair,
                                            int lane, float q, float* g,
                                            const float* recip_g, float* f,
                                            int capacity, int nx, int ny,
                                            int nz) {
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] += share[pair][a][lane];
    const float fx = g[0] * nx, fy = g[1] * ny, fz = g[2] * nz;
    f[0] = q == 0.0f ? 0.0f : -q * (fx * recip_g[0]);
    f[capacity] = q == 0.0f ? 0.0f : -q * (fx * recip_g[3] + fy * recip_g[4]);
    f[2 * capacity] = q == 0.0f ? 0.0f
                                : -q * (fx * recip_g[6] + fy * recip_g[7] +
                                        fz * recip_g[8]);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
interp_windows_kernel(const float* __restrict__ W,
                      const float* __restrict__ pos,
                      const float* __restrict__ charge,
                      const int* __restrict__ subset,
                      const float* __restrict__ recip_g,
                      float* __restrict__ forces, WindowShape sh,
                      int n_slots) {
    __shared__ float share[kAtoms / 32][3][32];   // role 1's sums
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int role = warp & 1;   // the warp's lines: 0-12 or 13-24
    const int pair = warp >> 1;
    const int s = blockIdx.x * kAtoms + pair * 32 + lane;
    const bool in_range = s < n_slots;
    const int brick = s / sh.capacity;
    const int k = s - brick * sh.capacity;
    const float q = in_range ? charge[s] : 0.0f;
    float g[3] = {0.0f, 0.0f, 0.0f};   // the thread's share of the gradient
    if (q != 0.0f) {   // pad slots (and neutral atoms) read no window point
        float recip[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
        const long long wsize = static_cast<long long>(sh.px + kMargin)
                                * (sh.py + kMargin) * (sh.pz + kMargin);
        atom_share<kVec>(W + brick * sh.nsub * wsize, pos, subset, recip,
                         brick, k, role, sh, g);
    }
    if (role == 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) share[pair][a][lane] = g[a];
    }
    __syncthreads();
    if (role == 1 || !in_range) return;
    write_force(share, pair, lane, q, g, recip_g,
                forces + brick * 3 * sh.capacity + k, sh.capacity,
                sh.nbx * sh.px, sh.nby * sh.py, sh.nbz * sh.pz);
}

template <int kVec>
void launch(const void* W, const void* pos, const void* charge,
            const void* subset, const void* recip, void* forces,
            const WindowShape& sh, cudaStream_t stream) {
    const int n_slots = sh.nbx * sh.nby * sh.nbz * sh.capacity;
    interp_windows_kernel<kVec><<<(n_slots + kAtoms - 1) / kAtoms, kThreads,
                                  0, stream>>>(
        static_cast<const float*>(W), static_cast<const float*>(pos),
        static_cast<const float*>(charge), static_cast<const int*>(subset),
        static_cast<const float*>(recip), static_cast<float*>(forces), sh,
        n_slots);
}

}  // namespace

// W: combined potential windows (nbx, nby, nbz, nsub, wx, wy, wz), w = p + 6
// <= 2p; pos (bricks, 3, capacity), charge and subset (bricks, capacity)
// brick-major; forces: (bricks, 3, capacity).  Returns the cudaError_t of
// the launch.
extern "C" int nbs_pme_interp_windows(const void* W, const void* pos,
                                      const void* charge, const void* subset,
                                      const void* recip, void* forces,
                                      int capacity, int nsub, int nbx,
                                      int nby, int nbz, int px, int py,
                                      int pz, void* stream) {
    const WindowShape sh{capacity, nsub, nbx, nby, nbz, px, py, pz};
    const int wz = pz + kMargin;
    const size_t at = reinterpret_cast<size_t>(W);
    const auto st = static_cast<cudaStream_t>(stream);
    if (wz % 4 == 0 && at % 16 == 0) {
        launch<4>(W, pos, charge, subset, recip, forces, sh, st);
    } else if (wz % 2 == 0 && at % 8 == 0) {
        launch<2>(W, pos, charge, subset, recip, forces, sh, st);
    } else {
        launch<1>(W, pos, charge, subset, recip, forces, sh, st);
    }
    return static_cast<int>(cudaGetLastError());
}
