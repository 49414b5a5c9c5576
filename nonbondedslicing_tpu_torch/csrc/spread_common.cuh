// The design shared by the two PME spread kernels (pme_spread.cu: the whole
// grid; pme_spread_windows.cu: per-brick windows).
//
// A block owns a box-shaped region of points, rows [0, m) per axis of one
// or more subsets, and sums into it in shared memory; nothing else writes
// those points, so there are no global atomics and every output element is
// written once, with a plain store.  The region is the block's owned grid
// points in the whole-grid kernel (periodic: a spline row wraps modulo n)
// and a brick's window, or a slab of it, in the window kernel (not
// periodic: a row outside it drops out).
//
//   1. listing: the kernel lists the slots whose atoms it spreads (a warp
//      claims its entries with one shared atomic);
//   2. staging, a chunk of listed atoms at a time: an atom's three order-5
//      B-spline weight sets (the weight folded into the x set), the region
//      row of its first spline point on each axis, and on each axis the
//      spline points that fall in the region;
//   3. accumulation: the staged atoms' (x point, y point) lines in the
//      region go into a list (a prefix sum over the atoms places them), and
//      one thread per listed line adds its z points in the region as 64-bit
//      fixed-point integers (2^-32 steps for float weights, 2^-40 for
//      double).  Integer sums do not depend on their order, so the region
//      comes out the same to the bit from launch to launch whatever order
//      the threads add in;
//   4. convert and store: every point of the region once, to float (or
//      double), with plain stores.  Float values are rounded along each z
//      line with the rest carried to the next point (round_line), so that
//      a line's floats add up to its fixed-point sum but for the last
//      point's rounding: a grid's total, a subset's charge, then keeps the
//      exact sum of its contributions, where rounding each point alone
//      leaves an error that grows with the number of points.  A point
//      moves by at most one float step more.
//
// The 64-bit sums live in shared memory as a pair of 32-bit words a point:
// a 64-bit atomicAdd on shared memory compiles to a compare-and-swap loop
// on sm_90a (ATOMS.CAST.SPIN.64), a 32-bit one to a single ATOMS.ADD.  A
// contribution adds its low word, detects the carry from the value the add
// returns, and adds its high word plus the carry where that is not zero.
// That is exact modulo 2^64, like the 64-bit add, and as free of order.
// The region's rows are padded (RegionLayout) so that the 25 lines of one
// atom, which neighbouring threads add at once, fall in 25 different
// shared-memory banks.

#pragma once

#include <cuda_runtime.h>

#include "bspline.cuh"

namespace nbs {

// Reals per staged atom: q * theta_x, theta_y, theta_z (an odd stride, so
// that the atoms of a warp store their weights in different banks)
constexpr int kStageStride = 15;
constexpr unsigned kFullWarp = 0xffffffffu;

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
__device__ __forceinline__ Real fixed_to_real(long long v) {
    return static_cast<Real>(static_cast<double>(v) * Fixed<Real>::kInv);
}

// Point (s, ux, uy, uz) of a region at s * ps + ux * px + uy * py + uz.
struct RegionLayout {
    int py, px, ps;

    __host__ __device__ int at(int s, int ux, int uy, int uz) const {
        return s * ps + ux * px + uy * py + uz;
    }

    // The pitches of a region of m = (mx, my, mz) rows: the smallest
    // paddings of the y and x rows (py >= mz, px >= my * py) that put the
    // points (a, b) of a 5 x 5 set of lines in as few shared-memory banks
    // at once as they can (one each at the sizes the benchmarks use).
    static RegionLayout of(int mx, int my, int mz) {
        RegionLayout best{mz, my * mz, mx * my * mz};
        int best_way = 1 << 30;
        for (int dy = 0; dy < 8; ++dy) {
            for (int dx = 0; dx < 32; ++dx) {
                const int py = mz + dy;
                const int px = my * py + dx;
                int count[32] = {0};
                int way = 0;
                for (int a = 0; a < kPmeOrder; ++a) {
                    for (int b = 0; b < kPmeOrder; ++b) {
                        const int c = ++count[(a * px + b * py) % 32];
                        way = c > way ? c : way;
                    }
                }
                if (way < best_way || (way == best_way && mx * px < best.ps)) {
                    best = RegionLayout{py, px, mx * px};
                    best_way = way;
                }
            }
        }
        return best;
    }

    // of(), remembered for the last few sizes asked for by this host
    // thread (the search costs more than a launch)
    static RegionLayout cached(int mx, int my, int mz) {
        constexpr int kKept = 8;
        static thread_local int keys[kKept][3] = {};
        static thread_local RegionLayout kept[kKept];
        static thread_local int next = 0;
        for (int i = 0; i < kKept; ++i) {
            if (keys[i][0] == mx && keys[i][1] == my && keys[i][2] == mz) {
                return kept[i];
            }
        }
        kept[next] = of(mx, my, mz);
        keys[next][0] = mx;
        keys[next][1] = my;
        keys[next][2] = mz;
        const RegionLayout out = kept[next];
        next = (next + 1) % kKept;
        return out;
    }
};

// 64-bit fixed-point sums in shared memory, as low and high 32-bit words
// (see the header comment; accumulate() adds to them).
struct FixedRegion {
    unsigned* lo;
    unsigned* hi;

    __device__ __forceinline__ void zero(int words) const {
        for (int i = threadIdx.x; i < words; i += blockDim.x) {
            lo[i] = 0u;
            hi[i] = 0u;
        }
    }

    __device__ __forceinline__ long long value(int i) const {
        return static_cast<long long>(
            (static_cast<unsigned long long>(hi[i]) << 32) | lo[i]);
    }

    // Step 4, float sums: rounds the z line of `count` points from point
    // `at` to floats, each the float nearest to its sum plus what the
    // points before it left over, and keeps the floats' bits in the lo
    // words (read them with stored<float>).  A float of 2^-8 or more is a
    // whole number of 2^-32 steps and a smaller one is its exact sum, so
    // the rest is exact.
    __device__ __forceinline__ void round_line(int at, int count) const {
        long long rest = 0;
        for (int uz = 0; uz < count; ++uz) {
            const long long v = value(at + uz) + rest;
            const float f = fixed_to_real<float>(v);
            rest = v - static_cast<long long>(static_cast<double>(f)
                                              / Fixed<float>::kInv);
            lo[at + uz] = __float_as_uint(f);
        }
    }

    // The stored value of point i: the float round_line left, or the
    // double nearest to the sum.
    template <typename Real>
    __device__ __forceinline__ Real stored(int i) const;
};

template <>
__device__ __forceinline__ float FixedRegion::stored<float>(int i) const {
    return __uint_as_float(lo[i]);
}
template <>
__device__ __forceinline__ double FixedRegion::stored<double>(int i) const {
    return fixed_to_real<double>(value(i));
}

// Entries of a list in shared memory for a warp's threads, with one shared
// atomic a warp: each thread asks for `count` entries (0 for none) and gets
// the index of its first one.  Every thread of the warp must call it.
__device__ __forceinline__ int claim(int count, int* counter) {
    const int lane = threadIdx.x & 31;
    int upto = count;   // inclusive prefix sum over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFullWarp, upto, d);
        if (lane >= d) upto += v;
    }
    int base = 0;
    if (lane == 31 && upto > 0) base = atomicAdd(counter, upto);
    return __shfl_sync(kFullWarp, base, 31) + upto - count;
}

// The Cartesian position of slot k of group g in a (groups, 3, capacity)
// slot tensor.
template <typename Real>
__device__ __forceinline__ void slot_position(const float* __restrict__ pos,
                                              int g, int k, int capacity,
                                              Real* x, Real* y, Real* z) {
    *x = pos[(g * 3 + 0) * capacity + k];
    *y = pos[(g * 3 + 1) * capacity + k];
    *z = pos[(g * 3 + 2) * capacity + k];
}

// bspline.cuh's grid_base, the same arithmetic, with the base reduced
// without an integer division: floor(t) lies in [0, n] (n when
// f - floor(f) rounds to 1)
template <typename Real>
__device__ __forceinline__ void spread_base(Real x, Real y, Real z,
                                            const Real* recip, int axis,
                                            int n, int* base, Real* frac) {
    const Real f = x * recip[axis] + y * recip[3 + axis] + z * recip[6 + axis];
    const Real t = (f - floor_real(f)) * static_cast<Real>(n);
    const Real ti = floor_real(t);
    *frac = t - ti;
    const int i = static_cast<int>(ti);
    *base = i >= n ? i - n : i;
}

// Grid bases of a position on the (nx, ny, nz) grid, and its staged spline
// weights: t[0..4] = q * theta_x, t[5..9] = theta_y,
// t[10..14] = theta_z, the products the whole-grid spread has always formed
// (q * theta_x) * theta_y * theta_z, in that order.
template <typename Real>
__device__ inline void stage_splines(Real x, Real y, Real z, Real q,
                                     const Real* recip, int nx, int ny,
                                     int nz, int* base, Real* t) {
    Real fx, fy, fz;
    spread_base<Real>(x, y, z, recip, 0, nx, &base[0], &fx);
    spread_base<Real>(x, y, z, recip, 1, ny, &base[1], &fy);
    spread_base<Real>(x, y, z, recip, 2, nz, &base[2], &fz);
    Real tx[kPmeOrder], ty[kPmeOrder], tz[kPmeOrder];
    bspline5<Real>(fx, tx, nullptr);
    bspline5<Real>(fy, ty, nullptr);
    bspline5<Real>(fz, tz, nullptr);
#pragma unroll
    for (int i = 0; i < kPmeOrder; ++i) {
        t[i] = q * tx[i];
        t[kPmeOrder + i] = ty[i];
        t[2 * kPmeOrder + i] = tz[i];
    }
}

// Region row of spline point k of an atom whose first point lies at row
// `rel`: rel + k, taken modulo `wrap` where the region's axis is periodic
// (wrap = n >= kPmeOrder, rel in [0, n)); wrap = 0 leaves it as it is.  The
// row is in the region when it is in [0, m) as an unsigned value.
__device__ __forceinline__ int region_row(int rel, int k, int wrap) {
    const int r = rel + k;
    return r >= wrap ? r - wrap : r;
}

// The spline points k of one axis whose rows fall in [0, m): their k,
// 3 bits each from bit 0, and their number from bit 15.
__device__ __forceinline__ int points_in(int rel, int m, int wrap) {
    int list = 0, n = 0;
#pragma unroll
    for (int k = 0; k < kPmeOrder; ++k) {
        const int u = region_row(rel, k, wrap);
        if (static_cast<unsigned>(u) < static_cast<unsigned>(m)) {
            list |= k << (3 * n);
            ++n;
        }
    }
    return list | (n << 15);
}

// i / d for 0 <= i < 2^22, from the float reciprocal inv_d of d > 0 and
// one correction: a few instructions where an integer division takes twenty
__device__ __forceinline__ int div_small(int i, int d, float inv_d) {
    int q = __float2int_rz(__int2float_rn(i) * inv_d);
    const int r = i - q * d;
    q += (r >= d) - (r < 0);
    return q;
}

// The atoms staged at a time (at most 512): spline weights, first rows and
// subset in the region, points_in of each axis, and the list of their
// (x point, y point) lines in the region, (atom, kx, ky) packed as
// atom | kx << 9 | ky << 12.
template <typename Real>
struct Stage {
    Real* t;                // (atoms, kStageStride)
    int4* rows;             // (rel_x, rel_y, rel_z, subset in the region)
    int4* pts;              // points_in of x, y and z
    unsigned short* lines;  // up to kPmeOrder^2 an atom
    int* warps;             // (blockDim / 32) scratch of the prefix sum
    int* n_lines;           // the list's length
};

// Step 2 for one slot (group g = slot / capacity), staged as atom a;
// rows_of(base, slot) gives its first rows (x, y, z) and its subset in the
// region from its grid bases.  Returns the atom's number of lines in the
// region.
template <typename Real, typename RowsOf>
__device__ inline int stage_atom(const Stage<Real>& st, int a, int slot,
                                 int capacity, const float* __restrict__ pos,
                                 const float* __restrict__ charge,
                                 const Real* recip, int3 n, RowsOf rows_of,
                                 int3 m, int3 wrap) {
    const int g = slot / capacity;
    Real x, y, z;
    slot_position<Real>(pos, g, slot - g * capacity, capacity, &x, &y, &z);
    int base[3];
    stage_splines<Real>(x, y, z, static_cast<Real>(charge[slot]), recip, n.x,
                        n.y, n.z, base, st.t + a * kStageStride);
    const int4 rows = rows_of(base, slot);
    const int kx = points_in(rows.x, m.x, wrap.x);
    const int ky = points_in(rows.y, m.y, wrap.y);
    st.rows[a] = rows;
    st.pts[a] = make_int4(kx, ky, points_in(rows.z, m.z, wrap.z), 0);
    return (kx >> 15) * (ky >> 15);
}

// The list of the chunk's lines: an exclusive prefix sum over the block's
// threads of `count` (0 beyond the na staged atoms, na <= blockDim.x) says
// where each atom's lines go, and the atom's thread writes them.  Every
// thread of the block calls it.  Returns the number of lines; ends with a
// barrier.
template <typename Real>
__device__ inline int list_lines(const Stage<Real>& st, int count, int na) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int upto = count;   // inclusive over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFullWarp, upto, d);
        if (lane >= d) upto += v;
    }
    if (lane == 31) st.warps[warp] = upto;
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        int w = lane < nw ? st.warps[lane] : 0;
        const int own = w;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFullWarp, w, d);
            if (lane >= d) w += v;
        }
        if (lane < nw) st.warps[lane] = w - own;   // exclusive
    }
    __syncthreads();
    int at = st.warps[warp] + upto - count;
    if (threadIdx.x == na - 1) *st.n_lines = at + count;
    if (threadIdx.x < na && count > 0) {
        const int4 p = st.pts[threadIdx.x];
        for (int ix = 0; ix < (p.x >> 15); ++ix) {
            for (int iy = 0; iy < (p.y >> 15); ++iy) {
                st.lines[at++] = static_cast<unsigned short>(
                    threadIdx.x | (((p.x >> (3 * ix)) & 7) << 9)
                    | (((p.y >> (3 * iy)) & 7) << 12));
            }
        }
    }
    __syncthreads();
    return na > 0 ? *st.n_lines : 0;
}

// Step 3: adds the z points in the region of the chunk's `n_lines` listed
// lines.  A thread's lo adds go out before its carries are read, so that
// up to five of them are in flight at once.
template <typename Real>
__device__ inline void accumulate(const Stage<Real>& st, int n_lines,
                                  int3 wrap, RegionLayout layout,
                                  const FixedRegion& acc) {
    for (int i = threadIdx.x; i < n_lines; i += blockDim.x) {
        const int e = st.lines[i];
        const int a = e & 511;
        const int kx = (e >> 9) & 7;
        const int ky = (e >> 12) & 7;
        const int4 r = st.rows[a];
        const int kz = st.pts[a].z;
        const Real* ta = st.t + a * kStageStride;
        const Real qxy = ta[kx] * ta[kPmeOrder + ky];
        const int line = layout.at(r.w, region_row(r.x, kx, wrap.x),
                                   region_row(r.y, ky, wrap.y), 0);
        const int nz = kz >> 15;
        int at[kPmeOrder];
        unsigned v_lo[kPmeOrder], v_hi[kPmeOrder], old[kPmeOrder];
#pragma unroll
        for (int j = 0; j < kPmeOrder; ++j) {
            if (j < nz) {
                const int c = (kz >> (3 * j)) & 7;
                at[j] = line + region_row(r.z, c, wrap.z);
                const unsigned long long v = static_cast<unsigned long long>(
                    Fixed<Real>::to(qxy * ta[2 * kPmeOrder + c]));
                v_lo[j] = static_cast<unsigned>(v);
                v_hi[j] = static_cast<unsigned>(v >> 32);
                old[j] = atomicAdd(acc.lo + at[j], v_lo[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < kPmeOrder; ++j) {
            if (j < nz) {
                const unsigned hi = v_hi[j] + (old[j] + v_lo[j] < old[j]);
                if (hi != 0u) atomicAdd(acc.hi + at[j], hi);
            }
        }
    }
}

}  // namespace nbs
