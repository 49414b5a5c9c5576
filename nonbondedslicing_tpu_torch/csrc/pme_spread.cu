// PME charge spreading into per-subset grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_spread_kernel
// (pallas_call at pallas_pme.py:156), which builds per-brick charge windows
// W = sum q * onehot_s * T_x (x) T_y (x) T_z as bf16x3 MXU products.  Here
// each slot atom adds q * theta_x * theta_y * theta_z to its subset's
// (nx, ny, nz) grid at the 125 points (base + k) mod n, the grid index
// convention the window origin b*p - 1 of the TPU kernel gives.  The
// weights are any per-slot value: charges, or LJPME's C6 on its dispersion
// grid.
//
// Owner computes (spread_common.cuh has the shared design).  The slot
// groups (cells, or bricks of cells) come from fractional coordinates, as
// grid points do, so group c of a lattice of nc groups on an axis owns the
// grid points i with ceil(c n / nc) <= i < ceil((c + 1) n / nc).  One block
// owns them (or, where the region would not fit a block's shared memory,
// `parts` blocks, each a slab of the owned x range):
//
//   1. it scans the slots of the (2R+1)^3 groups around its own, periodic
//      in the lattice (every group once where 2R+1 covers an axis), a warp
//      a group with its lanes' loads issued together, and lists the
//      charged ones whose 5-point stencil meets its range: on each axis on
//      which the group lies off the block's own, by the atom's grid base
//      (modulo n);
//   2. stages the listed slots' splines, 512 at a time (256 in double),
//      lists their lines in the range and adds the lines' points to a
//      shared-memory region in 64-bit fixed point;
//   3. converts each owned point once and stores it.
//
// R, per axis, comes from the host (ops/cuda_pme.py::spread_radius): the
// fewest group widths that cover the stencil's reach of 4 points and the
// drift an atom may make between slot rebuilds (half the skin, in grid
// points).  An atom that drifted further is a skin violation, which the MD
// step reports after its run.
//
// The contributions are those of the design before (a thread per atom and
// 125 global 64-bit atomics into a zeroed accumulator, then a conversion
// pass), rounded to the same fixed-point integers and summed exactly, so
// the double grid equals that design's to the bit; the float grid differs
// from it by at most a float step at a point, where its rounding is
// carried along z (spread_common.cuh).  One launch, no accumulator in
// device memory, and no global atomics.
//
// What bounds it on an H100: by its inputs, bytes (the slots read once, the
// grid written once: 2.6 MB at the benchmark's 3 x 60^3); in fact the
// shared-memory adds (125 a charged atom, 2.9 M at the benchmark), each
// block's scan of its neighbours' slots (3,672 at 27 cells of 136 slots)
// and the staging of the atoms it lists (each atom by about 2.7 blocks on
// 60^3 points, 6 on the 30^3 dispersion grid).
//
// Evaluations with energies take the double variant: fractional
// coordinates, splines and weights in double from a double reciprocal box,
// a double grid, in 2^-40 fixed point.  A weakly coupled slice's reciprocal
// energy (a solute's with the water around it) is a small cross term of two
// large grids, which float spline weights would blur by about as much as
// its dE/dlambda is allowed to err.  The finer step keeps the double grid's
// rounding (about a hundred adds a point of half a step each) far below
// 1e-7 of its largest value for weights as small as C6 (about 0.05 for a
// water oxygen, where a grid's largest value is 0.02; 2^-32 left 1.3e-7);
// grid values up to 2^23 still fit the 64-bit sums.

#include <cuda_runtime.h>

#include "spread_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 5;      // 32-slot pieces a warp scans at once
// a block's opt-in limit on sm_90 (232,448 bytes), less room for the
// kernel's static shared memory
constexpr int kMaxSharedBytes = 232448 - 256;

// atoms staged at a time: a thread's one, or half of them in double
template <typename Real>
__host__ __device__ constexpr int stage_atoms() {
    return sizeof(Real) == 4 ? kThreads : kThreads / 2;
}

template <typename Real>
constexpr int stage_bytes() {
    return stage_atoms<Real>()
           * (nbs::kStageStride * static_cast<int>(sizeof(Real)) + 32
              + 2 * nbs::kPmeOrder * nbs::kPmeOrder);
}

// first grid point owned by group c of nc on an axis of n points
__host__ __device__ __forceinline__ int owned_start(int c, int n, int nc) {
    return (c * n + nc - 1) / nc;
}

// the neighbour group at index j of the `span` groups around group c
// (radius r): every group once when span covers the axis
__device__ __forceinline__ int neighbour(int c, int j, int r, int span,
                                         int nc) {
    return span == nc ? j : (c - r + j + nc) % nc;
}

// (a - b) mod n for a, b in [0, n)
__device__ __forceinline__ int mod_diff(int a, int b, int n) {
    const int d = a - b;
    return d < 0 ? d + n : d;
}

// does a stencil whose first point lies at grid line `base` meet the range
// of m lines from lo, modulo n?
__device__ __forceinline__ bool meets(int base, int lo, int m, int n) {
    const int rel = mod_diff(base, lo, n);
    return rel < m || rel + nbs::kPmeOrder - 1 >= n;
}

template <typename Real>
__global__ void __launch_bounds__(kThreads, 2)
spread_owner_kernel(const float* __restrict__ pos,
                    const float* __restrict__ charge,
                    const int* __restrict__ subset,
                    const Real* __restrict__ recip_g, Real* __restrict__ grid,
                    int ncx, int ncy, int ncz, int capacity, int nsub, int nx,
                    int ny, int nz, int rx, int ry, int rz, int parts,
                    int subsets_per_pass, int groups_per_list,
                    nbs::RegionLayout layout) {
    constexpr int kStage = stage_atoms<Real>();
    extern __shared__ __align__(16) unsigned char shared_raw[];
    __shared__ int n_listed, n_lines;
    __shared__ int warp_sums[kWarps];
    nbs::Stage<Real> st;
    st.t = reinterpret_cast<Real*>(shared_raw);
    st.rows = reinterpret_cast<int4*>(st.t + kStage * nbs::kStageStride);
    st.pts = st.rows + kStage;
    st.lines = reinterpret_cast<unsigned short*>(st.pts + kStage);
    st.warps = warp_sums;
    st.n_lines = &n_lines;
    int* list = reinterpret_cast<int*>(
        st.lines + kStage * nbs::kPmeOrder * nbs::kPmeOrder);
    const nbs::FixedRegion acc{
        reinterpret_cast<unsigned*>(list + groups_per_list * capacity),
        reinterpret_cast<unsigned*>(list + groups_per_list * capacity)
            + subsets_per_pass * layout.ps};

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int group = blockIdx.x / parts;
    const int part = blockIdx.x - group * parts;
    const int cz = group % ncz;
    const int cy = (group / ncz) % ncy;
    const int cx = group / (ncz * ncy);
    const int x_lo = owned_start(cx, nx, ncx);
    const int x_all = owned_start(cx + 1, nx, ncx) - x_lo;
    const int x0 = x_lo + part * x_all / parts;
    const int y0 = owned_start(cy, ny, ncy);
    const int z0 = owned_start(cz, nz, ncz);
    const int3 m = make_int3(x_lo + (part + 1) * x_all / parts - x0,
                             owned_start(cy + 1, ny, ncy) - y0,
                             owned_start(cz + 1, nz, ncz) - z0);
    if (m.x <= 0) return;   // more parts than owned x points
    const int3 n = make_int3(nx, ny, nz);
    Real recip[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) recip[i] = recip_g[i];
    const int sx = min(2 * rx + 1, ncx);
    const int sy = min(2 * ry + 1, ncy);
    const int sz = min(2 * rz + 1, ncz);
    const int n_groups = sx * sy * sz;

    for (int s0 = 0; s0 < nsub; s0 += subsets_per_pass) {
        const int ns = min(subsets_per_pass, nsub - s0);
        acc.zero(ns * layout.ps);
        for (int b0 = 0; b0 < n_groups; b0 += groups_per_list) {
            if (threadIdx.x == 0) n_listed = 0;
            __syncthreads();   // region zeroed, the last list used up
            // 1. list the slots of the batch's neighbour groups whose
            // stencil meets the range.  A warp takes whole groups, its
            // lanes kScan 32-slot pieces at a time with their loads issued
            // together; only the axes on which a group lies off the
            // block's own need a grid base (on its own axis every stencil
            // meets the range but for an atom that drifted above it, which
            // lists no line)
            const int b1 = min(b0 + groups_per_list, n_groups);
            for (int nb = b0 + warp; nb < b1; nb += kWarps) {
                const int gx = neighbour(cx, nb / (sy * sz), rx, sx, ncx);
                const int gy = neighbour(cy, (nb / sz) % sy, ry, sy, ncy);
                const int gz = neighbour(cz, nb % sz, rz, sz, ncz);
                const int g = (gx * ncy + gy) * ncz + gz;
                for (int k0 = 0; k0 < capacity; k0 += 32 * kScan) {
                    float q[kScan], x[kScan], y[kScan], z[kScan];
                    int sub[kScan];
#pragma unroll
                    for (int u = 0; u < kScan; ++u) {
                        const int k = k0 + 32 * u + lane;
                        const int at = g * capacity + (k < capacity ? k : 0);
                        q[u] = k < capacity ? charge[at] : 0.0f;
                        sub[u] = subset[at];
                        nbs::slot_position<float>(pos, g, at - g * capacity,
                                                  capacity, &x[u], &y[u],
                                                  &z[u]);
                    }
                    unsigned keep = 0u;
#pragma unroll
                    for (int u = 0; u < kScan; ++u) {
                        // pads and neutral atoms add nothing
                        bool in = q[u] != 0.0f
                                  && static_cast<unsigned>(sub[u] - s0)
                                     < static_cast<unsigned>(ns);
                        int base;
                        Real frac;
                        if (in && gx != cx) {
                            nbs::spread_base<Real>(x[u], y[u], z[u], recip,
                                                   0, nx, &base, &frac);
                            in = meets(base, x0, m.x, nx);
                        }
                        if (in && gy != cy) {
                            nbs::spread_base<Real>(x[u], y[u], z[u], recip,
                                                   1, ny, &base, &frac);
                            in = meets(base, y0, m.y, ny);
                        }
                        if (in && gz != cz) {
                            nbs::spread_base<Real>(x[u], y[u], z[u], recip,
                                                   2, nz, &base, &frac);
                            in = meets(base, z0, m.z, nz);
                        }
                        keep |= static_cast<unsigned>(in) << u;
                    }
                    int at = nbs::claim(__popc(keep), &n_listed);
#pragma unroll
                    for (int u = 0; u < kScan; ++u) {
                        if (keep >> u & 1u) {
                            list[at++] = g * capacity + k0 + 32 * u + lane;
                        }
                    }
                }
            }
            __syncthreads();
            const int n_list = n_listed;
            // 2. stage the listed slots, list their lines in the range and
            // add the lines' points
            for (int a0 = 0; a0 < n_list; a0 += kStage) {
                const int na = min(kStage, n_list - a0);
                int count = 0;
                if (threadIdx.x < na) {
                    count = nbs::stage_atom<Real>(
                        st, threadIdx.x, list[a0 + threadIdx.x], capacity,
                        pos, charge, recip, n,
                        [&](const int* base, int slot) {
                            return make_int4(mod_diff(base[0], x0, nx),
                                             mod_diff(base[1], y0, ny),
                                             mod_diff(base[2], z0, nz),
                                             subset[slot] - s0);
                        },
                        m, n);
                }
                const int lines = nbs::list_lines(st, count, na);
                nbs::accumulate<Real>(st, lines, n, layout, acc);
                __syncthreads();   // the stage is used up
            }
        }
        // 3. convert and store the owned points (the last sync above, or
        // the one after the list when it was empty, saw every add): float
        // sums rounded a z line a thread, then every point stored
        const float inv_mz = 1.0f / m.z, inv_my = 1.0f / m.y,
                    inv_mx = 1.0f / m.x;
        if constexpr (sizeof(Real) == 4) {
            for (int line = threadIdx.x; line < ns * m.x * m.y;
                 line += kThreads) {
                const int plane = nbs::div_small(line, m.y, inv_my);
                const int s = nbs::div_small(plane, m.x, inv_mx);
                acc.round_line(layout.at(s, plane - s * m.x,
                                         line - plane * m.y, 0), m.z);
            }
            __syncthreads();
        }
        for (int i = threadIdx.x; i < ns * m.x * m.y * m.z; i += kThreads) {
            const int line = nbs::div_small(i, m.z, inv_mz);
            const int uz = i - line * m.z;
            const int plane = nbs::div_small(line, m.y, inv_my);
            const int uy = line - plane * m.y;
            const int s = nbs::div_small(plane, m.x, inv_mx);
            const int ux = plane - s * m.x;
            grid[((static_cast<long long>(s0 + s) * nx + x0 + ux) * ny + y0
                  + uy) * nz + z0 + uz] =
                acc.stored<Real>(layout.at(s, ux, uy, uz));
        }
        __syncthreads();   // before the next pass zeroes the region
    }
}

template <typename Real>
int spread(const void* pos, const void* charge, const void* subset,
           const void* recip, void* grid, int ncx, int ncy, int ncz,
           int capacity, int nsub, int nx, int ny, int nz, int rx, int ry,
           int rz, cudaStream_t st) {
    // the largest owned range per axis, cut into `parts` slabs along x, as
    // many as one subset's region needs to fit a block beside the stage and
    // a list of one neighbour group's slots (one at every size measured)
    const int mx = owned_start(1, nx, ncx), my = owned_start(1, ny, ncy),
              mz = owned_start(1, nz, ncz);
    const long long budget =
        kMaxSharedBytes - stage_bytes<Real>() - 4LL * capacity;
    int parts = 1;
    nbs::RegionLayout layout;
    for (;; ++parts) {
        layout = nbs::RegionLayout::cached((mx + parts - 1) / parts, my, mz);
        if (parts >= mx || 8LL * layout.ps <= budget) break;
    }
    const long long region = 8LL * layout.ps;
    if (region > budget) return static_cast<int>(cudaErrorInvalidValue);
    const int subsets_per_pass =
        static_cast<int>(budget / region < nsub ? budget / region : nsub);
    // the list holds the slots of as many neighbour groups as fit, all of
    // them where they do
    const int n_groups = (2 * rx + 1 < ncx ? 2 * rx + 1 : ncx)
                         * (2 * ry + 1 < ncy ? 2 * ry + 1 : ncy)
                         * (2 * rz + 1 < ncz ? 2 * rz + 1 : ncz);
    const long long room = budget + 4LL * capacity - subsets_per_pass * region;
    const long long fit = room / (4LL * capacity);
    const int groups_per_list = static_cast<int>(fit < n_groups ? fit
                                                                : n_groups);
    const int shared_bytes = stage_bytes<Real>()
        + static_cast<int>(4LL * groups_per_list * capacity
                           + subsets_per_pass * region);
    cudaError_t err = cudaFuncSetAttribute(
        spread_owner_kernel<Real>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    spread_owner_kernel<Real><<<ncx * ncy * ncz * parts, kThreads,
                                shared_bytes, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const int*>(subset), static_cast<const Real*>(recip),
        static_cast<Real*>(grid), ncx, ncy, ncz, capacity, nsub, nx, ny, nz,
        rx, ry, rz, parts, subsets_per_pass, groups_per_list, layout);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (groups, 3, capacity), charge and subset (groups, capacity) slot
// tensors grouped on the (ncx, ncy, ncz) lattice of fractional cells (cell-
// or brick-major); (rx, ry, rz) the neighbour radius in groups.  grid
// receives the weight grids (nsub, nx, ny, nz), every element written:
// float with recip a float (3, 3), or double (splines and weights in double
// too) with recip a double (3, 3) when double_precision is nonzero.
// Returns the
// cudaError_t of the launch, cudaErrorInvalidValue when one x plane of a
// group's range does not fit a block's shared memory.
extern "C" int nbs_pme_spread(const void* pos, const void* charge,
                              const void* subset, const void* recip,
                              void* grid, int ncx, int ncy, int ncz,
                              int capacity, int nsub, int nx, int ny, int nz,
                              int rx, int ry, int rz, int double_precision,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (double_precision) {
        return spread<double>(pos, charge, subset, recip, grid, ncx, ncy, ncz,
                              capacity, nsub, nx, ny, nz, rx, ry, rz, st);
    }
    return spread<float>(pos, charge, subset, recip, grid, ncx, ncy, ncz,
                         capacity, nsub, nx, ny, nz, rx, ry, rz, st);
}
