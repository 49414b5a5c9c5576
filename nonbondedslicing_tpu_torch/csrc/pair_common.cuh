// What the two direct-space kernels, pair_column.cu (B1) and pair_cell.cu
// (B4), share: the physics of _make_pair_block
// (nonbondedslicing_tpu/ops/pallas_direct.py:64-313) for one pair, and the
// skeleton of their design.
//
// The skeleton.  A block owns the rows chunk, chunk + row_blocks, ... of one
// home cell; each of its warps takes every nwarps-th of them, one row atom
// at a time, and the 32 lanes span that row's candidates:
//
// * the positions (and, for the cell kernel, atom indices) of the real
//   slots of the 27 neighbour cells are staged in shared memory as one
//   compact list, cell by cell in slot order: pads (atom index >= n_real)
//   are left out, so no test is spent on them.  All 27 cells are staged at
//   once where their slots fit kStageBytes, else tile_cells at a time;
// * phase 1, the test: lane l loads candidates k0 + 4 l .. k0 + 4 l + 3 of
//   the staged tile with one 16-byte load per coordinate and tests them, so
//   a warp tests kStride = 128 candidates between two looks at its queue;
//   the hits go, in a fixed order, into the queue (a ring of kQueue 16-bit
//   entries in shared memory; ballot + popc give each hit its place).  The
//   test is the cheapest that loses no pair (a contracted r^2 against a
//   slightly widened cutoff; for the cell kernel on positions staged in one
//   frame of periodic images, or after a cheap minimum image; the row
//   itself is let in): phase 2 decides exactly;
// * phase 2, the physics: whenever the queue holds 32 entries the warp takes
//   them one per lane, so the expensive part (rsqrt, exp, the switch, the
//   lambda look-up) runs with every lane alive; the last partial batch of a
//   row is taken when the tile ends;
// * the reduction: lane l has summed entries l, l + 32, ... of its row; a
//   xor butterfly adds the 32 partial sums in a fixed order and one lane
//   writes the row's force.  Energy moments are reduced the same way and
//   added, row by row, to the warp's (2, nsub, nsub) panel in shared memory;
//   the block's warps are summed in order into moments[block].
//
// The queue's order is a function of the inputs alone, so forces and moments
// are the same bits on every launch; nothing is added atomically.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace nbs_pair {

constexpr int kMaxSubsets = 8;
constexpr int kMaxExclusions = 16;
constexpr int kMaxCapacity = 1024;
constexpr int kModeReactionField = 0;
constexpr int kModeEwald = 1;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

constexpr int kNeighbours = 27;      // the full shell, home cell included
constexpr int kHome = 13;            // its place among the 27
// 14 warps, two blocks an SM (a cap of 73 registers), a third of a 136-slot
// cell's rows per block: the fastest of the combinations timed on an H100
// (tune_pair.py; PERF.md).  More rows a block pay for its staging, more
// warps an SM hide the round trips of a warp's steps.
constexpr int kWarps = 14;           // warps of a block
constexpr int kRowsPerBlock = 48;    // rows of a home cell that a block owns
constexpr int kSteps = 4;            // candidates a lane tests per load
constexpr int kStride = 32 * kSteps; // candidates between two looks
constexpr int kQueue = 256;          // >= 31 + kStride, a power of two
// (two blocks of 96 KB and their tables fit an SM's 227 KB)
constexpr int kStageBytes = 96 * 1024;   // staged candidates of one tile
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMovedFlag = 1 << 15;  // of a staged candidate's tag

struct PairParams {
    int ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch;
    int n_real, row_blocks, tile_cells, cand_stride;
    float cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke;
};

// How a call is cut into blocks and tiles: row_blocks blocks per home cell,
// tile_cells neighbour cells staged at a time (cand_stride staged slots, a
// multiple of kStride), and the dynamic shared memory of a block.
struct LaunchShape {
    int row_blocks, threads, tile_cells, cand_stride, shmem;
};

inline LaunchShape launch_shape(int capacity, int nsub, bool stage_ids,
                                bool energies) {
    LaunchShape g;
    g.threads = 32 * kWarps;
    g.row_blocks = (capacity + kRowsPerBlock - 1) / kRowsPerBlock;
    const int fields = stage_ids ? 4 : 3;
    const int fit = kStageBytes / ((4 * fields + 2) * capacity);
    g.tile_cells = fit < 1 ? 1 : (fit > kNeighbours ? kNeighbours : fit);
    g.cand_stride = (g.tile_cells * capacity + kStride - 1) / kStride * kStride;
    const int words = fields * g.cand_stride + g.cand_stride / 2
                      + 2 * nsub * nsub + 5 * kNeighbours + 4
                      + kWarps * (kQueue / 2 + kMaxExclusions)
                      + (energies ? kWarps * 2 * nsub * nsub : 0);
    g.shmem = 4 * words;
    return g;
}

// Shared memory of one block.
struct Shared {
    float *x, *y, *z;     // staged candidates [cand_stride]
    int* id;              // their atom indices (cell kernel only)
    unsigned short* where;   // their neighbour cell (0..26) << 10 | slot;
                             // bit 15: staged in another image than given
    int* count;           // [27] staged slots of each cell of the tile
    float* frame;         // [4] the cell kernel's frame (home_frame)
    float *lam_c, *lam_v; // [nsub][nsub]
    int* ncell;           // [27] the home cell's neighbour cells
    float* shift;         // [27][3] their periodic image shifts
    unsigned short* queue;   // [warps][kQueue]
    int* excl;            // [warps][kMaxExclusions] the row's exclusions
    float* moments;       // [warps][2][nsub][nsub], with energies
};

__device__ __forceinline__ Shared carve(float* smem, const PairParams& p,
                                        bool stage_ids) {
    Shared s;
    s.x = smem;
    s.y = s.x + p.cand_stride;
    s.z = s.y + p.cand_stride;
    float* next = s.z + p.cand_stride;
    s.id = reinterpret_cast<int*>(next);
    if (stage_ids) next += p.cand_stride;
    s.where = reinterpret_cast<unsigned short*>(next);
    next += p.cand_stride / 2;
    s.lam_c = next;
    s.lam_v = s.lam_c + p.nsub * p.nsub;
    s.ncell = reinterpret_cast<int*>(s.lam_v + p.nsub * p.nsub);
    s.shift = reinterpret_cast<float*>(s.ncell + kNeighbours);
    s.count = reinterpret_cast<int*>(s.shift + 3 * kNeighbours);
    s.frame = reinterpret_cast<float*>(s.count + kNeighbours);
    s.excl = reinterpret_cast<int*>(s.frame + 4);
    s.queue = reinterpret_cast<unsigned short*>(
        s.excl + kWarps * kMaxExclusions);
    s.moments = reinterpret_cast<float*>(s.queue + kWarps * kQueue);
    return s;
}

// The block's tables: lambda matrices, the 27 neighbour cells of home cell
// `cell` with the image shift of each (the neighbour's true image sits at
// +w box vectors where the cell coordinate wrapped by w;
// pallas_direct.py:521-534), and zeroed moment panels.  The shift is summed
// as the plain twin sums it, every operation rounded.  Callers synchronise.
template <bool ENERGIES>
__device__ __forceinline__ void block_tables(const Shared& s,
                                             const PairParams& p, int cell,
                                             const float* lam_c,
                                             const float* lam_v,
                                             const float* box) {
    const int t = threadIdx.x;
    for (int k = t; k < p.nsub * p.nsub; k += blockDim.x) {
        s.lam_c[k] = lam_c[k];
        s.lam_v[k] = lam_v[k];
    }
    if (t < kNeighbours) {
        const int cz = cell % p.ncz;
        const int cy = (cell / p.ncz) % p.ncy;
        const int cx = cell / (p.ncy * p.ncz);
        int nx = cx + t / 9 - 1, ny = cy + (t / 3) % 3 - 1, nz = cz + t % 3 - 1;
        const int wx = nx < 0 ? -1 : (nx >= p.ncx ? 1 : 0);
        const int wy = ny < 0 ? -1 : (ny >= p.ncy ? 1 : 0);
        const int wz = nz < 0 ? -1 : (nz >= p.ncz ? 1 : 0);
        nx -= wx * p.ncx;
        ny -= wy * p.ncy;
        nz -= wz * p.ncz;
        s.ncell[t] = (nx * p.ncy + ny) * p.ncz + nz;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            s.shift[3 * t + c] = __fadd_rn(
                __fadd_rn(__fmul_rn(float(wx), box[c]),
                          __fmul_rn(float(wy), box[3 + c])),
                __fmul_rn(float(wz), box[6 + c]));
        }
    }
    if (ENERGIES) {
        for (int k = t; k < (blockDim.x >> 5) * 2 * p.nsub * p.nsub;
             k += blockDim.x) {
            s.moments[k] = 0.f;
        }
    }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
    }
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
    }
    return v;
}

// x rounded to an integer by two full-rate adds (rintf is a conversion-pipe
// instruction, an eighth of the rate), for |x| < 2^22; ties go to even.
__device__ __forceinline__ float round_cheap(float x) {
    constexpr float kMagic = 12582912.f;   // 1.5 * 2^23
    return __fadd_rn(__fadd_rn(x, kMagic), -kMagic);
}

// The reduced triclinic box and its cheap minimum image (reciprocal
// multiplies, FMAs, round_cheap), z then y then x as the exact sequence.
struct Box {
    float xx, yx, yy, zx, zy, zz, inv_xx, inv_yy, inv_zz;

    __device__ __forceinline__ explicit Box(const float* box)
        : xx(box[0]), yx(box[3]), yy(box[4]), zx(box[6]), zy(box[7]),
          zz(box[8]), inv_xx(1.f / box[0]), inv_yy(1.f / box[4]),
          inv_zz(1.f / box[8]) {}

    __device__ __forceinline__ bool rectangular() const {
        return yx == 0.f && zx == 0.f && zy == 0.f;
    }

    // A rectangular box: (x, y, z) moved by whole box lengths to the image
    // nearest to `frame`, each coordinate by one rounded multiply-subtract,
    // so that an atom that needs no move keeps its bits.  Returns whether
    // it moved.
    __device__ __forceinline__ bool to_frame(const float* frame, float& x,
                                             float& y, float& z) const {
        const float nx = round_cheap((x - frame[0]) * inv_xx);
        const float ny = round_cheap((y - frame[1]) * inv_yy);
        const float nz = round_cheap((z - frame[2]) * inv_zz);
        x = __fmaf_rn(-nx, xx, x);
        y = __fmaf_rn(-ny, yy, y);
        z = __fmaf_rn(-nz, zz, z);
        return nx != 0.f || ny != 0.f || nz != 0.f;
    }

    __device__ __forceinline__ void image_cheap(float& ax, float& ay,
                                                float& az) const {
        const float nz = round_cheap(az * inv_zz);
        ax -= nz * zx;
        ay -= nz * zy;
        az -= nz * zz;
        const float ny = round_cheap(ay * inv_yy);
        ax -= ny * yx;
        ay -= ny * yy;
        ax -= round_cheap(ax * inv_xx) * xx;
    }
};

// The frame of a block of the cell kernel, whose positions are raw (each
// atom in any periodic image), written by the block's first warp to
// s.frame: a point R in the middle of the home cell's atoms and a flag.
// With the flag set, the block stages every candidate x as the image
// nearest to R (Box::to_frame), and takes every row r of the home cell as
// r' likewise; then r' - x' IS the minimum-image delta of every pair within
// `reach`, and phase 1 needs no image per pair.  The flag is set
// when the box is rectangular and, per axis, the half width rho of the home
// cell's atoms around R (measured here, as images nearest to the cell's
// first real atom) and the reach together stay below 0.499 box lengths: a
// partner within reach of r' then lies within rho + reach < L / 2 of R, so
// it is the one image of its atom that the staging keeps.  (Cells no wider
// than L / 3 and wider than the cutoff meet it; a block whose slot tensors
// do not falls back to the image per pair.)
__device__ __forceinline__ void home_frame(const Shared& s,
                                           const float* __restrict__ pos,
                                           const int* __restrict__ ids, int C,
                                           int n_real, const Box& box,
                                           float reach) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int nc = s.ncell[kHome];
    int first = INT_MAX;
    for (int j = lane; j < C; j += 32) {
        if (ids[nc * C + j] < n_real) first = min(first, j);
    }
    first = __reduce_min_sync(kFullMask, first);
    bool framed = box.rectangular() && first != INT_MAX;
    float mid[3] = {0.f, 0.f, 0.f};
    if (framed) {
        float ref[3], lo[3], hi[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            ref[a] = pos[(nc * 3 + a) * C + first];
            lo[a] = hi[a] = 0.f;
        }
        for (int j = lane; j < C; j += 32) {
            if (ids[nc * C + j] >= n_real) continue;
            float dx = pos[(nc * 3 + 0) * C + j] - ref[0];
            float dy = pos[(nc * 3 + 1) * C + j] - ref[1];
            float dz = pos[(nc * 3 + 2) * C + j] - ref[2];
            box.image_cheap(dx, dy, dz);
            lo[0] = fminf(lo[0], dx);
            lo[1] = fminf(lo[1], dy);
            lo[2] = fminf(lo[2], dz);
            hi[0] = fmaxf(hi[0], dx);
            hi[1] = fmaxf(hi[1], dy);
            hi[2] = fmaxf(hi[2], dz);
        }
        const float lengths[3] = {box.xx, box.yy, box.zz};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            lo[a] = warp_min(lo[a]);
            hi[a] = warp_max(hi[a]);
            mid[a] = ref[a] + 0.5f * (lo[a] + hi[a]);
            framed = framed
                     && 0.5f * (hi[a] - lo[a]) + reach < 0.499f * lengths[a];
        }
    }
    if (lane < 3) s.frame[lane] = lane == 0 ? mid[0] : (lane == 1 ? mid[1] : mid[2]);
    if (lane == 3) s.frame[3] = framed ? 1.f : 0.f;
}

// Stages the real slots (atom index < n_real) of neighbour cells o0 ..
// o0 + ncells - 1 as one compact list, cell by cell in slot order, and
// returns its length; the list is filled up to the next multiple of kStride
// with entries that no test passes (NaN positions, atom index INT_MAX), so
// that a test step needs no bound check.  A warp counts the real slots of
// its cells, then writes them behind those of the cells before.  With SHIFT
// (the column kernel) a cell's periodic shift is added; with `box` given
// (the cell kernel, framed: see home_frame) a position goes in as the image
// nearest to s.frame.  Callers synchronise before and after.
template <bool SHIFT, bool IDS>
__device__ __forceinline__ int stage_tile(const Shared& s,
                                          const float* __restrict__ pos,
                                          const int* __restrict__ ids, int C,
                                          int n_real, int o0, int ncells,
                                          const Box* box = nullptr) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    // a warp takes kSteps * 32 slots of a cell at a time, so that kSteps
    // (then 3 * kSteps) loads are in flight per lane
    for (int c = warp; c < ncells; c += nwarps) {
        const int* cell_ids = ids + s.ncell[o0 + c] * C;
        int n = 0;
        for (int j0 = lane; j0 < C + lane; j0 += kStride) {
            bool real[kSteps];
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                const int j = j0 + 32 * u;
                real[u] = j < C && cell_ids[j] < n_real;
            }
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                n += __popc(__ballot_sync(kFullMask, real[u]));
            }
        }
        if (lane == 0) s.count[c] = n;
    }
    __syncthreads();
    for (int c = warp; c < ncells; c += nwarps) {
        int at = 0;
        for (int before = 0; before < c; ++before) at += s.count[before];
        const int o = o0 + c;
        const int nc = s.ncell[o];
        for (int j0 = lane; j0 < C + lane; j0 += kStride) {
            int id[kSteps];
            float x[kSteps], y[kSteps], z[kSteps];
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                const int j = j0 + 32 * u;
                id[u] = j < C ? ids[nc * C + j] : INT_MAX;
            }
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                const int j = j0 + 32 * u;
                if (id[u] < n_real) {
                    x[u] = pos[(nc * 3 + 0) * C + j];
                    y[u] = pos[(nc * 3 + 1) * C + j];
                    z[u] = pos[(nc * 3 + 2) * C + j];
                }
            }
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
                const int j = j0 + 32 * u;
                const unsigned real = __ballot_sync(kFullMask,
                                                    id[u] < n_real);
                if (id[u] < n_real) {
                    const int k = at + __popc(real & ((1u << lane) - 1u));
                    bool moved = false;
                    if (SHIFT) {
                        x[u] = __fadd_rn(x[u], s.shift[3 * o + 0]);
                        y[u] = __fadd_rn(y[u], s.shift[3 * o + 1]);
                        z[u] = __fadd_rn(z[u], s.shift[3 * o + 2]);
                    } else if (box != nullptr) {
                        moved = box->to_frame(s.frame, x[u], y[u], z[u]);
                    }
                    s.x[k] = x[u];
                    s.y[k] = y[u];
                    s.z[k] = z[u];
                    if (IDS) s.id[k] = id[u];
                    s.where[k] = static_cast<unsigned short>(
                        o << 10 | j | (moved ? kMovedFlag : 0));
                }
                at += __popc(real);
            }
        }
    }
    int total = 0;
    for (int c = 0; c < ncells; ++c) total += s.count[c];
    const int padded = (total + kStride - 1) / kStride * kStride;
    for (int k = total + threadIdx.x; k < padded; k += blockDim.x) {
        s.x[k] = s.y[k] = s.z[k] = __int_as_float(0x7fc00000);
        if (IDS) s.id[k] = INT_MAX;
    }
    return total;
}

// Where a staged candidate lies in the slot tensors: `slot` in those of
// shape (cells, C), `par` (its charge; sigma/2 and 2 sqrt(eps) follow at
// + C and + 2 C) in (cells, 3, C).
struct Partner {
    int slot, par;
};

__device__ __forceinline__ Partner partner_at(const Shared& s, int where,
                                              int C) {
    const int base = s.ncell[(where & (kMovedFlag - 1)) >> 10] * C;
    const int j = where & 1023;
    return Partner{base + j, 3 * base + j};
}

// One row atom, the same in every lane of its warp.
struct Row {
    float x, y, z, q, sig, eps;
    int sub, nex;       // subset; entries of the warp's exclusion list in use
    int ex_min;         // the smallest of them, and how far the largest lies
    unsigned ex_span;   // above it: id is in between iff id - ex_min <= span
};

// Loads row slot t of `cell` and its exclusion list (into `excl`, the
// warp's list in shared memory; nex reaches the last entry that names an
// atom, and a -1 before it matches no candidate).
__device__ __forceinline__ Row load_row(const float* __restrict__ pos,
                                        const float* __restrict__ par,
                                        const int* __restrict__ sub,
                                        const int* __restrict__ excl_g,
                                        int* excl, int cell, int t,
                                        const PairParams& p) {
    const int C = p.capacity;
    const int lane = threadIdx.x & 31;
    Row r;
    r.x = pos[(cell * 3 + 0) * C + t];
    r.y = pos[(cell * 3 + 1) * C + t];
    r.z = pos[(cell * 3 + 2) * C + t];
    r.q = par[(cell * 3 + 0) * C + t] * p.sqrt_ke;
    r.sig = par[(cell * 3 + 1) * C + t];
    r.eps = par[(cell * 3 + 2) * C + t];
    r.sub = sub[cell * C + t];
    const int e = lane < p.emax ? excl_g[(cell * p.emax + lane) * C + t] : -1;
    __syncwarp();        // the previous row's batches have read the list
    if (lane < kMaxExclusions) excl[lane] = e;
    r.nex = 32 - __clz(__ballot_sync(kFullMask, e >= 0));
    const int smallest = __reduce_min_sync(kFullMask, e >= 0 ? e : INT_MAX);
    const int largest = __reduce_max_sync(kFullMask, e);
    // (an empty list: no id has id - INT_MIN == 0)
    r.ex_min = r.nex ? smallest : INT_MIN;
    r.ex_span = r.nex ? unsigned(largest) - unsigned(smallest) : 0u;
    __syncwarp();
    return r;
}

// The warp's queue of hits: a ring in shared memory, pushed in a fixed order
// by ballot and prefix count, popped 32 at a time.  An entry is a staged
// candidate's index (below 27 * 1024 < 2^15; bit 15 is the cell kernel's
// flag).  head and count are the same in every lane.
struct Queue {
    unsigned short* ring;
    int head, count;

    __device__ __forceinline__ void push(bool hit, int entry) {
        const unsigned lane = threadIdx.x & 31;
        const unsigned hits = __ballot_sync(kFullMask, hit);
        if (hit) {
            const int at = head + count + __popc(hits & ((1u << lane) - 1u));
            ring[at & (kQueue - 1)] = static_cast<unsigned short>(entry);
        }
        count += __popc(hits);
    }

    // The entry of this lane among the first n (n <= 32, n <= count); lanes
    // n and above get the first entry and must not use it.
    __device__ __forceinline__ int pop(int n) {
        const int lane = threadIdx.x & 31;
        __syncwarp();    // the pushes are visible
        const int entry = ring[(head + (lane < n ? lane : 0)) & (kQueue - 1)];
        head += n;
        count -= n;
        __syncwarp();    // all have read before the next push writes
        return entry;
    }
};

// Four consecutive staged values, one 16-byte load (k is a multiple of 4).
template <typename T4, typename T>
__device__ __forceinline__ T4 load4(const T* staged, int k) {
    return *reinterpret_cast<const T4*>(staged + k);
}

// ((dx*dx + dy*dy) + dz*dz) with every operation rounded, as the plain twins
// compute it: nvcc would otherwise contract it into FMAs, and pairs at the
// cutoff would fall on the other side of it.
__device__ __forceinline__ float r2_rn(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// A&S 7.1.26 erfc(x) (pallas_direct.py:49-57); *gauss = exp(-x^2)
__device__ __forceinline__ float erfc_hastings(float x, float* gauss) {
    const float tt = 1.f / (1.f + 0.3275911f * x);
    const float poly = tt * (0.254829592f + tt * (-0.284496736f + tt * (1.421413741f
                       + tt * (-1.453152027f + tt * 1.061405429f))));
    *gauss = expf(-x * x);
    return poly * (*gauss);
}

struct PairTerms {
    float dedr_vdw, dedr_coul, e_vdw, e_coul;
};

// LJ (sigma/2 + sigma/2, 2 sqrt(eps) * 2 sqrt(eps)) and Coulomb by reaction
// field or Ewald erfc, with the quintic switch, for one pair within the
// cutoff.  qq carries the Coulomb constant.  Forces are dedr * delta.
__device__ __forceinline__ PairTerms pair_terms(float r2, float qq, float sig,
                                                float eps,
                                                const PairParams& p) {
    const float rinv = rsqrtf(r2);
    const float r = r2 * rinv;
    float sig2 = sig * rinv;
    sig2 *= sig2;
    const float sig6 = sig2 * sig2 * sig2;

    float sw_val = 1.f, sw_der = 0.f;
    if (p.use_switch) {
        const float sw_width = p.cutoff - p.switch_distance;
        const float u = fminf(fmaxf((r - p.switch_distance) / sw_width, 0.f), 1.f);
        sw_val = 1.f + u * u * u * (-10.f + u * (15.f - u * 6.f));
        sw_der = u * u * (-30.f + u * (60.f - u * 30.f)) / sw_width;
    }
    PairTerms out;
    out.dedr_vdw = sw_val * eps * (12.f * sig6 - 6.f) * sig6 * rinv * rinv;
    out.e_vdw = eps * (sig6 - 1.f) * sig6;
    if (p.mode == kModeEwald) {
        const float ar = p.alpha * r;
        float gauss;
        const float erfc_ar = erfc_hastings(ar, &gauss);
        out.e_coul = qq * rinv * erfc_ar;
        out.dedr_coul = qq * rinv * rinv * rinv * (erfc_ar + kTwoOverSqrtPi * ar * gauss);
    } else {
        out.e_coul = qq * (rinv + p.krf * r2 - p.crf);
        out.dedr_coul = qq * (rinv - 2.f * p.krf * r2) * rinv * rinv;
    }
    if (p.use_switch) {
        out.dedr_vdw -= out.e_vdw * sw_der * rinv;
        out.e_vdw *= sw_val;
    }
    return out;
}

// What a lane has summed for its warp's row: the force and, with energies,
// the Coulomb and vdW energies by partner subset.
struct Sums {
    float fx, fy, fz;
    float ec[kMaxSubsets], ev[kMaxSubsets];

    __device__ __forceinline__ void clear() {
        fx = fy = fz = 0.f;
#pragma unroll
        for (int b = 0; b < kMaxSubsets; ++b) ec[b] = ev[b] = 0.f;
    }

    // Adds 1/2 of a pair's energies under partner subset sj (register
    // arrays: the loop is unrolled over the fixed bound).
    __device__ __forceinline__ void add_half(int sj, float e_coul,
                                             float e_vdw) {
#pragma unroll
        for (int b = 0; b < kMaxSubsets; ++b) {
            if (b == sj) {
                ec[b] += 0.5f * e_coul;
                ev[b] += 0.5f * e_vdw;
            }
        }
    }
};

// The 32 lanes' values added in a fixed order; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFullMask, v, off);
    }
    return v;
}

// The end of a row in a tile: the warp's total force goes to row slot t
// (added to what earlier tiles gave it) and, with energies, its moments to
// the warp's panel under home subset si.
template <bool ENERGIES>
__device__ __forceinline__ void finish_row(const Sums& a, int si,
                                           bool first_tile, float* forces,
                                           int cell, int t, int C, int nsub,
                                           float* panel) {
    const int lane = threadIdx.x & 31;
    const float fx = warp_sum(a.fx);
    const float fy = warp_sum(a.fy);
    const float fz = warp_sum(a.fz);
    if (lane < 3) {
        float* out = forces + (cell * 3 + lane) * C + t;
        const float v = lane == 0 ? fx : (lane == 1 ? fy : fz);
        *out = first_tile ? v : *out + v;
    }
    if (ENERGIES) {
#pragma unroll
        for (int b = 0; b < kMaxSubsets; ++b) {
            if (b >= nsub) continue;   // nsub is uniform: no divergence
            const float ec = warp_sum(a.ec[b]);
            const float ev = warp_sum(a.ev[b]);
            if (lane == 0) {
                panel[si * nsub + b] += ec;
                panel[(nsub + si) * nsub + b] += ev;
            }
        }
    }
}

// A pad row takes no part: its force is zero.
__device__ __forceinline__ void zero_row(float* forces, int cell, int t,
                                         int C) {
    const int lane = threadIdx.x & 31;
    if (lane < 3) forces[(cell * 3 + lane) * C + t] = 0.f;
}

// The block's moments (2, nsub, nsub) [Coulomb, vdW] of home subset a and
// partner subset b: its warps' panels summed in order.
__device__ __forceinline__ void store_moments(const Shared& s, int nsub,
                                              float* moments) {
    const int nmom = 2 * nsub * nsub;
    const int nwarps = blockDim.x >> 5;
    __syncthreads();
    for (int k = threadIdx.x; k < nmom; k += blockDim.x) {
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += s.moments[w * nmom + k];
        moments[blockIdx.x * nmom + k] = acc;
    }
}

// Launches `kernel` over n_cells * row_blocks blocks with its dynamic shared
// memory (above 48 KB it has to be asked for).
template <typename Kernel, typename... Args>
inline int launch_rows(Kernel kernel, const LaunchShape& g, int n_cells,
                       cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_cells * g.row_blocks, g.threads, g.shmem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

inline bool shapes_ok(int capacity, int nsub, int emax, int mode) {
    return capacity >= 1 && capacity <= kMaxCapacity && nsub >= 1
           && nsub <= kMaxSubsets && emax >= 0 && emax <= kMaxExclusions
           && (mode == kModeReactionField || mode == kModeEwald);
}

}  // namespace nbs_pair
