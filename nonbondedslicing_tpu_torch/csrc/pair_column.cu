// Direct-space pair forces and per-slice energy moments over the cell grid.
//
// Replaces nonbondedslicing_tpu/ops/pallas_direct.py::make_pallas_column_kernel
// (pallas_call at pallas_direct.py:609) with its physics from
// _make_pair_block (pallas_direct.py:64-313, here pair_common.cuh): LJ with
// sigma/2 + sigma/2 and 2 sqrt(eps) * 2 sqrt(eps), Coulomb by reaction field
// or Ewald erfc (the A&S 7.1.26 polynomial of pallas_direct.py:49-57), the
// quintic switch, lambda per pair from the two atoms' subsets, and
// (ENERGIES) unscaled Coulomb / vdW energies summed per (home subset,
// partner subset).
//
// What it computes: a FULL shell of 27 neighbour cells, row forces only.
// The TPU kernel visits each pair once (half shell) and scatters Newton
// reactions through per-column outputs; here every pair is visited from
// both sides, so no thread ever writes another atom's force: no atomics,
// and forces are bitwise repeatable.  Energies carry a 1/2 weight for the
// same reason.  Each neighbour cell is staged with the periodic image shift
// of the cell coordinates added (pallas_direct.py:521-534), so deltas need
// no minimum image.  Pad slots sit > cutoff from everything (the caller's
// padfix), so they can be left out as candidates; pad rows (atom index >=
// n_real) are skipped and get zero force.  The cell grid has
// at least 3 cells per axis, so the 27 neighbours are distinct cells.
//
// What bounds it on an H100: the FP32 instruction rate, and within it the
// test of 27 * C candidates per row atom of which ~6.5% are within the
// cutoff at the benchmark's shapes.  With one thread per row atom a warp
// ran the pair physics (rsqrt, exp, ~60 operations) whenever any of its 32
// rows hit, at ~7% lane use.  The design (pair_common.cuh) is one warp per
// row atom instead: the lanes test 128 candidates between two looks at the
// queue, at full lane use (positions only, 16-byte loads from shared
// memory, a contracted r^2 against a cutoff widened by kWiden), the hits
// are queued in a fixed order, and the physics runs on 32 queued hits at a
// time, every lane alive: there r^2 is rounded as the plain twin rounds it
// and decides, the row itself and the row's emax exclusions are dropped,
// and the partner's parameters, atom index and subset are gathered from
// the slot tensors, which L2 holds.  Blocks are (home cell, a third of its
// rows at the benchmark's 136 slots a cell): 648 blocks of 14 warps, two
// resident per SM.  What is left is latency: a warp's steps are chains of
// shared-memory round trips (load, test, ballot, queue), so the time falls
// with the warps an SM holds and with the rows that share one staging, not
// with the count of tests (skipping the neighbour cells beyond a row's
// reach cut the tests by 40% and the time by nothing).

#include "pair_common.cuh"

namespace {

using namespace nbs_pair;

// Phase 1 tests a contracted r^2 (3 FMAs, within 3 roundings = 2e-7 of the
// rounded one) against kWiden * cutoff^2, so it passes every pair that the
// exact test of phase 2 passes.
constexpr float kWiden = 1.00001f;

template <bool ENERGIES>
__global__ void __launch_bounds__(32 * kWarps, 2)
pair_column_kernel(const float* __restrict__ pos,
                   const float* __restrict__ par,
                   const int* __restrict__ sub,
                   const int* __restrict__ ids,
                   const int* __restrict__ excl,
                   const float* __restrict__ lam_c,
                   const float* __restrict__ lam_v,
                   const float* __restrict__ box,
                   float* __restrict__ forces,
                   float* __restrict__ moments, PairParams p) {
    extern __shared__ __align__(16) float smem[];
    const Shared s = carve(smem, p, false);
    const int C = p.capacity;
    const int nsub = p.nsub;
    const int cell = blockIdx.x / p.row_blocks;
    const int chunk = blockIdx.x - cell * p.row_blocks;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int* const my_excl = s.excl + warp * kMaxExclusions;
    float* const my_panel = s.moments + warp * 2 * nsub * nsub;
    const float cutoff2_wide = kWiden * p.cutoff2;

    block_tables<ENERGIES>(s, p, cell, lam_c, lam_v, box);

    for (int o0 = 0; o0 < kNeighbours; o0 += p.tile_cells) {
        __syncthreads();   // tables written; previous tile fully consumed
        const int ncand = stage_tile<true, false>(
            s, pos, ids, C, p.n_real, o0, min(p.tile_cells, kNeighbours - o0));
        __syncthreads();

        for (int t = chunk + p.row_blocks * warp; t < C;
             t += p.row_blocks * nwarps) {
            if (ids[cell * C + t] >= p.n_real) {
                if (o0 == 0) zero_row(forces, cell, t, C);
                continue;
            }
            const Row row = load_row(pos, par, sub, excl, my_excl, cell, t, p);
            const int self = kHome << 10 | t;   // the row among the staged
            Sums acc;
            acc.clear();
            Queue queue{s.queue + warp * kQueue, 0, 0};

            // phase 2: the physics of the first n queued hits, one per lane
            auto batch = [&](int n) {
                const int k = queue.pop(n);
                if (lane >= n) return;
                const int where = s.where[k];
                const Partner pj = partner_at(s, where, C);
                // all five gathers are issued before any is used
                const int idj = ids[pj.slot];
                const int sj = sub[pj.slot];
                const float qj = par[pj.par];
                const float sgj = par[pj.par + C];
                const float epj = par[pj.par + 2 * C];
                const float ddx = row.x - s.x[k];
                const float ddy = row.y - s.y[k];
                const float ddz = row.z - s.z[k];
                const float r2 = r2_rn(ddx, ddy, ddz);
                // dropped: beyond the cutoff after all, the row itself, an
                // excluded partner
                bool dropped = r2 >= p.cutoff2 || where == self;
                for (int e = 0; e < row.nex; ++e) dropped |= my_excl[e] == idj;
                const PairTerms pt = pair_terms(r2, row.q * (qj * p.sqrt_ke),
                                                row.sig + sgj, row.eps * epj,
                                                p);
                // selected away, not multiplied: its terms need not be
                // finite
                const float factor = dropped ? 0.f
                    : s.lam_v[row.sub * nsub + sj] * pt.dedr_vdw
                      + s.lam_c[row.sub * nsub + sj] * pt.dedr_coul;
                acc.fx += factor * ddx;
                acc.fy += factor * ddy;
                acc.fz += factor * ddz;
                if (ENERGIES) {
                    acc.add_half(sj, dropped ? 0.f : pt.e_coul,
                                 dropped ? 0.f : pt.e_vdw);
                }
            };

            // phase 1: kStride candidates tested, four per lane; the hits
            // queued
            for (int k0 = 0; k0 < ncand; k0 += kStride) {
                const int kb = k0 + kSteps * lane;
                const float4 x4 = load4<float4>(s.x, kb);
                const float4 y4 = load4<float4>(s.y, kb);
                const float4 z4 = load4<float4>(s.z, kb);
                const float xs[kSteps] = {x4.x, x4.y, x4.z, x4.w};
                const float ys[kSteps] = {y4.x, y4.y, y4.z, y4.w};
                const float zs[kSteps] = {z4.x, z4.y, z4.z, z4.w};
                bool hit[kSteps];
#pragma unroll
                for (int u = 0; u < kSteps; ++u) {
                    const float dx = row.x - xs[u];
                    const float dy = row.y - ys[u];
                    const float dz = row.z - zs[u];
                    hit[u] = dx * dx + dy * dy + dz * dz < cutoff2_wide;
                }
#pragma unroll
                for (int u = 0; u < kSteps; ++u) queue.push(hit[u], kb + u);
                while (queue.count >= 32) batch(32);
            }
            if (queue.count > 0) batch(queue.count);
            finish_row<ENERGIES>(acc, row.sub, o0 == 0, forces, cell, t, C,
                                 nsub, my_panel);
        }
    }
    if (ENERGIES) store_moments(s, nsub, moments);
}

}  // namespace

// pos, par: (cells, 3, C) float [x, y, z] and [q, sigma/2, 2 sqrt(eps)];
// sub, ids: (cells, C) int32; excl: (cells, emax, C) int32; lam_c, lam_v:
// (nsub, nsub) float; box: (3, 3) float rows; slots whose atom index is
// n_real or more are pads; cutoff2 is the squared cutoff rounded once to
// float.  Writes forces (cells, 3, C) and, when energies != 0, moments
// (cells * row_blocks, 2, nsub, nsub) with row_blocks from
// nbs_pair_launch_shape.  Returns the cudaError_t of the launch.
extern "C" int nbs_pair_column(const void* pos, const void* par,
                               const void* sub, const void* ids,
                               const void* excl, const void* lam_c,
                               const void* lam_v, const void* box,
                               void* forces, void* moments, int ncx, int ncy,
                               int ncz, int capacity, int nsub, int emax,
                               int mode, int use_switch, int n_real,
                               float cutoff, float cutoff2,
                               float switch_distance, float krf, float crf,
                               float alpha, float sqrt_ke, int energies,
                               void* stream) {
    if (!shapes_ok(capacity, nsub, emax, mode)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const LaunchShape g = launch_shape(capacity, nsub, false, energies != 0);
    PairParams p{ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch,
                 n_real, g.row_blocks, g.tile_cells, g.cand_stride,
                 cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke};
    return launch_rows(
        energies ? pair_column_kernel<true> : pair_column_kernel<false>, g,
        ncx * ncy * ncz, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(pos), static_cast<const float*>(par),
        static_cast<const int*>(sub), static_cast<const int*>(ids),
        static_cast<const int*>(excl), static_cast<const float*>(lam_c),
        static_cast<const float*>(lam_v), static_cast<const float*>(box),
        static_cast<float*>(forces), static_cast<float*>(moments), p);
}

// How a call of nbs_pair_column (cell_kernel == 0) or nbs_pair_cell is cut:
// out[0] blocks per home cell (moments has cells * out[0] panels), out[1]
// threads per block, out[2] neighbour cells staged at a time, out[3] bytes
// of dynamic shared memory per block.
extern "C" int nbs_pair_launch_shape(int capacity, int nsub, int emax,
                                     int cell_kernel, int energies,
                                     void* out) {
    if (!shapes_ok(capacity, nsub, emax, kModeEwald)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const LaunchShape g = launch_shape(capacity, nsub, cell_kernel != 0,
                                       energies != 0);
    int* o = static_cast<int*>(out);
    o[0] = g.row_blocks;
    o[1] = g.threads;
    o[2] = g.tile_cells;
    o[3] = g.shmem;
    return 0;
}
