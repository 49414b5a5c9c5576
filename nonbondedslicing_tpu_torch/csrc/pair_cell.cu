// Direct-space pair forces and per-slice energy moments over the cell grid,
// with minimum image and the Ewald exclusion corrections fused in.
//
// Replaces nonbondedslicing_tpu/ops/pallas_direct.py::make_pallas_cell_kernel
// (pallas_call at pallas_direct.py:377) as the JAX fused engine builds it
// for PME systems whose exclusions are not rigid-water triangles, or whose
// exceptions are periodic (ops/fused.py:189-241): the pair physics of
// _make_pair_block (pair_common.cuh) with
//
// * minimum image per pair in the reduced triclinic box, z then y then x,
//   each n = floor(d / b_kk + 0.5) (pallas_direct.py:98-111), on the raw
//   slot positions: no periodic shift is staged;
// * a real-slot mask by atom index (< n_real, pallas_direct.py:137-139): the
//   caller's far-away pad offsets would be wrapped back by minimum image;
// * for every excluded pair in the 27-cell neighbourhood, whatever its
//   distance, the Ewald exclusion correction (pallas_direct.py:229-289):
//   -erf(alpha r) k qq / r, its Taylor limit when erf(alpha r) <= 1e-6, on
//   the unwrapped delta unless exceptions are periodic; with LJPME also the
//   back-out of the pair's reciprocal dispersion term
//   (pallas_direct.py:262-286), where that same erf exceeds 1e-6.
//
// What it computes is B1's (pair_column.cu): a FULL shell of 27 neighbour
// cells, row forces only, no atomics, energies weighted 1/2.  Each excluded
// pair is met from both sides too, so its correction goes to the row atom
// only and its energy is weighted 1/2.
//
// What bounds it on an H100: the FP32 instruction rate and, as for B1, the
// latency of a warp's steps.  The exact minimum image (3 divisions, 3
// floors, 6 multiply-subtracts, each rounded as the plain twin rounds it so
// that both take the same cutoff decision) is too dear to pay for 27 * C
// candidates of which ~6.5% are kept.  The design is B1's (pair_common.cuh:
// one warp per row atom, a queue of hits, the physics on 32 hits at a
// time), with these differences:
//
// * phase 2 runs the exact sequence on the positions as given (what was
//   staged, or gathered from the slot tensors if the frame moved the atom)
//   and decides; phase 1 only has to let every pair within the cutoff
//   through.  It does so in one of two ways, chosen per block from its own
//   data (pair_common.cuh, home_frame):
//   - framed: candidates and rows are staged as the images nearest to the
//     middle of the home cell's atoms, where their plain difference is the
//     minimum-image delta of every pair within reach: phase 1 is B1's, a
//     contracted r^2 against a cutoff widened by kWiden;
//   - else (a triclinic box, or a home cell too wide for it): a CHEAP
//     minimum image per candidate (reciprocal multiplies, FMAs, rounding by
//     adding and subtracting 1.5 * 2^23).  No pair within the cutoff is
//     lost: where the cheap and the exact sequence choose the same three
//     image integers, their deltas differ by a few roundings of the raw
//     delta and the box (below 1e-6 of them; kWiden gives 0.5% of the
//     cutoff, enough for raw deltas of some thousand cutoffs; a raw delta
//     of 2^22 box lengths or more, where the rounding by two adds fails,
//     has no meaning in float positions, whose spacing is then half a
//     box); where they choose differently, on the first axis where they do
//     d / b_kk is within rounding of a half integer, so that component of
//     the exact delta is about b_kk / 2 >= 1.5 cutoffs (>= 3 cells of >=
//     one cutoff per axis), and the exact test rejects the pair too;
// * phase 1 also carries the exclusion compare (the pad mask is the
//   staging's: pads are not staged), since an excluded pair is corrected
//   whatever its distance: the row's list is scanned only in a step where
//   one of the warp's 128 candidates lies between the list's smallest and
//   largest entry.  Excluded hits are queued with a flag, and phase 2 runs
//   the correction on them.  The row itself passes phase 1 and is dropped
//   in phase 2.

#include <type_traits>

#include "pair_common.cuh"

namespace {

using namespace nbs_pair;

constexpr float kWiden = 1.01f;     // phase 1 tests r^2 < kWiden * cutoff^2
constexpr int kExcludedFlag = 1 << 15;   // of a queue entry

template <bool ENERGIES, bool LJPME, bool WIDE>
__global__ void __launch_bounds__(32 * kWarps, 2)
pair_cell_kernel(const float* __restrict__ pos,
                 const float* __restrict__ par,
                 const int* __restrict__ sub,
                 const int* __restrict__ ids,
                 const int* __restrict__ excl,
                 const float* __restrict__ lam_c,
                 const float* __restrict__ lam_v,
                 const float* __restrict__ box,
                 float* __restrict__ forces,
                 float* __restrict__ moments, PairParams p,
                 int exceptions_periodic) {
    extern __shared__ __align__(16) float smem[];
    const Shared s = carve(smem, p, true);
    const int C = p.capacity;
    const int nsub = p.nsub;
    // the block's home cell, and its place among the launch's cells, which
    // is its place in `forces` (blockIdx.x is its place in `moments`)
    const int local = blockIdx.x / p.row_blocks;
    const int cell = p.cell_begin + local;
    const int chunk = blockIdx.x - local * p.row_blocks;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int* const my_excl = s.excl + warp * p.emax;
    float* const my_panel = s.moments + warp * 2 * nsub * nsub;

    const Box pbox(box);
    const float bxx = pbox.xx, byx = pbox.yx, byy = pbox.yy;
    const float bzx = pbox.zx, bzy = pbox.zy, bzz = pbox.zz;
    const float cutoff2_wide = kWiden * p.cutoff2;
    const bool fuse_corrections = p.mode == kModeEwald;

    block_tables<ENERGIES>(s, p, cell, lam_c, lam_v, box);
    __syncthreads();
    home_frame(s, pos, ids, C, p.n_real, pbox, sqrtf(kWiden) * p.cutoff);
    __syncthreads();
    const bool framed = s.frame[3] != 0.f;

    for (int o0 = 0; o0 < kNeighbours; o0 += p.tile_cells) {
        __syncthreads();   // previous tile fully consumed
        const int ncand = stage_tile<false, true>(
            s, pos, ids, C, p.n_real, o0, min(p.tile_cells, kNeighbours - o0),
            framed ? &pbox : nullptr);
        __syncthreads();

        for (int t = chunk + p.row_blocks * warp; t < C;
             t += p.row_blocks * nwarps) {
            // pad rows take no part, as pad columns
            if (ids[cell * C + t] >= p.n_real) {
                if (o0 == 0) zero_row(forces, local, t, C);
                continue;
            }
            const Row row =
                load_row<WIDE>(pos, par, sub, excl, my_excl, cell, t, p);
            const int self = kHome << 10 | t;   // the row among the staged
            const float row_c6 = LJPME ? c6_of(row.sig, row.eps) : 0.f;
            // the row as phase 1 sees it: in the block's frame, if any
            float rx = row.x, ry = row.y, rz = row.z;
            if (framed) pbox.to_frame(s.frame, rx, ry, rz);
            Sums acc;
            acc.clear();
            Queue queue{s.queue + warp * kQueue, 0, 0};

            // phase 2: the first n queued entries, one per lane: the exact
            // minimum image of the raw positions, then the correction of an
            // excluded pair or the cutoff test and the pair physics
            auto batch = [&](int n) {
                const int entry = queue.pop(n);
                if (lane >= n) return;
                const bool excluded = (entry & kExcludedFlag) != 0;
                const int k = entry & (kExcludedFlag - 1);
                const int where = s.where[k];
                if ((where & (kMovedFlag - 1)) == self) return;
                const Partner pj = partner_at(s, where, C);
                const int sj = sub[pj.slot];
                const float qq = row.q * (par[pj.par] * p.sqrt_ke);
                const float sgj = par[pj.par + C];
                const float epj = par[pj.par + 2 * C];
                // the partner as given: what was staged, unless the block's
                // frame moved it
                const bool moved = (where & kMovedFlag) != 0;
                const float dx0 = row.x - (moved ? pos[pj.par] : s.x[k]);
                const float dy0 = row.y - (moved ? pos[pj.par + C] : s.y[k]);
                const float dz0 =
                    row.z - (moved ? pos[pj.par + 2 * C] : s.z[k]);
                // minimum image, each product and difference rounded
                const float nz = floorf(__fadd_rn(__fdiv_rn(dz0, bzz), 0.5f));
                float ddx = __fsub_rn(dx0, __fmul_rn(nz, bzx));
                float ddy = __fsub_rn(dy0, __fmul_rn(nz, bzy));
                const float ddz = __fsub_rn(dz0, __fmul_rn(nz, bzz));
                const float ny = floorf(__fadd_rn(__fdiv_rn(ddy, byy), 0.5f));
                ddx = __fsub_rn(ddx, __fmul_rn(ny, byx));
                ddy = __fsub_rn(ddy, __fmul_rn(ny, byy));
                const float nx = floorf(__fadd_rn(__fdiv_rn(ddx, bxx), 0.5f));
                ddx = __fsub_rn(ddx, __fmul_rn(nx, bxx));

                const float lam_cp = s.lam_c[row.sub * nsub + sj];
                if (excluded) {
                    const float ux = exceptions_periodic ? ddx : dx0;
                    const float uy = exceptions_periodic ? ddy : dy0;
                    const float uz = exceptions_periodic ? ddz : dz0;
                    const float r2x = ux * ux + uy * uy + uz * uz;
                    const float rinvx = rsqrtf(r2x);
                    const float arx = p.alpha * (r2x * rinvx);
                    float gauss;
                    const float erf_ar = 1.f - erfc_hastings(arx, &gauss);
                    const bool big = erf_ar > 1e-6f;
                    const float dedr_x = big
                        ? qq * rinvx * rinvx * rinvx
                          * (erf_ar - kTwoOverSqrtPi * arx * gauss)
                        : 0.f;
                    float factor_x = -lam_cp * dedr_x;
                    float e_vx = 0.f;
                    if (LJPME && big) {
                        // the partner's c6 from what was gathered
                        const Dispersion d =
                            dispersion(row_c6 * c6_of(sgj, epj), r2x * rinvx,
                                       rinvx, p.dispersion_alpha);
                        factor_x += s.lam_v[row.sub * nsub + sj] * d.dedr;
                        e_vx = d.e;
                    }
                    acc.fx += factor_x * ux;
                    acc.fy += factor_x * uy;
                    acc.fz += factor_x * uz;
                    if (ENERGIES) {
                        acc.add_half(sj, big ? -qq * rinvx * erf_ar
                                             : -p.alpha * kTwoOverSqrtPi * qq,
                                     e_vx);
                    }
                    return;
                }
                const float r2 = r2_rn(ddx, ddy, ddz);
                if (r2 >= p.cutoff2) return;
                const PairTerms pt = pair_terms<LJPME>(
                    r2, qq, row.sig + sgj, row.eps * epj,
                    LJPME ? row_c6 * c6_of(sgj, epj) : 0.f, p);
                const float factor =
                    s.lam_v[row.sub * nsub + sj] * pt.dedr_vdw
                    + lam_cp * pt.dedr_coul;
                acc.fx += factor * ddx;
                acc.fy += factor * ddy;
                acc.fz += factor * ddz;
                if (ENERGIES) acc.add_half(sj, pt.e_coul, pt.e_vdw);
            };

            // phase 1: kStride candidates tested, four per lane; the hits
            // queued.  FRAMED: the staged positions and (rx, ry, rz) are
            // images nearest to the block's frame, and their difference
            // needs no image.
            auto phase1 = [&](auto framed_c) {
                constexpr bool FRAMED = decltype(framed_c)::value;
                for (int k0 = 0; k0 < ncand; k0 += kStride) {
                    const int kb = k0 + kSteps * lane;
                    const float4 x4 = load4<float4>(s.x, kb);
                    const float4 y4 = load4<float4>(s.y, kb);
                    const float4 z4 = load4<float4>(s.z, kb);
                    const int4 id4 = load4<int4>(s.id, kb);
                    const float xs[kSteps] = {x4.x, x4.y, x4.z, x4.w};
                    const float ys[kSteps] = {y4.x, y4.y, y4.z, y4.w};
                    const float zs[kSteps] = {z4.x, z4.y, z4.z, z4.w};
                    const int idj[kSteps] = {id4.x, id4.y, id4.z, id4.w};
                    bool hit[kSteps];
                    int entry[kSteps];
                    bool listed = false;    // maybe: between two entries
#pragma unroll
                    for (int u = 0; u < kSteps; ++u) {
                        float ax = rx - xs[u];
                        float ay = ry - ys[u];
                        float az = rz - zs[u];
                        if (!FRAMED) pbox.image_cheap(ax, ay, az);
                        hit[u] = ax * ax + ay * ay + az * az < cutoff2_wide;
                        entry[u] = kb + u;
                        listed |= unsigned(idj[u]) - unsigned(row.ex_min)
                                  <= row.ex_span;
                    }
                    if (__any_sync(kFullMask, listed)) {
#pragma unroll
                        for (int u = 0; u < kSteps; ++u) {
                            bool excluded = false;
                            for (int e = 0; e < row.nex; ++e) {
                                excluded |= my_excl[e] == idj[u];
                            }
                            if (excluded) {
                                hit[u] = fuse_corrections;
                                entry[u] |= kExcludedFlag;
                            }
                        }
                    }
#pragma unroll
                    for (int u = 0; u < kSteps; ++u) {
                        queue.push(hit[u], entry[u]);
                    }
                    while (queue.count >= 32) batch(32);
                }
            };
            if (framed) {
                phase1(std::true_type{});
            } else {
                phase1(std::false_type{});
            }
            if (queue.count > 0) batch(queue.count);
            finish_row<ENERGIES>(acc, row.sub, o0 == 0, forces, local, t,
                                 C, nsub, my_panel);
        }
    }
    if (ENERGIES) store_moments(s, nsub, moments);
}

}  // namespace

// The arguments of nbs_pair_column (pair_column.cu), the range of home
// cells [cell_begin, cell_begin + cell_count) included, with pos the raw
// (unshifted) slot positions, plus exceptions_periodic (nonzero: exclusion
// corrections on the minimum-image delta) before the range.  Returns the
// cudaError_t of the launch.
extern "C" int nbs_pair_cell(const void* pos, const void* par,
                             const void* sub, const void* ids,
                             const void* excl, const void* lam_c,
                             const void* lam_v, const void* box,
                             void* forces, void* moments, int ncx, int ncy,
                             int ncz, int capacity, int nsub, int emax,
                             int mode, int use_switch, int n_real,
                             int exceptions_periodic, int cell_begin,
                             int cell_count, int ljpme, float cutoff,
                             float cutoff2, float switch_distance, float krf,
                             float crf, float alpha, float dispersion_alpha,
                             float inv_cut6, float disp_cut, float sqrt_ke,
                             int energies, void* stream) {
    if (!shapes_ok(capacity, nsub, emax, mode, ljpme) || cell_begin < 0
        || cell_count < 1 || cell_begin + cell_count > ncx * ncy * ncz) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const LaunchShape g =
        launch_shape(capacity, nsub, emax, true, energies != 0);
    PairParams p{ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch,
                 n_real, g.row_blocks, g.tile_cells, g.cand_stride,
                 cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke,
                 dispersion_alpha, inv_cut6, disp_cut, cell_begin};
    // [energies][ljpme][a list longer than a warp]
    using Kernel = decltype(&pair_cell_kernel<false, false, false>);
    static const Kernel kernels[8] = {
        pair_cell_kernel<false, false, false>,
        pair_cell_kernel<false, false, true>,
        pair_cell_kernel<false, true, false>,
        pair_cell_kernel<false, true, true>,
        pair_cell_kernel<true, false, false>,
        pair_cell_kernel<true, false, true>,
        pair_cell_kernel<true, true, false>,
        pair_cell_kernel<true, true, true>};
    const Kernel kernel = kernels[4 * (energies != 0) + 2 * (ljpme != 0)
                                  + (emax > kWarpList)];
    return launch_rows(
        kernel, g, cell_count, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(pos), static_cast<const float*>(par),
        static_cast<const int*>(sub), static_cast<const int*>(ids),
        static_cast<const int*>(excl), static_cast<const float*>(lam_c),
        static_cast<const float*>(lam_v), static_cast<const float*>(box),
        static_cast<float*>(forces), static_cast<float*>(moments), p,
        exceptions_periodic);
}
