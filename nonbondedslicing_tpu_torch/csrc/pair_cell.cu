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
//   the unwrapped delta unless exceptions are periodic.
//
// Design: B1's (pair_column.cu): one block per home cell, one thread per home
// slot, a FULL shell of 27 neighbour cells staged in shared memory, row
// forces only, no atomics, energies weighted 1/2.  Each excluded pair is
// met from both sides too, so its correction goes to the row atom only and
// its energy is weighted 1/2.  The minimum-image subtractions and r^2 are
// rounded without FMA contraction, exactly as the plain twin computes them,
// so both take the same cutoff decision.  Each row's exclusion scan stops at
// its first -1 (the plan fills the lists from the front): water rows hold 2
// entries of the solute's emax 6.
//
// What bounds it on an H100: the FP32 instruction rate.  Every one of the
// 27 * C candidates of an atom pays the minimum image (3 divisions, 3
// floors, 6 multiply-subtracts) and the exclusion scan before the cutoff
// test, which B1 does not; ~10% of them are inside the cutoff (one rsqrt,
// one exp per kept pair).  216 blocks for 132 SMs underfill the card, as
// for B1.

#include "pair_common.cuh"

namespace {

using namespace nbs_pair;

template <bool ENERGIES>
__global__ void pair_cell_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ par,
                                 const int* __restrict__ sub,
                                 const int* __restrict__ ids,
                                 const int* __restrict__ excl,
                                 const float* __restrict__ lam_c,
                                 const float* __restrict__ lam_v,
                                 const float* __restrict__ box_g,
                                 float* __restrict__ forces,
                                 float* __restrict__ moments,
                                 PairParams p, int n_real,
                                 int exceptions_periodic) {
    extern __shared__ float smem[];
    const int C = p.capacity;
    const int nsub = p.nsub;
    const Panel s = carve_panel(smem, C, nsub);

    const int cell = blockIdx.x;
    const int cz = cell % p.ncz;
    const int cy = (cell / p.ncz) % p.ncy;
    const int cx = cell / (p.ncy * p.ncz);
    const int t = threadIdx.x;

    for (int k = t; k < nsub * nsub; k += blockDim.x) {
        s.lam_c[k] = lam_c[k];
        s.lam_v[k] = lam_v[k];
    }
    const float bxx = box_g[0];
    const float byx = box_g[3], byy = box_g[4];
    const float bzx = box_g[6], bzy = box_g[7], bzz = box_g[8];

    // pad rows (index n_real) take no part, as pad columns
    const bool active = t < C && ids[cell * C + t] < n_real;
    float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, sgi = 0.f, epi = 0.f;
    int si = 0;
    int nex = 0;
    int exi[kMaxExclusions];
#pragma unroll
    for (int e = 0; e < kMaxExclusions; ++e) exi[e] = -1;
    if (active) {
        xi = pos[(cell * 3 + 0) * C + t];
        yi = pos[(cell * 3 + 1) * C + t];
        zi = pos[(cell * 3 + 2) * C + t];
        qi = par[(cell * 3 + 0) * C + t] * p.sqrt_ke;
        sgi = par[(cell * 3 + 1) * C + t];
        epi = par[(cell * 3 + 2) * C + t];
        si = sub[cell * C + t];
        bool open = true;
#pragma unroll
        for (int e = 0; e < kMaxExclusions; ++e) {
            if (e < p.emax && open) {
                exi[e] = excl[(cell * p.emax + e) * C + t];
                open = exi[e] >= 0;
                nex += open ? 1 : 0;
            }
        }
    }

    float fx = 0.f, fy = 0.f, fz = 0.f;
    float ec[kMaxSubsets], ev[kMaxSubsets];
#pragma unroll
    for (int b = 0; b < kMaxSubsets; ++b) {
        ec[b] = 0.f;
        ev[b] = 0.f;
    }
    const bool fuse_corrections = p.mode == kModeEwald;

    for (int o = 0; o < 27; ++o) {
        int nxc = cx + o / 9 - 1, nyc = cy + (o / 3) % 3 - 1, nzc = cz + o % 3 - 1;
        nxc += nxc < 0 ? p.ncx : (nxc >= p.ncx ? -p.ncx : 0);
        nyc += nyc < 0 ? p.ncy : (nyc >= p.ncy ? -p.ncy : 0);
        nzc += nzc < 0 ? p.ncz : (nzc >= p.ncz ? -p.ncz : 0);
        const int nc = (nxc * p.ncy + nyc) * p.ncz + nzc;
        __syncthreads();   // previous cell's panel fully consumed
        for (int k = t; k < C; k += blockDim.x) {
            s.x[k] = pos[(nc * 3 + 0) * C + k];
            s.y[k] = pos[(nc * 3 + 1) * C + k];
            s.z[k] = pos[(nc * 3 + 2) * C + k];
            s.q[k] = par[(nc * 3 + 0) * C + k] * p.sqrt_ke;
            s.sig[k] = par[(nc * 3 + 1) * C + k];
            s.eps[k] = par[(nc * 3 + 2) * C + k];
            s.sub[k] = sub[nc * C + k];
            s.id[k] = ids[nc * C + k];
        }
        __syncthreads();
        if (!active) continue;
        const bool self_cell = (o == 13);
        for (int j = 0; j < C; ++j) {
            if (self_cell && j == t) continue;
            const int idj = s.id[j];
            if (idj >= n_real) continue;
            const float dx0 = xi - s.x[j];
            const float dy0 = yi - s.y[j];
            const float dz0 = zi - s.z[j];
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

            bool excluded = false;
#pragma unroll
            for (int e = 0; e < kMaxExclusions; ++e) {
                if (e >= nex) break;
                excluded |= (exi[e] == idj);
            }
            const int sj = s.sub[j];
            if (excluded) {
                if (!fuse_corrections) continue;
                const float ux = exceptions_periodic ? ddx : dx0;
                const float uy = exceptions_periodic ? ddy : dy0;
                const float uz = exceptions_periodic ? ddz : dz0;
                const float r2x = ux * ux + uy * uy + uz * uz;
                const float rinvx = rsqrtf(r2x);
                const float rx = r2x * rinvx;
                const float arx = p.alpha * rx;
                float gauss;
                const float erf_ar = 1.f - erfc_hastings(arx, &gauss);
                const bool big = erf_ar > 1e-6f;
                const float qq = qi * s.q[j];
                const float dedr_x = big
                    ? qq * rinvx * rinvx * rinvx * (erf_ar - kTwoOverSqrtPi * arx * gauss)
                    : 0.f;
                const float factor_x = -s.lam_c[si * nsub + sj] * dedr_x;
                fx += factor_x * ux;
                fy += factor_x * uy;
                fz += factor_x * uz;
                if (ENERGIES) {
                    const float e_cx = big ? -qq * rinvx * erf_ar
                                           : -p.alpha * kTwoOverSqrtPi * qq;
                    add_half(ec, ev, sj, e_cx, 0.f);
                }
                continue;
            }
            const float r2 = r2_rn(ddx, ddy, ddz);
            if (r2 >= p.cutoff2) continue;

            const PairTerms pt = pair_terms(r2, qi * s.q[j], sgi + s.sig[j],
                                            epi * s.eps[j], p);
            const float factor = s.lam_v[si * nsub + sj] * pt.dedr_vdw
                                 + s.lam_c[si * nsub + sj] * pt.dedr_coul;
            fx += factor * ddx;
            fy += factor * ddy;
            fz += factor * ddz;
            if (ENERGIES) add_half(ec, ev, sj, pt.e_coul, pt.e_vdw);
        }
    }

    if (t < C) {
        forces[(cell * 3 + 0) * C + t] = fx;
        forces[(cell * 3 + 1) * C + t] = fy;
        forces[(cell * 3 + 2) * C + t] = fz;
    }
    if (ENERGIES) store_moments(ec, ev, active, si, s, nsub, moments, cell);
}

}  // namespace

// The arguments of nbs_pair_column (pair_column.cu), with pos the raw
// (unshifted) slot positions, plus n_real (slots whose atom index is
// n_real or more are pads) and exceptions_periodic (nonzero: exclusion
// corrections on the minimum-image delta).  Returns the cudaError_t of the
// launch.
extern "C" int nbs_pair_cell(const void* pos, const void* par,
                             const void* sub, const void* ids,
                             const void* excl, const void* lam_c,
                             const void* lam_v, const void* box,
                             void* forces, void* moments, int ncx, int ncy,
                             int ncz, int capacity, int nsub, int emax,
                             int mode, int use_switch, int n_real,
                             int exceptions_periodic, float cutoff,
                             float cutoff2, float switch_distance, float krf,
                             float crf, float alpha, float sqrt_ke,
                             int energies, void* stream) {
    if (nsub > kMaxSubsets || emax > kMaxExclusions || capacity > 1024
        || (mode != kModeReactionField && mode != kModeEwald)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    PairParams p{ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch,
                 cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke};
    const int threads = ((capacity + 31) / 32) * 32;
    const size_t shmem = panel_bytes(capacity, nsub, threads);
    const dim3 grid(ncx * ncy * ncz);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto kernel = energies ? pair_cell_kernel<true> : pair_cell_kernel<false>;
    kernel<<<grid, threads, shmem, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(par),
        static_cast<const int*>(sub), static_cast<const int*>(ids),
        static_cast<const int*>(excl), static_cast<const float*>(lam_c),
        static_cast<const float*>(lam_v), static_cast<const float*>(box),
        static_cast<float*>(forces), static_cast<float*>(moments), p, n_real,
        exceptions_periodic);
    return static_cast<int>(cudaGetLastError());
}
