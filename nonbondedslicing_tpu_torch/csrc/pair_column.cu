// Direct-space pair forces and per-slice energy moments over the cell grid.
//
// Replaces nonbondedslicing_tpu/ops/pallas_direct.py::make_pallas_column_kernel
// (pallas_call at pallas_direct.py:609) with its physics from
// _make_pair_block (pallas_direct.py:64-313): LJ with sigma/2 + sigma/2 and
// 2 sqrt(eps) * 2 sqrt(eps), Coulomb by reaction field or Ewald erfc (the
// A&S 7.1.26 polynomial of pallas_direct.py:49-57), the quintic switch,
// lambda per pair from the two atoms' subsets, and (ENERGIES) unscaled
// Coulomb / vdW energies summed per (home subset, partner subset).
//
// Design: one block per home cell, one thread per home slot, a FULL shell of
// 27 neighbour cells, row forces only.  The TPU kernel visits each pair once
// (half shell) and scatters Newton reactions through per-column outputs;
// here every pair is visited from both sides, so no thread ever writes
// another atom's force: no atomics, and forces are bitwise repeatable.
// Energies carry a 1/2 weight for the same reason.  Each neighbour cell's
// slots are staged in shared memory with the periodic image shift of the
// cell coordinates added (pallas_direct.py:521-534), so deltas need no
// minimum image.  Pad slots sit > cutoff from everything (the caller's
// padfix), so r^2 < cutoff^2 also rejects them.  The cell grid has at
// least 3 cells per axis, so the 27 neighbours are distinct cells.
//
// What bounds it on an H100: the FP32 instruction rate; 27 * C candidates
// per atom, of which ~10% are inside the cutoff (one rsqrt, one exp per
// kept pair).  At the benchmark shapes there are only 216 blocks of 160
// threads for 132 SMs, so the card is underfilled; a half shell with
// fixed-point reactions or several blocks per cell is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSubsets = 8;
constexpr int kMaxExclusions = 16;
constexpr int kModeReactionField = 0;
constexpr int kModeEwald = 1;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

struct PairParams {
    int ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch;
    float cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke;
};

template <bool ENERGIES>
__global__ void pair_column_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ par,
                                   const int* __restrict__ sub,
                                   const int* __restrict__ ids,
                                   const int* __restrict__ excl,
                                   const float* __restrict__ lam_c,
                                   const float* __restrict__ lam_v,
                                   const float* __restrict__ box_g,
                                   float* __restrict__ forces,
                                   float* __restrict__ moments,
                                   PairParams p) {
    extern __shared__ float smem[];
    const int C = p.capacity;
    const int nsub = p.nsub;
    const int nmom = 2 * nsub * nsub;
    float* sx = smem;
    float* sy = sx + C;
    float* sz = sy + C;
    float* sq = sz + C;
    float* ssig = sq + C;
    float* seps = ssig + C;
    int* ssub = reinterpret_cast<int*>(seps + C);
    int* sid = ssub + C;
    float* slc = reinterpret_cast<float*>(sid + C);
    float* slv = slc + nsub * nsub;
    float* swarp = slv + nsub * nsub;   // (warps, 2, nsub, nsub), ENERGIES

    const int cell = blockIdx.x;
    const int cz = cell % p.ncz;
    const int cy = (cell / p.ncz) % p.ncy;
    const int cx = cell / (p.ncy * p.ncz);
    const int t = threadIdx.x;
    const bool active = t < C;

    for (int k = t; k < nsub * nsub; k += blockDim.x) {
        slc[k] = lam_c[k];
        slv[k] = lam_v[k];
    }
    float box[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) box[k] = box_g[k];

    float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, sgi = 0.f, epi = 0.f;
    int si = 0;
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
#pragma unroll
        for (int e = 0; e < kMaxExclusions; ++e) {
            if (e < p.emax) exi[e] = excl[(cell * p.emax + e) * C + t];
        }
    }

    float fx = 0.f, fy = 0.f, fz = 0.f;
    float ec[kMaxSubsets], ev[kMaxSubsets];
#pragma unroll
    for (int b = 0; b < kMaxSubsets; ++b) {
        ec[b] = 0.f;
        ev[b] = 0.f;
    }
    const float sw_width = p.cutoff - p.switch_distance;

    for (int o = 0; o < 27; ++o) {
        const int dx = o / 9 - 1, dy = (o / 3) % 3 - 1, dz = o % 3 - 1;
        int nxc = cx + dx, nyc = cy + dy, nzc = cz + dz;
        const int wx = nxc < 0 ? -1 : (nxc >= p.ncx ? 1 : 0);
        const int wy = nyc < 0 ? -1 : (nyc >= p.ncy ? 1 : 0);
        const int wz = nzc < 0 ? -1 : (nzc >= p.ncz ? 1 : 0);
        nxc -= wx * p.ncx;
        nyc -= wy * p.ncy;
        nzc -= wz * p.ncz;
        // the neighbour cell's true image sits at +w box vectors
        const float shx = wx * box[0] + wy * box[3] + wz * box[6];
        const float shy = wx * box[1] + wy * box[4] + wz * box[7];
        const float shz = wx * box[2] + wy * box[5] + wz * box[8];
        const int nc = (nxc * p.ncy + nyc) * p.ncz + nzc;
        __syncthreads();   // previous cell's panel fully consumed
        for (int k = t; k < C; k += blockDim.x) {
            sx[k] = pos[(nc * 3 + 0) * C + k] + shx;
            sy[k] = pos[(nc * 3 + 1) * C + k] + shy;
            sz[k] = pos[(nc * 3 + 2) * C + k] + shz;
            sq[k] = par[(nc * 3 + 0) * C + k] * p.sqrt_ke;
            ssig[k] = par[(nc * 3 + 1) * C + k];
            seps[k] = par[(nc * 3 + 2) * C + k];
            ssub[k] = sub[nc * C + k];
            sid[k] = ids[nc * C + k];
        }
        __syncthreads();
        if (!active) continue;
        const bool self_cell = (o == 13);
        for (int j = 0; j < C; ++j) {
            if (self_cell && j == t) continue;
            const float ddx = xi - sx[j];
            const float ddy = yi - sy[j];
            const float ddz = zi - sz[j];
            // rounded exactly as the plain twin's ((dx*dx + dy*dy) + dz*dz),
            // without FMA contraction, so both take the same cutoff
            // decision for pairs at the cutoff
            const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                                 __fmul_rn(ddy, ddy)),
                                       __fmul_rn(ddz, ddz));
            if (r2 >= p.cutoff2) continue;
            const int idj = sid[j];
            bool excluded = false;
#pragma unroll
            for (int e = 0; e < kMaxExclusions; ++e) excluded |= (exi[e] == idj);
            if (excluded) continue;

            const float rinv = rsqrtf(r2);
            const float r = r2 * rinv;
            const float qq = qi * sq[j];
            const float sig = sgi + ssig[j];
            const float eps = epi * seps[j];
            float sig2 = sig * rinv;
            sig2 *= sig2;
            const float sig6 = sig2 * sig2 * sig2;

            float sw_val = 1.f, sw_der = 0.f;
            if (p.use_switch) {
                const float u = fminf(fmaxf((r - p.switch_distance) / sw_width, 0.f), 1.f);
                sw_val = 1.f + u * u * u * (-10.f + u * (15.f - u * 6.f));
                sw_der = u * u * (-30.f + u * (60.f - u * 30.f)) / sw_width;
            }
            float dedr_vdw = sw_val * eps * (12.f * sig6 - 6.f) * sig6 * rinv * rinv;
            float e_vdw = eps * (sig6 - 1.f) * sig6;
            float dedr_coul, e_coul;
            if (p.mode == kModeEwald) {
                const float ar = p.alpha * r;
                const float tt = 1.f / (1.f + 0.3275911f * ar);
                const float poly = tt * (0.254829592f + tt * (-0.284496736f + tt * (1.421413741f
                                   + tt * (-1.453152027f + tt * 1.061405429f))));
                const float gauss = expf(-ar * ar);
                const float erfc_ar = poly * gauss;
                e_coul = qq * rinv * erfc_ar;
                dedr_coul = qq * rinv * rinv * rinv * (erfc_ar + kTwoOverSqrtPi * ar * gauss);
            } else {
                e_coul = qq * (rinv + p.krf * r2 - p.crf);
                dedr_coul = qq * (rinv - 2.f * p.krf * r2) * rinv * rinv;
            }
            if (p.use_switch) {
                dedr_vdw -= e_vdw * sw_der * rinv;
                e_vdw *= sw_val;
            }
            const int sj = ssub[j];
            const float factor = slv[si * nsub + sj] * dedr_vdw
                                 + slc[si * nsub + sj] * dedr_coul;
            fx += factor * ddx;
            fy += factor * ddy;
            fz += factor * ddz;
            if (ENERGIES) {
#pragma unroll
                for (int b = 0; b < kMaxSubsets; ++b) {
                    if (b == sj) {
                        ec[b] += 0.5f * e_coul;
                        ev[b] += 0.5f * e_vdw;
                    }
                }
            }
        }
    }

    if (active) {
        forces[(cell * 3 + 0) * C + t] = fx;
        forces[(cell * 3 + 1) * C + t] = fy;
        forces[(cell * 3 + 2) * C + t] = fz;
    }
    if (!ENERGIES) return;

    // per-cell moments (2, nsub, nsub): warp shuffles, then warps in order
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int a = 0; a < nsub; ++a) {
#pragma unroll
        for (int b = 0; b < kMaxSubsets; ++b) {
            if (b >= nsub) continue;   // nsub is uniform: no divergence
            float vc = (active && si == a) ? ec[b] : 0.f;
            float vv = (active && si == a) ? ev[b] : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                vc += __shfl_down_sync(0xffffffffu, vc, off);
                vv += __shfl_down_sync(0xffffffffu, vv, off);
            }
            if (lane == 0) {
                swarp[warp * nmom + a * nsub + b] = vc;
                swarp[warp * nmom + (nsub + a) * nsub + b] = vv;
            }
        }
    }
    __syncthreads();
    for (int k = t; k < nmom; k += blockDim.x) {
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += swarp[w * nmom + k];
        moments[cell * nmom + k] = acc;
    }
}

}  // namespace

// pos, par: (cells, 3, C) float [x, y, z] and [q, sigma/2, 2 sqrt(eps)];
// sub, ids: (cells, C) int32; excl: (cells, emax, C) int32; lam_c, lam_v:
// (nsub, nsub) float; box: (3, 3) float rows; cutoff2 is the squared cutoff
// rounded once to float.  Writes forces (cells, 3, C)
// and, when energies != 0, moments (cells, 2, nsub, nsub).  Returns the
// cudaError_t of the launch.
extern "C" int nbs_pair_column(const void* pos, const void* par,
                               const void* sub, const void* ids,
                               const void* excl, const void* lam_c,
                               const void* lam_v, const void* box,
                               void* forces, void* moments, int ncx, int ncy,
                               int ncz, int capacity, int nsub, int emax,
                               int mode, int use_switch, float cutoff,
                               float cutoff2, float switch_distance,
                               float krf, float crf, float alpha,
                               float sqrt_ke, int energies, void* stream) {
    if (nsub > kMaxSubsets || emax > kMaxExclusions || capacity > 1024
        || (mode != kModeReactionField && mode != kModeEwald)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    PairParams p{ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch,
                 cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke};
    const int threads = ((capacity + 31) / 32) * 32;
    const int nmom = 2 * nsub * nsub;
    const size_t shmem = sizeof(float) * (8 * capacity + 2 * nsub * nsub
                                          + (threads / 32) * nmom);
    const dim3 grid(ncx * ncy * ncz);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (energies) {
        pair_column_kernel<true><<<grid, threads, shmem, st>>>(
            static_cast<const float*>(pos), static_cast<const float*>(par),
            static_cast<const int*>(sub), static_cast<const int*>(ids),
            static_cast<const int*>(excl), static_cast<const float*>(lam_c),
            static_cast<const float*>(lam_v), static_cast<const float*>(box),
            static_cast<float*>(forces), static_cast<float*>(moments), p);
    } else {
        pair_column_kernel<false><<<grid, threads, shmem, st>>>(
            static_cast<const float*>(pos), static_cast<const float*>(par),
            static_cast<const int*>(sub), static_cast<const int*>(ids),
            static_cast<const int*>(excl), static_cast<const float*>(lam_c),
            static_cast<const float*>(lam_v), static_cast<const float*>(box),
            static_cast<float*>(forces), static_cast<float*>(moments), p);
    }
    return static_cast<int>(cudaGetLastError());
}
