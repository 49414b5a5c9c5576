// Pair physics shared by the two direct-space kernels, pair_column.cu (B1)
// and pair_cell.cu (B4): the physics of _make_pair_block
// (nonbondedslicing_tpu/ops/pallas_direct.py:64-313) for one pair, and the
// per-cell reduction of the energy moments.

#pragma once

#include <cuda_runtime.h>

namespace nbs_pair {

constexpr int kMaxSubsets = 8;
constexpr int kMaxExclusions = 16;
constexpr int kModeReactionField = 0;
constexpr int kModeEwald = 1;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

struct PairParams {
    int ncx, ncy, ncz, capacity, nsub, emax, mode, use_switch;
    float cutoff, cutoff2, switch_distance, krf, crf, alpha, sqrt_ke;
};

// Shared memory of one block: a staged neighbour cell (x, y, z, q, sigma/2,
// 2 sqrt(eps), subset, atom index), the lambda matrices and, with energies,
// one (2, nsub, nsub) moment panel per warp.
struct Panel {
    float *x, *y, *z, *q, *sig, *eps;
    int *sub, *id;
    float *lam_c, *lam_v;
    float* warp_moments;
};

__device__ __forceinline__ Panel carve_panel(float* smem, int C, int nsub) {
    Panel s;
    s.x = smem;
    s.y = s.x + C;
    s.z = s.y + C;
    s.q = s.z + C;
    s.sig = s.q + C;
    s.eps = s.sig + C;
    s.sub = reinterpret_cast<int*>(s.eps + C);
    s.id = s.sub + C;
    s.lam_c = reinterpret_cast<float*>(s.id + C);
    s.lam_v = s.lam_c + nsub * nsub;
    s.warp_moments = s.lam_v + nsub * nsub;
    return s;
}

__host__ __device__ inline size_t panel_bytes(int C, int nsub, int threads) {
    return sizeof(float) * (8 * C + 2 * nsub * nsub
                            + (threads / 32) * 2 * nsub * nsub);
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

// Adds 1/2 of a pair's energies to the accumulators of partner subset sj
// (register arrays: the loop is unrolled over the fixed bound).
__device__ __forceinline__ void add_half(float (&ec)[kMaxSubsets],
                                         float (&ev)[kMaxSubsets], int sj,
                                         float e_coul, float e_vdw) {
#pragma unroll
    for (int b = 0; b < kMaxSubsets; ++b) {
        if (b == sj) {
            ec[b] += 0.5f * e_coul;
            ev[b] += 0.5f * e_vdw;
        }
    }
}

// The block's moments (2, nsub, nsub) [Coulomb, vdW] of home subset a and
// partner subset b: warp shuffles, then the warps summed in order, so the
// result does not depend on scheduling.
__device__ __forceinline__ void store_moments(const float (&ec)[kMaxSubsets],
                                              const float (&ev)[kMaxSubsets],
                                              bool active, int si,
                                              const Panel& s, int nsub,
                                              float* moments, int cell) {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const int nmom = 2 * nsub * nsub;
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
                s.warp_moments[warp * nmom + a * nsub + b] = vc;
                s.warp_moments[warp * nmom + (nsub + a) * nsub + b] = vv;
            }
        }
    }
    __syncthreads();
    for (int k = t; k < nmom; k += blockDim.x) {
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += s.warp_moments[w * nmom + k];
        moments[cell * nmom + k] = acc;
    }
}

}  // namespace nbs_pair
