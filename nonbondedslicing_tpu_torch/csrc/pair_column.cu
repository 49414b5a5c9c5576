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

#include "pair_common.cuh"

namespace {

using namespace nbs_pair;

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
    const Panel s = carve_panel(smem, C, nsub);

    const int cell = blockIdx.x;
    const int cz = cell % p.ncz;
    const int cy = (cell / p.ncz) % p.ncy;
    const int cx = cell / (p.ncy * p.ncz);
    const int t = threadIdx.x;
    const bool active = t < C;

    for (int k = t; k < nsub * nsub; k += blockDim.x) {
        s.lam_c[k] = lam_c[k];
        s.lam_v[k] = lam_v[k];
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
            s.x[k] = pos[(nc * 3 + 0) * C + k] + shx;
            s.y[k] = pos[(nc * 3 + 1) * C + k] + shy;
            s.z[k] = pos[(nc * 3 + 2) * C + k] + shz;
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
            const float ddx = xi - s.x[j];
            const float ddy = yi - s.y[j];
            const float ddz = zi - s.z[j];
            const float r2 = r2_rn(ddx, ddy, ddz);
            if (r2 >= p.cutoff2) continue;
            const int idj = s.id[j];
            bool excluded = false;
#pragma unroll
            for (int e = 0; e < kMaxExclusions; ++e) excluded |= (exi[e] == idj);
            if (excluded) continue;

            const PairTerms pt = pair_terms(r2, qi * s.q[j], sgi + s.sig[j],
                                            epi * s.eps[j], p);
            const int sj = s.sub[j];
            const float factor = s.lam_v[si * nsub + sj] * pt.dedr_vdw
                                 + s.lam_c[si * nsub + sj] * pt.dedr_coul;
            fx += factor * ddx;
            fy += factor * ddy;
            fz += factor * ddz;
            if (ENERGIES) add_half(ec, ev, sj, pt.e_coul, pt.e_vdw);
        }
    }

    if (active) {
        forces[(cell * 3 + 0) * C + t] = fx;
        forces[(cell * 3 + 1) * C + t] = fy;
        forces[(cell * 3 + 2) * C + t] = fz;
    }
    if (ENERGIES) store_moments(ec, ev, active, si, s, nsub, moments, cell);
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
    const size_t shmem = panel_bytes(capacity, nsub, threads);
    const dim3 grid(ncx * ncy * ncz);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto kernel = energies ? pair_column_kernel<true> : pair_column_kernel<false>;
    kernel<<<grid, threads, shmem, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(par),
        static_cast<const int*>(sub), static_cast<const int*>(ids),
        static_cast<const int*>(excl), static_cast<const float*>(lam_c),
        static_cast<const float*>(lam_v), static_cast<const float*>(box),
        static_cast<float*>(forces), static_cast<float*>(moments), p);
    return static_cast<int>(cudaGetLastError());
}
