// The rigid-water tail of a force-only MD step, one thread per molecule:
// from the slot forces to the next positions and velocities.
//
// Replaces no Pallas kernel.  The JAX package runs this stage as jnp code
// inside its jitted step (the slot->atom unsort of ops/fused.py, the
// water-triangle exclusion rows of ops/bonded.py and the SETTLE / RATTLE
// solver of runtime/constraints.py); the port ran it as ~335 PyTorch
// kernels a step (runtime/water_tail.py's plain twin, which CUDA graphs
// replayed as ~335 nodes), every one of them over the 3 x 3 coordinates of
// each water and independent of every other water.  For molecule m (atoms
// 3m, 3m+1, 3m+2) the thread
//
//   1. gathers each atom's force from the cell-major slot forces (n_cells,
//      3, C) through its slot (inv_slots);
//   2. adds the Ewald exclusion corrections of the pairs 0-1, 0-2, 1-2
//      (force only): -erf(alpha r) k qq / r differentiated, zero where
//      erf(alpha r) <= 1e-6, scaled by the pair's slice lambda_Coulomb;
//   3. kicks, v += dt F / m, and drifts, x1 = x0 + dt v;
//   4. projects x1 onto the rigid triangle by SETTLE's closed form
//      (Miyamoto & Kollman 1992) in the frame of the old triangle;
//   5. takes the velocity (x_new - x0) / dt and removes its components
//      along the three constraints by RATTLE's 3x3 solve.
//
// Every operation is the twin's, in the twin's order and each rounded on
// its own (__f*_rn: nothing is contracted into an FMA, as the twin's
// separate kernels round each operation), with the same erff, expf,
// sqrt and rsqrtf; a division by a scalar is a multiplication by its
// reciprocal, as PyTorch's CUDA division by a Python number is.  No
// atomics and no reductions across threads: bitwise repeatable.
//
// Why step 2 stays.  Each exclusion row is a central force between two
// atoms of one rigid water, along the old bond vector, so in exact
// arithmetic SETTLE's correction (in the span of M^-1 (x0_i - x0_j)) takes
// it out again and the new state does not depend on it (in float64 at
// the benchmark state on an H100: 1.4e-14 nm).  In float32 it does: the
// kick moves x1 by up to ~0.004 nm along the bonds, and that changes how
// x1 and SETTLE round.  Without the rows the float32 step there lands
// 8.1e-6 nm and 4.0e-3 nm/ps from the step with them, twice the bound
// the kernel is held to against its twin (TOL_TAIL_POS and TOL_TAIL_VEL
// of chip_smoke.py), though no further from float64 (5.4e-6 nm against
// the twin's 5.6e-6).  The twin is the path every other plan runs, so
// the kernel keeps the rows.
//
// What bounds it on an H100: the launch.  Per molecule it reads 236
// bytes (positions 36, velocities 36, three gathered slot forces 36,
// slots 24, charges 12, pair slices 24, inverse masses 12, 14 SETTLE
// constants 56) and writes 72, 308 B: 2.39 MB at the benchmark's 7,763
// waters, 0.71 us at 3.35 TB/s, and at most ~640 float operations, a few
// ns of the card (chip_smoke.py's TAIL_BYTES and TAIL_OPS).  So the
// design is one launch where there were ~335: blocks of 128 molecules (61 blocks, under
// one wave of the 132 SMs); each block stages its 384 atoms' positions and
// velocities in shared memory in and out, so that those loads and stores
// are coalesced, and reads the rest as it goes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // molecules a block

// a float whose every operation is rounded on its own
struct R {
    float v;
};
__device__ __forceinline__ R operator+(R a, R b) { return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ R operator-(R a, R b) { return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ R operator*(R a, R b) { return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ R operator/(R a, R b) { return {__fdiv_rn(a.v, b.v)}; }
__device__ __forceinline__ R operator-(R a) { return {-a.v}; }
__device__ __forceinline__ R sqrt_rn(R a) { return {__fsqrt_rn(a.v)}; }
// torch.clamp(x, min=0): a NaN stays NaN
__device__ __forceinline__ R clamp0(R a) { return {a.v < 0.0f ? 0.0f : a.v}; }

struct V {
    R x, y, z;
};
__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V operator*(V a, R s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V operator*(R s, V a) { return {s * a.x, s * a.y, s * a.z}; }
// torch.sum(u * v, dim=-1): the products, then added left to right
__device__ __forceinline__ R dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V cross(V a, V b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V load3(const float* p) { return {{p[0]}, {p[1]}, {p[2]}}; }
__device__ __forceinline__ void store3(float* p, V a) {
    p[0] = a.x.v;
    p[1] = a.y.v;
    p[2] = a.z.v;
}

struct TailParams {
    int n_mol, capacity;
    float alpha;         // Ewald alpha
    float coulomb;       // ONE_4PI_EPS0
    float inv_sqrt_pi;   // 1 / sqrt(pi), rounded as 1.0f / float(sqrt(pi))
    float dt, inv_dt;    // dt and 1.0f / dt
};

// one row of the exclusion corrections: the force on the pair's first atom
// (-it on the second), f = -(lambda_c dE/dr / r) dr
__device__ __forceinline__ V exclusion_row(V dr, R qi, R qj, R lam_c,
                                           const TailParams& p) {
    const R zero{0.0f}, one{1.0f};
    const R r2 = dot(dr, dr);
    const R r = r2.v > 0.0f ? sqrt_rn(r2) : zero;
    const R ar = R{p.alpha} * r;
    const R erf_ar{erff(ar.v)};
    const bool big = erf_ar.v > 1e-6f;
    const R rinv = one / (big ? r : one);
    const R qq = qi * qj;
    const R gauss{expf((-ar * ar).v)};
    const R dedr = R{p.coulomb} * qq * (rinv * rinv * rinv)
                   * (erf_ar - R{2.0f} * ar * gauss * R{p.inv_sqrt_pi});
    return (-(lam_c * (big ? dedr : zero))) * dr;
}

__global__ void __launch_bounds__(kThreads)
water_tail_kernel(const float* __restrict__ slot_f,
                  const long long* __restrict__ inv_slots,
                  const float* __restrict__ pos, const float* __restrict__ vel,
                  const float* __restrict__ charge,
                  const long long* __restrict__ pair_slices,
                  const float* __restrict__ lam,
                  const float* __restrict__ inv_mass,
                  const float* __restrict__ settle,
                  float* __restrict__ pos_out, float* __restrict__ vel_out,
                  TailParams p) {
    __shared__ float s_pos[9 * kThreads];
    __shared__ float s_vel[9 * kThreads];
    const int first = blockIdx.x * kThreads;
    const int here = min(kThreads, p.n_mol - first);
    const long long base = 9LL * first;
    for (int i = threadIdx.x; i < 9 * here; i += kThreads) {
        s_pos[i] = pos[base + i];
        s_vel[i] = vel[base + i];
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < here) {
        const long long m = first + threadIdx.x;
        float* const my_pos = s_pos + 9 * threadIdx.x;
        float* const my_vel = s_vel + 9 * threadIdx.x;
        const int C = p.capacity;
        V x0[3], v[3], f[3];
        R q[3], inv_m[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            x0[a] = load3(my_pos + 3 * a);
            v[a] = load3(my_vel + 3 * a);
            q[a] = R{charge[3 * m + a]};
            inv_m[a] = R{inv_mass[3 * m + a]};
            // 1. the unsort: slot s = cell * C + c holds (cell, :, c)
            const long long s = inv_slots[3 * m + a];
            const long long cell = s / C;
            const float* fs = slot_f + cell * 3 * C + (s - cell * C);
            f[a] = V{{fs[0]}, {fs[C]}, {fs[2 * C]}};
        }
        // 2. the exclusion rows: pairs (0, 1), (0, 2), (1, 2)
        V row[3];
        const int li[3] = {0, 0, 1}, lj[3] = {1, 2, 2};
#pragma unroll
        for (int k = 0; k < 3; ++k)
            row[k] = exclusion_row(x0[li[k]] - x0[lj[k]], q[li[k]], q[lj[k]],
                                   R{lam[2 * pair_slices[3 * m + k]]}, p);
        f[0] = f[0] + (row[0] + row[1]);
        f[1] = f[1] + (-row[0] + row[2]);
        f[2] = f[2] + (-row[1] - row[2]);
        // 3. kick and drift
        const R dt{p.dt};
        V x1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            v[a] = v[a] + (dt * f[a]) * inv_m[a];
            x1[a] = x0[a] + dt * v[a];
        }
        // 4. SETTLE: ra, rb, rc, wa, wb of the canonical triangle
        const float* c = settle + 14 * m;
        const R ra{c[0]}, rb{c[1]}, rc{c[2]}, wa{c[3]}, wb{c[4]};
        const V com = x1[0] * wa + (x1[1] + x1[2]) * wb;
        const V a1 = x1[0] - com, b1 = x1[1] - com, c1 = x1[2] - com;
        const V b0a = x0[1] - x0[0], c0a = x0[2] - x0[0];
        // primed frame: Z' normal to the old triangle, X' = a1 x Z',
        // Y' = Z' x X'
        V ez = cross(b0a, c0a);
        ez = ez * R{rsqrtf(dot(ez, ez).v)};
        V ex = cross(a1, ez);
        ex = ex * R{rsqrtf(dot(ex, ex).v)};
        const V ey = cross(ez, ex);
        const R xb0 = dot(ex, b0a), yb0 = dot(ey, b0a);
        const R xc0 = dot(ex, c0a), yc0 = dot(ey, c0a);
        const R za1 = dot(ez, a1);
        const R xb1 = dot(ex, b1), yb1 = dot(ey, b1), zb1 = dot(ez, b1);
        const R xc1 = dot(ex, c1), yc1 = dot(ey, c1), zc1 = dot(ez, c1);
        const R one{1.0f};
        const R sinphi = za1 / ra;
        const R cosphi = sqrt_rn(clamp0(one - sinphi * sinphi));
        const R sinpsi = (zb1 - zc1) / (R{2.0f} * rc * cosphi);
        const R cospsi = sqrt_rn(clamp0(one - sinpsi * sinpsi));
        const R ya2 = ra * cosphi;
        const R xb2 = -rc * cospsi;
        const R yb2 = -rb * cosphi - rc * sinpsi * sinphi;
        const R yc2 = -rb * cosphi + rc * sinpsi * sinphi;
        const R al = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2;
        const R be = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2;
        const R ga = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0;
        const R a2b2 = al * al + be * be;
        const R sinth = (al * ga - be * sqrt_rn(clamp0(a2b2 - ga * ga))) / a2b2;
        const R costh = sqrt_rn(clamp0(one - sinth * sinth));
        const R xa3 = -ya2 * sinth, ya3 = ya2 * costh, za3 = ra * sinphi;
        const R xb3 = xb2 * costh - yb2 * sinth;
        const R yb3 = xb2 * sinth + yb2 * costh;
        const R zb3 = -rb * sinphi + rc * sinpsi * cosphi;
        const R xc3 = -xb2 * costh - yc2 * sinth;
        const R yc3 = -xb2 * sinth + yc2 * costh;
        const R zc3 = -rb * sinphi - rc * sinpsi * cosphi;
        V x[3];
        x[0] = ex * xa3 + ey * ya3 + ez * za3 + com;
        x[1] = ex * xb3 + ey * yb3 + ez * zb3 + com;
        x[2] = ex * xc3 + ey * yc3 + ez * zc3 + com;
        // 5. the velocity of the constrained step, then RATTLE with the
        // coupling S[k][l] of constraints k and l
        const R inv_dt{p.inv_dt};
        V u[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) u[a] = (x[a] - x0[a]) * inv_dt;
        const V rn[3] = {x[0] - x[1], x[0] - x[2], x[1] - x[2]};
        const V vrel[3] = {u[0] - u[1], u[0] - u[2], u[1] - u[2]};
        R b[3], J[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            b[k] = dot(rn[k], vrel[k]);
#pragma unroll
            for (int l = 0; l < 3; ++l) J[k][l] = R{c[5 + 3 * k + l]} * dot(rn[k], rn[l]);
        }
        const R c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const R c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
        const R c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
        const R c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
        const R c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
        const R c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
        const R c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
        const R c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
        const R c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
        const R inv_det = one / (J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02);
        const R l0 = (c00 * b[0] + c01 * b[1] + c02 * b[2]) * inv_det;
        const R l1 = (c10 * b[0] + c11 * b[1] + c12 * b[2]) * inv_det;
        const R l2 = (c20 * b[0] + c21 * b[1] + c22 * b[2]) * inv_det;
        const V t0 = l0 * rn[0], t1 = l1 * rn[1], t2 = l2 * rn[2];
        u[0] = u[0] - (t0 + t1) * inv_m[0];
        u[1] = u[1] - (-t0 + t2) * inv_m[1];
        u[2] = u[2] - (-t1 - t2) * inv_m[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            store3(my_pos + 3 * a, x[a]);
            store3(my_vel + 3 * a, u[a]);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 9 * here; i += kThreads) {
        pos_out[base + i] = s_pos[i];
        vel_out[base + i] = s_vel[i];
    }
}

}  // namespace

// slot_f: (n_cells, 3, capacity) float slot forces; inv_slots: (3 n_mol,)
// int64 slot of each atom; pos, vel: (3 n_mol, 3) float; charge: (3 n_mol,)
// float; pair_slices: (n_mol, 3) int64 slice ids of the pairs 0-1, 0-2,
// 1-2; lam: (slices, 2) float slice lambdas [Coulomb, vdW]; inv_mass:
// (3 n_mol,) float; settle: (n_mol, 14) float ra, rb, rc, wa, wb and the
// RATTLE coupling S row-major; pos_out, vel_out: (3 n_mol, 3) float,
// apart from every input.  Returns the cudaError_t of the launch.
extern "C" int nbs_water_tail(const void* slot_f, const void* inv_slots,
                              const void* pos, const void* vel,
                              const void* charge, const void* pair_slices,
                              const void* lam, const void* inv_mass,
                              const void* settle, void* pos_out,
                              void* vel_out, int n_mol, int capacity,
                              float alpha, float coulomb, float inv_sqrt_pi,
                              float dt, float inv_dt, void* stream) {
    if (n_mol <= 0 || capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const TailParams p{n_mol, capacity, alpha, coulomb, inv_sqrt_pi, dt, inv_dt};
    const int blocks = (n_mol + kThreads - 1) / kThreads;
    water_tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(slot_f),
        static_cast<const long long*>(inv_slots),
        static_cast<const float*>(pos), static_cast<const float*>(vel),
        static_cast<const float*>(charge),
        static_cast<const long long*>(pair_slices),
        static_cast<const float*>(lam), static_cast<const float*>(inv_mass),
        static_cast<const float*>(settle), static_cast<float*>(pos_out),
        static_cast<float*>(vel_out), p);
    return static_cast<int>(cudaGetLastError());
}
