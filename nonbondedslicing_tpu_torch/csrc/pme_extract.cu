// PME extract: per-brick potential windows copied out of the potential grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_extract_kernel
// (pallas_call at pallas_pme.py:316), the inverse layout of the fold kernel
// in the same +1-shifted grid convention: window point u of brick b reads
// grid line (b*p + u) mod n.  There one program copies 8 static corner
// regions per brick column; here one block copies a few (wy, wz) planes of
// a window, one element of each per thread at a time.  A pure copy: equal to its plain
// twin to the bit.
//
// What bounds it on an H100: bytes.  It reads the grids (2.6 MB at the
// benchmark shapes, each point up to 8 times, from L2) and writes every
// window point once (10.6 MB), contiguously.

#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 6;   // w = p + order + 1, order 5
constexpr int kPlanes = 4;   // window planes a block copies

__global__ void extract_kernel(const float* __restrict__ grid,
                               float* __restrict__ W, int nsub, int bx,
                               int by, int bz, int px, int py, int pz) {
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const int nx = bx * px, ny = by * py, nz = bz * pz;
    // one block per kPlanes window planes (brick, s, ux.., :, :): the brick
    // is the block's, and a thread divides once for its kPlanes elements
    const int s = blockIdx.y, brick = blockIdx.z;
    const int Z = brick % bz, Y = (brick / bz) % by, X = brick / (bz * by);
    const float* grid_s = grid + static_cast<long long>(s) * nx * ny * nz;
    float* window = W + (static_cast<long long>(brick) * nsub + s) * wx * wy * wz;
    for (int t = threadIdx.x; t < wy * wz; t += blockDim.x) {
        const int uy = t / wz, uz = t - uy * wz;
        int gy = Y * py + uy, gz = Z * pz + uz;   // < 2n: w <= 2p <= n + p
        if (gy >= ny) gy -= ny;
        if (gz >= nz) gz -= nz;
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
            const int ux = blockIdx.x * kPlanes + k;
            if (ux < wx) {
                const int gx = (X * px + ux) % nx;
                window[ux * wy * wz + t] = grid_s[(gx * ny + gy) * nz + gz];
            }
        }
    }
}

}  // namespace

// grid: the +1-shifted potential grids (nsub, bx*px, by*py, bz*pz); W:
// windows (bx, by, bz, nsub, wx, wy, wz), w = p + 6.  Returns the
// cudaError_t of the launch, cudaErrorInvalidValue when the bricks or the
// subsets exceed a launch grid's 65,535.
extern "C" int nbs_pme_extract(const void* grid, void* W, int nsub, int bx,
                               int by, int bz, int px, int py, int pz,
                               void* stream) {
    if (nsub > 65535 || bx * by * bz > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    extract_kernel<<<dim3((px + kMargin + kPlanes - 1) / kPlanes, nsub,
                          bx * by * bz), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<float*>(W), nsub, bx, by,
        bz, px, py, pz);
    return static_cast<int>(cudaGetLastError());
}
