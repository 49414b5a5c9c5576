// PME fold: overlap-add of per-brick charge windows into the charge grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_fold_kernel
// (pallas_call at pallas_pme.py:249), where one program owns an (X, Y)
// column of grid blocks and sums static corner regions of four neighbour
// window columns in VMEM.  Same convention: window point u of brick b covers
// line (b*p + u) mod n of the output, which is therefore the true grid
// shifted by +1 on each axis.  Needs w <= 2p per axis (checked by the
// wrapper), so an output point takes at most two bricks' pieces per axis.
//
// What bounds it on an H100: bytes.  It reads every window point once
// (10.6 MB at the benchmark shapes: 216 bricks x 3 subsets x 16^3 floats)
// and writes the grids (2.6 MB).  The design reads each byte once, in whole
// rows: a window row W[B, s, ux, uy, 0:wz] lands on exactly one output line
// (s, gx, gy, 0:nz).  So a warp owns one output line and a block up to kWarps
// neighbouring lines along y.  The warp copies the <= 4 (dx, dy) x bz rows of
// its line into its own shared-memory stage, lanes on consecutive addresses,
// 16 bytes a lane where the rows allow it, every copy in flight at once
// (cp.async); then it forms each output point from the stage, adding its
// <= 8 pieces in the order of the TPU kernel's loops (x outermost, the
// brick's own piece first), so that the sums equal the plain twin's and the
// interpret-mode Pallas kernel's to the bit, and stores the line in
// warp-wide contiguous stores.  Brick and offset indices come from the block
// and lane indices through multiply-high divisions by the few sizes of the
// layout (magic numbers made once on the host), not from integer division.
// No atomics, no barrier.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 6;    // w = p + order + 1, order 5
constexpr int kWarps = 8;     // output lines a block owns, at most
constexpr int kStageBytes = 48 * 1024;   // without the opt-in attribute

// n / d for 0 <= n, d < 2^16, d >= 2, as __umulhi(n, magic(d)): exact,
// since n * d < 2^32
struct FastDiv {
    unsigned magic;
    int d;
};

FastDiv fast_div(int d) {
    return {0xffffffffu / static_cast<unsigned>(d) + 1u, d};
}

__device__ __forceinline__ int div_of(int n, FastDiv f) {
    return static_cast<int>(__umulhi(static_cast<unsigned>(n), f.magic));
}

struct FoldShape {
    int nsub, bx, by, bz, px, py, pz;
    FastDiv px_div, py_div, pz_div, chunks_div;   // chunks: wz / kVec
};

// kVec floats per copy (4 where every row starts on 16 bytes, else 1)
template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
fold_kernel(const float* __restrict__ W, float* __restrict__ grid,
            FoldShape sh) {
    extern __shared__ float4 smem4[];
    const int wx = sh.px + kMargin, wy = sh.py + kMargin, wz = sh.pz + kMargin;
    const int nx = sh.bx * sh.px, ny = sh.by * sh.py, nz = sh.bz * sh.pz;
    const int row_len = sh.bz * wz;        // one (dx, dy) piece: bz rows
    const int chunks = row_len / kVec;
    const int zstride = sh.nsub * wx * wy * wz;   // brick Bz to Bz + 1
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gx = blockIdx.y, s = blockIdx.z;
    const int gy = blockIdx.x * (blockDim.x >> 5) + warp;
    if (gy >= ny) return;
    float* stage = reinterpret_cast<float*>(smem4) + warp * 4 * row_len;
    const int X = div_of(gx, sh.px_div), x = gx - X * sh.px;
    const int Y = div_of(gy, sh.py_div), y = gy - Y * sh.py;
    const int ndx = x < wx - sh.px ? 2 : 1;
    const int ndy = y < wy - sh.py ? 2 : 1;
    for (int dx = 0; dx < ndx; ++dx) {
        const int Bx = X - dx < 0 ? sh.bx - 1 : X - dx;
        for (int dy = 0; dy < ndy; ++dy) {
            const int By = Y - dy < 0 ? sh.by - 1 : Y - dy;
            // row (ux, uy) of brick (Bx, By, 0), subset s
            const float* src =
                W + ((((static_cast<long long>(Bx) * sh.by + By) * sh.bz
                       * sh.nsub + s) * wx + x + dx * sh.px) * wy
                     + y + dy * sh.py) * wz;
            float* dst = stage + (dx * 2 + dy) * row_len;
            for (int i = lane; i < chunks; i += 32) {
                const int Z = div_of(i, sh.chunks_div);
                __pipeline_memcpy_async(
                    dst + i * kVec,
                    src + Z * zstride + (i - Z * sh.chunks_div.d) * kVec,
                    sizeof(float) * kVec);
            }
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();

    float* line = grid + ((static_cast<long long>(s) * nx + gx) * ny + gy) * nz;
    for (int gz = lane; gz < nz; gz += 32) {
        const int Z = div_of(gz, sh.pz_div), z = gz - Z * sh.pz;
        const int own = Z * wz + z;                     // dz = 0
        const int before = (Z == 0 ? sh.bz - 1 : Z - 1) * wz + z + sh.pz;
        const bool two_z = z < wz - sh.pz;              // a dz = 1 piece
        float acc = stage[own];
        if (two_z) acc += stage[before];
        for (int k = 1; k < ndx * 2; ++k) {
            if ((k & 1) >= ndy) continue;               // no dy = 1 piece
            const float* piece = stage + k * row_len;
            acc += piece[own];
            if (two_z) acc += piece[before];
        }
        line[gz] = acc;
    }
}

}  // namespace

// W: windows (bx, by, bz, nsub, wx, wy, wz), w = p + 6; grid: the +1-shifted
// charge grids (nsub, bx*px, by*py, bz*pz).  Returns the cudaError_t of the
// launch, cudaErrorInvalidValue when the subsets exceed a launch grid's
// 65,535, an axis has 2^16 points or more, a (brick, subset) column of
// windows exceeds 2^31 floats, or one line's stage exceeds 48 KB.
extern "C" int nbs_pme_fold(const void* W, void* grid, int nsub, int bx,
                            int by, int bz, int px, int py, int pz,
                            void* stream) {
    const int nx = bx * px, ny = by * py, nz = bz * pz;
    const int wz = pz + kMargin;
    const long long column = static_cast<long long>(bz) * nsub * (px + kMargin)
                             * (py + kMargin) * wz;
    const int line_bytes = 4 * bz * wz * 4;    // a warp's stage
    const int warps = kStageBytes / line_bytes < kWarps
                          ? kStageBytes / line_bytes : kWarps;
    if (nsub > 65535 || nx >= (1 << 16) || ny >= (1 << 16)
        || nz >= (1 << 16) || column >= (1LL << 31) || warps < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = warps * line_bytes;
    const bool vec = wz % 4 == 0 && reinterpret_cast<size_t>(W) % 16 == 0;
    FoldShape sh{nsub, bx, by, bz, px, py, pz, fast_div(px), fast_div(py),
                 fast_div(pz), fast_div(vec ? wz / 4 : wz)};
    const dim3 blocks((ny + warps - 1) / warps, nx, nsub);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        fold_kernel<4><<<blocks, warps * 32, bytes, st>>>(
            static_cast<const float*>(W), static_cast<float*>(grid), sh);
    else
        fold_kernel<1><<<blocks, warps * 32, bytes, st>>>(
            static_cast<const float*>(W), static_cast<float*>(grid), sh);
    return static_cast<int>(cudaGetLastError());
}
