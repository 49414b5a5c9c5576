// PME extract: per-brick potential windows copied out of the potential grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_extract_kernel
// (pallas_call at pallas_pme.py:316), the inverse layout of the fold kernel
// in the same +1-shifted grid convention: window point u of brick b reads
// grid line (b*p + u) mod n.  There one program copies 8 static corner
// regions per brick column.  A pure copy: equal to its plain twin to the
// bit.
//
// What bounds it on an H100: bytes.  It reads the grids (2.6 MB at the
// benchmark shapes, each point up to 8 times, from L2) and writes every
// window point once (10.6 MB).  A block owns one window (brick, subset) and
// writes it whole: thread (c, uy, ux) the chunk of kOut floats c of row
// (ux, uy), 16 bytes where the rows start on 16 bytes (wz % 4 == 0, as the
// 16-point rows of the benchmark), for ux, uy and c in steps of the block's
// extent, so any window shape takes the same block.  Its grid points are
// read one float at a time: a row starts at z = Z*pz, off the grid's 16
// bytes (float2 pairs where pz and nz are even measured no faster).  Grid
// indices wrap by one compare and subtraction (w <= 2p <= n + p);
// the window's brick and subset come from the block index, one division a
// thread.  It measured faster than the mirror of csrc/pme_fold.cu's design
// (a warp a grid line, read once and written into the <= 4 x bz window
// rows it feeds; PERF.md §6).  No atomics, no barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 6;      // w = p + order + 1, order 5
constexpr int kThreads = 256;   // threads of a block, at most

struct ExtractShape {
    int nsub, bx, by, bz, px, py, pz;
};

template <int kOut> struct Vec;
template <> struct Vec<1> {
    using T = float;
    __device__ static T make(const float* e) { return e[0]; }
};
template <> struct Vec<2> {
    using T = float2;
    __device__ static T make(const float* e) { return make_float2(e[0], e[1]); }
};
template <> struct Vec<4> {
    using T = float4;
    __device__ static T make(const float* e) {
        return make_float4(e[0], e[1], e[2], e[3]);
    }
};

__device__ __forceinline__ int wrap_once(int i, int n) {
    return i >= n ? i - n : i;
}

// kOut floats per store (4 where every window row starts on 16 bytes, 2 on
// 8, else 1)
template <int kOut>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ grid, float* __restrict__ W,
               ExtractShape sh) {
    const int wx = sh.px + kMargin, wy = sh.py + kMargin, wz = sh.pz + kMargin;
    const int nx = sh.bx * sh.px, ny = sh.by * sh.py, nz = sh.bz * sh.pz;
    const int X = blockIdx.x / sh.nsub, s = blockIdx.x - X * sh.nsub;
    const int Y = blockIdx.y, Z = blockIdx.z;
    const float* grid_s = grid + static_cast<long long>(s) * nx * ny * nz;
    float* window = W + (((static_cast<long long>(X) * sh.by + Y) * sh.bz + Z)
                         * sh.nsub + s) * wx * wy * wz;
    for (int uz = threadIdx.x * kOut; uz < wz; uz += blockDim.x * kOut) {
        int gz[kOut];
#pragma unroll
        for (int k = 0; k < kOut; ++k) gz[k] = wrap_once(Z * sh.pz + uz + k, nz);
        for (int uy = threadIdx.y; uy < wy; uy += blockDim.y) {
            const int gy = wrap_once(Y * sh.py + uy, ny);
            for (int ux = threadIdx.z; ux < wx; ux += blockDim.z) {
                const int gx = wrap_once(X * sh.px + ux, nx);
                const float* line =
                    grid_s + (static_cast<long long>(gx) * ny + gy) * nz;
                float e[kOut];
#pragma unroll
                for (int k = 0; k < kOut; ++k) e[k] = line[gz[k]];
                *reinterpret_cast<typename Vec<kOut>::T*>(
                    window + (ux * wy + uy) * wz + uz) = Vec<kOut>::make(e);
            }
        }
    }
}

template <int kOut>
void launch(const float* grid, float* W, const ExtractShape& sh,
            cudaStream_t st) {
    const int wx = sh.px + kMargin, wy = sh.py + kMargin;
    const int chunks = (sh.pz + kMargin) / kOut;
    const int tx = chunks < 32 ? chunks : 32;
    const int ty = wy < kThreads / tx ? wy : kThreads / tx;
    const int tz = wx < kThreads / (tx * ty) ? wx : kThreads / (tx * ty);
    extract_kernel<kOut><<<dim3(sh.bx * sh.nsub, sh.by, sh.bz),
                           dim3(tx, ty, tz), 0, st>>>(grid, W, sh);
}

}  // namespace

// grid: the +1-shifted potential grids (nsub, bx*px, by*py, bz*pz); W:
// windows (bx, by, bz, nsub, wx, wy, wz), w = p + 6 <= 2p.  Returns the
// cudaError_t of the launch, cudaErrorInvalidValue when the bricks along y
// or z exceed a launch grid's 65,535 or the bricks along x times the
// subsets 2^31 - 1.
extern "C" int nbs_pme_extract(const void* grid, void* W, int nsub, int bx,
                               int by, int bz, int px, int py, int pz,
                               void* stream) {
    if (by > 65535 || bz > 65535
        || static_cast<long long>(bx) * nsub >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const ExtractShape sh{nsub, bx, by, bz, px, py, pz};
    const auto g = static_cast<const float*>(grid);
    const auto w = static_cast<float*>(W);
    const auto st = static_cast<cudaStream_t>(stream);
    const int wz = pz + kMargin;
    const size_t at = reinterpret_cast<size_t>(W);
    if (wz % 4 == 0 && at % 16 == 0)
        launch<4>(g, w, sh, st);
    else if (wz % 2 == 0 && at % 8 == 0)
        launch<2>(g, w, sh, st);
    else
        launch<1>(g, w, sh, st);
    return static_cast<int>(cudaGetLastError());
}
