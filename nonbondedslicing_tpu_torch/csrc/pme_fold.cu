// PME fold: overlap-add of per-brick charge windows into the charge grids.
//
// Replaces nonbondedslicing_tpu/ops/pallas_pme.py::make_fold_kernel
// (pallas_call at pallas_pme.py:249), where one program owns an (X, Y)
// column of grid blocks and sums static corner regions of four neighbour
// window columns in VMEM.  Same convention: window point u of brick b covers
// line (b*p + u) mod n of the output, which is therefore the true grid
// shifted by +1 on each axis.  Here one block owns a few grid lines along z
// and one thread one grid point (s, X*px + x, Y*py + y, Z*pz + z) at a time: it
// reads brick (X, Y, Z) at (x, y, z)
// and, where x < wx - px (likewise y, z), the brick before it at x + px, and
// adds the <= 8 pieces in the order of the TPU kernel's loops (x outermost,
// the brick's own piece first), so that the sums equal the plain twin's and
// the interpret-mode Pallas kernel's to the bit.  Needs w <= 2p per axis
// (checked by the wrapper).  No atomics.
//
// What bounds it on an H100: bytes.  It reads every window point once
// (10.6 MB at the benchmark shapes: 216 bricks x 3 subsets x 16^3 floats)
// and writes the grids (2.6 MB); the writes and the reads along z are
// contiguous in runs of pz points.

#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 6;   // w = p + order + 1, order 5
constexpr int kLines = 4;    // grid lines a block folds

__global__ void fold_kernel(const float* __restrict__ W,
                            float* __restrict__ grid, int nsub, int bx,
                            int by, int bz, int px, int py, int pz) {
    const int wx = px + kMargin, wy = py + kMargin, wz = pz + kMargin;
    const int ny = by * py, nz = bz * pz;
    // one block per kLines grid lines (s, gx, gy.., :), one thread row per
    // line: the x pieces are the block's, the y pieces a thread row's, and a
    // thread divides only along z
    const int gx = blockIdx.x, s = blockIdx.z;
    const int gy = blockIdx.y * kLines + threadIdx.y;
    if (gy >= ny) return;
    const int X = gx / px, x = gx - X * px;
    const int Y = gy / py, y = gy - Y * py;
    const int ndx = x < wx - px ? 2 : 1;
    const int ndy = y < wy - py ? 2 : 1;
    float* line = grid + ((static_cast<long long>(s) * gridDim.x + gx) * ny + gy) * nz;
    for (int gz = threadIdx.x; gz < nz; gz += blockDim.x) {
        const int Z = gz / pz, z = gz - Z * pz;
        const int ndz = z < wz - pz ? 2 : 1;
        float acc = 0.0f;
        bool first = true;
        for (int dx = 0; dx < ndx; ++dx) {
            const int Bx = X - dx < 0 ? bx - 1 : X - dx;
            const int ux = x + dx * px;
            for (int dy = 0; dy < ndy; ++dy) {
                const int By = Y - dy < 0 ? by - 1 : Y - dy;
                const int uy = y + dy * py;
                for (int dz = 0; dz < ndz; ++dz) {
                    const int Bz = Z - dz < 0 ? bz - 1 : Z - dz;
                    const int uz = z + dz * pz;
                    const long long brick = (static_cast<long long>(Bx) * by + By) * bz + Bz;
                    const float v = W[(((brick * nsub + s) * wx + ux) * wy + uy) * wz + uz];
                    acc = first ? v : acc + v;
                    first = false;
                }
            }
        }
        line[gz] = acc;
    }
}

}  // namespace

// W: windows (bx, by, bz, nsub, wx, wy, wz), w = p + 6; grid: the +1-shifted
// charge grids (nsub, bx*px, by*py, bz*pz).  Returns the cudaError_t of the
// launch, cudaErrorInvalidValue when the grid's y axis or the subsets
// exceed a launch grid's 65,535.
extern "C" int nbs_pme_fold(const void* W, void* grid, int nsub, int bx,
                            int by, int bz, int px, int py, int pz,
                            void* stream) {
    const int nz = bz * pz;
    const int ny = by * py;
    if (ny > 65535 || nsub > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = nz >= 256 ? 256 : (nz + 31) / 32 * 32;
    fold_kernel<<<dim3(bx * px, (ny + kLines - 1) / kLines, nsub),
                  dim3(threads, kLines), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W), static_cast<float*>(grid), nsub, bx, by,
        bz, px, py, pz);
    return static_cast<int>(cudaGetLastError());
}
