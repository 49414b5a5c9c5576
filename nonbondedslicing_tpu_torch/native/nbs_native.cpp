// Native host-side helpers for nonbondedslicing_tpu_torch.
//
// The port's own copy of the JAX package's nonbondedslicing_tpu/native/
// nbs_native.cpp (same entry points, same arithmetic).  The device path is
// PyTorch and the CUDA kernels under csrc/; this library covers host work
// that the reference plugin does in C++ outside its kernels:
//   * legal FFT dimension search (the reference's
//     FFT3DFactory::findLegalDimension, platforms/common/include/
//     FFT3DFactory.h:31-47)
//   * per-slice long-range dispersion corrections, O(C^2) over particle
//     classes (SlicedNonbondedForceImpl::calcDispersionCorrections,
//     openmmapi/src/SlicedNonbondedForceImpl.cpp:263-354)
//   * voxel-hash neighbor-list construction (a host oracle mirroring
//     OpenMM's computeNeighborListVoxelHash, which
//     ReferenceNonbondedSlicingKernels.cpp:197 calls)
//   * cell-occupancy statistics, to size a static cell list
//
// A plain C ABI loaded with ctypes (runtime/native.py builds it with g++ at
// first use); every entry point has a pure-Python fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <tuple>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- fft sizes

int nbs_find_legal_dimension(int minimum, int max_factor) {
    int n = minimum < 1 ? 1 : minimum;
    const int factors[6] = {2, 3, 5, 7, 11, 13};
    for (;; ++n) {
        int m = n;
        for (int f : factors) {
            if (f > max_factor) break;
            while (m % f == 0) m /= f;
        }
        if (m == 1) return n;
    }
}

// ------------------------------------------------------ dispersion corrections

static double eval_integral(double r, double rs, double rc, double sigma) {
    // Indefinite integral of r^2 * U_LJ(r) * S(r) with the quintic switch.
    double A = 1.0 / (rc - rs);
    double A2 = A * A, A3 = A2 * A;
    double sig2 = sigma * sigma;
    double sig6 = sig2 * sig2 * sig2;
    double rs2 = rs * rs, rs3 = rs * rs2;
    double r2 = r * r, r3 = r * r2, r4 = r * r3, r5 = r * r4, r6 = r * r5;
    double r9 = r3 * r6;
    return sig6 * A3 *
           ((sig6 * (+rs3 * 28 * (6 * rs2 * A2 + 15 * rs * A + 10) -
                     r * rs2 * 945 * (rs2 * A2 + 2 * rs * A + 1) +
                     r2 * rs * 1080 * (2 * rs2 * A2 + 3 * rs * A + 1) -
                     r3 * 420 * (6 * rs2 * A2 + 6 * rs * A + 1) +
                     r4 * 756 * (2 * rs * A2 + A) - r5 * 378 * A2) -
             r6 * (+rs3 * 84 * (6 * rs2 * A2 + 15 * rs * A + 10) -
                   r * rs2 * 3780 * (rs2 * A2 + 2 * rs * A + 1) +
                   r2 * rs * 7560 * (2 * rs2 * A2 + 3 * rs * A + 1))) /
                (252 * r9) -
            std::log(r) * 10 * (6 * rs2 * A2 + 6 * rs * A + 1) +
            r * 15 * (2 * rs * A2 + A) - r2 * 3 * A2);
}

static inline int slice_index(int i, int j) {
    return i > j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// sigma/epsilon include parameter offsets at default global values.
// out has num_subsets*(num_subsets+1)/2 entries (kJ/mol * nm^3).
void nbs_dispersion_corrections(int64_t n, const double* sigma,
                                const double* epsilon, const int32_t* subset,
                                int num_subsets, int use_switch, double cutoff,
                                double switch_dist, double* out) {
    int num_slices = num_subsets * (num_subsets + 1) / 2;
    std::map<std::tuple<double, double, int>, int64_t> class_counts;
    for (int64_t i = 0; i < n; ++i)
        class_counts[{sigma[i], epsilon[i], subset[i]}] += 1;

    std::vector<double> sum1(num_slices, 0.0), sum2(num_slices, 0.0),
        sum3(num_slices, 0.0);
    auto accumulate = [&](int sl, double count, double sig, double eps) {
        double sig2 = sig * sig;
        double sig6 = sig2 * sig2 * sig2;
        sum1[sl] += count * eps * sig6 * sig6;
        sum2[sl] += count * eps * sig6;
        if (use_switch)
            sum3[sl] += count * eps *
                        (eval_integral(cutoff, switch_dist, cutoff, sig) -
                         eval_integral(switch_dist, switch_dist, cutoff, sig));
    };

    std::vector<std::tuple<double, double, int, int64_t>> classes;
    classes.reserve(class_counts.size());
    for (auto& kv : class_counts)
        classes.emplace_back(std::get<0>(kv.first), std::get<1>(kv.first),
                             std::get<2>(kv.first), kv.second);
    for (auto& c : classes) {
        int sub = std::get<2>(c);
        double cnt = (double)std::get<3>(c);
        accumulate(sub * (sub + 3) / 2, cnt * (cnt + 1) / 2, std::get<0>(c),
                   std::get<1>(c));
    }
    for (size_t a = 0; a < classes.size(); ++a)
        for (size_t b = 0; b < a; ++b) {
            double c1 = (double)std::get<3>(classes[a]);
            double c2 = (double)std::get<3>(classes[b]);
            accumulate(slice_index(std::get<2>(classes[a]),
                                   std::get<2>(classes[b])),
                       c1 * c2,
                       0.5 * (std::get<0>(classes[a]) + std::get<0>(classes[b])),
                       std::sqrt(std::get<1>(classes[a]) *
                                 std::get<1>(classes[b])));
        }

    double num_interactions = (double)n * (n + 1) / 2;
    double c3 = cutoff * cutoff * cutoff;
    double c9 = c3 * c3 * c3;
    const double pi = 3.14159265358979323846;
    for (int s = 0; s < num_slices; ++s)
        out[s] = 8.0 * (double)n * (double)n * pi *
                 (sum1[s] / num_interactions / (9 * c9) -
                  sum2[s] / num_interactions / (3 * c3) +
                  sum3[s] / num_interactions);
}

// ------------------------------------------------------------- neighbor list

// Voxel-hash neighbor list over an orthorhombic (or reduced triclinic,
// diagonal-dominant) periodic box.  Returns the number of pairs written
// (<= max_pairs; if more exist, the count is returned but only max_pairs are
// stored — callers re-invoke with a larger buffer).
int64_t nbs_neighbor_pairs(int64_t n, const double* pos, const double* box,
                           double cutoff, int periodic, int64_t* out_pairs,
                           int64_t max_pairs) {
    double bx = box[0], by = box[4], bz = box[8];
    double ox = 0.0, oy = 0.0, oz = 0.0;  // cell-grid origin (non-periodic)
    int ncx = 1, ncy = 1, ncz = 1;
    if (!periodic) {
        // bounding box
        double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
        for (int64_t i = 0; i < n; ++i)
            for (int d = 0; d < 3; ++d) {
                lo[d] = std::min(lo[d], pos[3 * i + d]);
                hi[d] = std::max(hi[d], pos[3 * i + d]);
            }
        ox = lo[0]; oy = lo[1]; oz = lo[2];
        bx = hi[0] - lo[0] + 1e-9;
        by = hi[1] - lo[1] + 1e-9;
        bz = hi[2] - lo[2] + 1e-9;
    }
    ncx = std::max(1, (int)(bx / cutoff));
    ncy = std::max(1, (int)(by / cutoff));
    ncz = std::max(1, (int)(bz / cutoff));
    int64_t n_cells = (int64_t)ncx * ncy * ncz;
    std::vector<std::vector<int32_t>> cells(n_cells);
    std::vector<int> cx(n), cy(n), cz(n);
    for (int64_t i = 0; i < n; ++i) {
        double fx = (pos[3 * i] - ox) / bx, fy = (pos[3 * i + 1] - oy) / by,
               fz = (pos[3 * i + 2] - oz) / bz;
        fx -= std::floor(fx); fy -= std::floor(fy); fz -= std::floor(fz);
        cx[i] = std::min((int)(fx * ncx), ncx - 1);
        cy[i] = std::min((int)(fy * ncy), ncy - 1);
        cz[i] = std::min((int)(fz * ncz), ncz - 1);
        cells[((int64_t)cx[i] * ncy + cy[i]) * ncz + cz[i]].push_back((int32_t)i);
    }
    double cutoff2 = cutoff * cutoff;
    int64_t count = 0;
    auto minimg = [&](double d, double w) {
        if (!periodic) return d;
        return d - w * std::floor(d / w + 0.5);
    };
    int64_t nbr[27];
    for (int64_t i = 0; i < n; ++i) {
        int n_nbr = 0;
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    int ux = cx[i] + dx, uy = cy[i] + dy, uz = cz[i] + dz;
                    if (periodic) {
                        ux = (ux + ncx) % ncx; uy = (uy + ncy) % ncy;
                        uz = (uz + ncz) % ncz;
                    } else if (ux < 0 || uy < 0 || uz < 0 || ux >= ncx ||
                               uy >= ncy || uz >= ncz)
                        continue;
                    int64_t cid = ((int64_t)ux * ncy + uy) * ncz + uz;
                    bool dup = false;  // wrapped duplicates when some nc < 3
                    for (int k = 0; k < n_nbr; ++k)
                        if (nbr[k] == cid) { dup = true; break; }
                    if (!dup) nbr[n_nbr++] = cid;
                }
        for (int k = 0; k < n_nbr; ++k)
            for (int32_t j : cells[nbr[k]]) {
                if (j <= i) continue;
                double ddx = minimg(pos[3 * i] - pos[3 * j], bx);
                double ddy = minimg(pos[3 * i + 1] - pos[3 * j + 1], by);
                double ddz = minimg(pos[3 * i + 2] - pos[3 * j + 2], bz);
                double r2 = ddx * ddx + ddy * ddy + ddz * ddz;
                if (r2 < cutoff2) {
                    if (count < max_pairs) {
                        out_pairs[2 * count] = i;
                        out_pairs[2 * count + 1] = j;
                    }
                    ++count;
                }
            }
    }
    return count;
}

// Max atoms in any cell of an (ncx, ncy, ncz) fractional grid — used to
// validate/size the static capacity of a cell list.
int32_t nbs_max_cell_occupancy(int64_t n, const double* pos, const double* box,
                               int ncx, int ncy, int ncz) {
    double bx = box[0], by = box[4], bz = box[8];
    std::vector<int32_t> occ((int64_t)ncx * ncy * ncz, 0);
    int32_t best = 0;
    for (int64_t i = 0; i < n; ++i) {
        double fx = pos[3 * i] / bx, fy = pos[3 * i + 1] / by,
               fz = pos[3 * i + 2] / bz;
        fx -= std::floor(fx); fy -= std::floor(fy); fz -= std::floor(fz);
        int cxi = std::min((int)(fx * ncx), ncx - 1);
        int cyi = std::min((int)(fy * ncy), ncy - 1);
        int czi = std::min((int)(fz * ncz), ncz - 1);
        best = std::max(best, ++occ[((int64_t)cxi * ncy + cyi) * ncz + czi]);
    }
    return best;
}

}  // extern "C"
