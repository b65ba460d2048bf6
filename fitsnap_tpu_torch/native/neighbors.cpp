// Native periodic neighbor construction for padded descriptor batches.
//
// C++ analog of the role LAMMPS' neighbor machinery plays for the reference
// (`fitsnap3lib/calculators/lammps_base.py:145-236` drives `neighbor ... nsq`
// inside the embedded C++ LAMMPS): here it feeds fixed-shape
// (disp, jidx, mask) tensors to the descriptor kernels.  Semantics match
// `fitsnap_tpu_torch/ops/neighbors.py:host_neighbors_plain` (same
// image-shift enumeration, same cutoff convention, same slot ordering) so
// the two are interchangeable; this one avoids the O(A^2 * S) dense numpy
// temporaries and is what `host_neighbors` runs.
//
// Exported C ABI (ctypes):
//   fs_neighbors(pos, cell, natoms, cutoff, a_pad, k_pad, disp, jidx, mask)
//     -> kmax (max neighbors over atoms), or -(needed) if k_pad too small.
//   With a_pad == 0: count-only mode (disp/jidx/mask may be null).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// perpendicular widths of the cell (columns are lattice vectors)
static void plane_widths(const double cell[9], double w[3]) {
    // inv = cell^{-1}; width_i = 1 / ||row_i(inv)||
    const double a = cell[0], b = cell[1], c = cell[2];
    const double d = cell[3], e = cell[4], f = cell[5];
    const double g = cell[6], h = cell[7], i = cell[8];
    const double A =  (e * i - f * h), B = -(d * i - f * g), C =  (d * h - e * g);
    const double D = -(b * i - c * h), E =  (a * i - c * g), F = -(a * h - b * g);
    const double G =  (b * f - c * e), H = -(a * f - c * d), I =  (a * e - b * d);
    const double det = a * A + b * B + c * C;
    // rows of inv (adjugate^T / det): row0 = (A, D, G)/det ...
    const double r0[3] = {A / det, D / det, G / det};
    const double r1[3] = {B / det, E / det, H / det};
    const double r2[3] = {C / det, F / det, I / det};
    w[0] = 1.0 / std::sqrt(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]);
    w[1] = 1.0 / std::sqrt(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
    w[2] = 1.0 / std::sqrt(r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]);
}

}  // namespace

extern "C" {

// pos: natoms x 3 row vectors. cell: 3x3 row-major, lattice vectors as
// COLUMNS (the scrape-time QR convention). Outputs (when a_pad > 0):
//   disp: a_pad x k_pad x 3, jidx: a_pad x k_pad (int32),
//   mask: a_pad x k_pad (uint8).  Buffers must be zero-initialized or are
//   fully overwritten here (they are fully zeroed here).
int fs_neighbors(const double* pos, const double* cell, int natoms,
                 double cutoff, int a_pad, int k_pad,
                 double* disp, int32_t* jidx, uint8_t* mask) {
    double w[3];
    plane_widths(cell, w);
    int n1 = (int)std::ceil(cutoff / w[0] - 1e-12);
    int n2 = (int)std::ceil(cutoff / w[1] - 1e-12);
    int n3 = (int)std::ceil(cutoff / w[2] - 1e-12);
    if (n1 < 0) n1 = 0;
    if (n2 < 0) n2 = 0;
    if (n3 < 0) n3 = 0;

    // shift vectors in cartesian space: s = (i, j, k) @ cell^T, home first
    std::vector<double> sv;
    sv.reserve((size_t)(2 * n1 + 1) * (2 * n2 + 1) * (2 * n3 + 1) * 3);
    sv.push_back(0.0); sv.push_back(0.0); sv.push_back(0.0);
    for (int i = -n1; i <= n1; ++i)
        for (int j = -n2; j <= n2; ++j)
            for (int k = -n3; k <= n3; ++k) {
                if (i == 0 && j == 0 && k == 0) continue;
                sv.push_back(i * cell[0] + j * cell[1] + k * cell[2]);
                sv.push_back(i * cell[3] + j * cell[4] + k * cell[5]);
                sv.push_back(i * cell[6] + j * cell[7] + k * cell[8]);
            }
    const int S = (int)(sv.size() / 3);
    const double cut2 = cutoff * cutoff;

    if (a_pad > 0) {
        std::memset(disp, 0, sizeof(double) * (size_t)a_pad * k_pad * 3);
        std::memset(jidx, 0, sizeof(int32_t) * (size_t)a_pad * k_pad);
        std::memset(mask, 0, sizeof(uint8_t) * (size_t)a_pad * k_pad);
    }

    int kmax = 0;
    int overflow_need = 0;
    for (int i = 0; i < natoms; ++i) {
        const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
        int slot = 0;
        for (int s = 0; s < S; ++s) {
            const double sx = sv[3 * s], sy = sv[3 * s + 1], sz = sv[3 * s + 2];
            for (int j = 0; j < natoms; ++j) {
                if (s == 0 && j == i) continue;
                const double dx = pos[3 * j] + sx - xi;
                const double dy = pos[3 * j + 1] + sy - yi;
                const double dz = pos[3 * j + 2] + sz - zi;
                const double d2 = dx * dx + dy * dy + dz * dz;
                if (d2 < cut2) {
                    if (a_pad > 0) {
                        if (slot >= k_pad) {
                            ++slot;  // keep counting for the retry hint
                            continue;
                        }
                        const size_t o = ((size_t)i * k_pad + slot);
                        disp[3 * o] = dx;
                        disp[3 * o + 1] = dy;
                        disp[3 * o + 2] = dz;
                        jidx[o] = j;
                        mask[o] = 1;
                    }
                    ++slot;
                }
            }
        }
        if (slot > kmax) kmax = slot;
        if (a_pad > 0 && slot > k_pad && slot > overflow_need)
            overflow_need = slot;
    }
    if (overflow_need > 0) return -overflow_need;
    return kmax;
}

// Batched count-only pass: kmax per config, for bucket planning.
//   pos_all: concatenated natoms_i x 3; offsets: per-config start atom.
void fs_count_batch(const double* pos_all, const double* cells,
                    const int32_t* natoms, const int32_t* offsets,
                    int nconfigs, double cutoff, int32_t* kmax_out) {
    for (int c = 0; c < nconfigs; ++c) {
        kmax_out[c] = fs_neighbors(pos_all + (size_t)offsets[c] * 3,
                                   cells + (size_t)c * 9, natoms[c], cutoff,
                                   0, 0, nullptr, nullptr, nullptr);
    }
}

}  // extern "C"
