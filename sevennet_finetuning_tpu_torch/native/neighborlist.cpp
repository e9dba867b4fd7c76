// Periodic cell-list neighbor search (native core for the data/MD path).
//
// Copy of native/neighborlist.cpp, bound by the port's data/native.py.
// Native counterpart of the Python neighbor list in
// data/neighborlist.py -- the role the LAMMPS
// neighbor machinery plays for the reference's pair styles (reference:
// sevenn/pair_e3gnn/pair_e3gnn.cpp:144-182).  Exposed through a plain C
// ABI for ctypes.
//
// Algorithm: wrap atoms into the home cell (per periodic axis), build the
// set of lattice images whose atoms can fall within the cutoff of the
// home cell, bin all images into a uniform grid of side >= cutoff, then
// for every home atom scan the 27 surrounding bins.  Both edge
// directions are emitted; the trivial self pair (i, i, S=0) is skipped.
//
// Build: g++ -O3 -march=native -shared -fPIC neighborlist.cpp -o <lib>.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 { double x, y, z; };

inline V3 matvec(const double* m, double a, double b, double c) {
    // row-vector convention: v = (a, b, c) @ cell  (rows are lattice vecs)
    return {a * m[0] + b * m[3] + c * m[6],
            a * m[1] + b * m[4] + c * m[7],
            a * m[2] + b * m[5] + c * m[8]};
}

bool invert3(const double* m, double* inv) {
    double a = m[0], b = m[1], c = m[2];
    double d = m[3], e = m[4], f = m[5];
    double g = m[6], h = m[7], i = m[8];
    double det = a * (e * i - f * h) - b * (d * i - f * g)
               + c * (d * h - e * g);
    if (std::fabs(det) < 1e-14) return false;
    double s = 1.0 / det;
    inv[0] = (e * i - f * h) * s; inv[1] = (c * h - b * i) * s;
    inv[2] = (b * f - c * e) * s; inv[3] = (f * g - d * i) * s;
    inv[4] = (a * i - c * g) * s; inv[5] = (c * d - a * f) * s;
    inv[6] = (d * h - e * g) * s; inv[7] = (b * g - a * h) * s;
    inv[8] = (a * e - b * d) * s;
    return true;
}

}  // namespace

extern "C" {

// Returns the number of edges written, or -(required capacity) when
// max_edges is too small (caller reallocates and retries), or -1 on a
// degenerate cell with periodic axes.
long long sevennl_build(
    const double* pos,       // [n, 3]
    long long n,
    const double* cell,      // [3, 3], rows are lattice vectors
    const int* pbc,          // [3]
    double cutoff,
    long long max_edges,
    int* out_i,              // [max_edges]
    int* out_j,
    double* out_shift        // [max_edges, 3]
) {
    if (n == 0) return 0;
    bool any_pbc = pbc[0] || pbc[1] || pbc[2];
    double inv[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    if (any_pbc && !invert3(cell, inv)) return -1;

    // wrap along periodic axes; remember integer offsets
    std::vector<double> wpos(3 * n);
    std::vector<int> wrap(3 * n, 0);
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (long long a = 0; a < n; ++a) {
        const double* p = pos + 3 * a;
        double fx = p[0] * inv[0] + p[1] * inv[3] + p[2] * inv[6];
        double fy = p[0] * inv[1] + p[1] * inv[4] + p[2] * inv[7];
        double fz = p[0] * inv[2] + p[1] * inv[5] + p[2] * inv[8];
        double fr[3] = {fx, fy, fz};
        double w[3];
        for (int k = 0; k < 3; ++k) {
            if (pbc[k]) {
                double fl = std::floor(fr[k]);
                wrap[3 * a + k] = (int)fl;
                fr[k] -= fl;
            }
            w[k] = fr[k];
        }
        V3 c = any_pbc ? matvec(cell, w[0], w[1], w[2])
                       : V3{p[0], p[1], p[2]};
        wpos[3 * a + 0] = c.x;
        wpos[3 * a + 1] = c.y;
        wpos[3 * a + 2] = c.z;
        for (int k = 0; k < 3; ++k) {
            double v = (&c.x)[k];
            if (v < lo[k]) lo[k] = v;
            if (v > hi[k]) hi[k] = v;
        }
    }

    // per-axis image repeats: ceil(cutoff / perpendicular height)
    int reps[3] = {0, 0, 0};
    if (any_pbc) {
        const double* a1 = cell;
        const double* a2 = cell + 3;
        const double* a3 = cell + 6;
        double vol = std::fabs(
            a1[0] * (a2[1] * a3[2] - a2[2] * a3[1])
            - a1[1] * (a2[0] * a3[2] - a2[2] * a3[0])
            + a1[2] * (a2[0] * a3[1] - a2[1] * a3[0]));
        const double* rows[3] = {a1, a2, a3};
        for (int k = 0; k < 3; ++k) {
            if (!pbc[k]) continue;
            const double* u = rows[(k + 1) % 3];
            const double* v = rows[(k + 2) % 3];
            double cx = u[1] * v[2] - u[2] * v[1];
            double cy = u[2] * v[0] - u[0] * v[2];
            double cz = u[0] * v[1] - u[1] * v[0];
            double area = std::sqrt(cx * cx + cy * cy + cz * cz);
            double h = vol / area;
            reps[k] = (int)std::ceil(cutoff / h);
        }
    }

    // build image list: (atom, shift) with positions
    struct Image { double x, y, z; int atom; int sx, sy, sz; };
    std::vector<Image> images;
    long long n_images_per_atom =
        (2LL * reps[0] + 1) * (2LL * reps[1] + 1) * (2LL * reps[2] + 1);
    images.reserve((size_t)(n * n_images_per_atom));
    for (int sx = -reps[0]; sx <= reps[0]; ++sx)
        for (int sy = -reps[1]; sy <= reps[1]; ++sy)
            for (int sz = -reps[2]; sz <= reps[2]; ++sz) {
                V3 off = matvec(cell, sx, sy, sz);
                for (long long a = 0; a < n; ++a) {
                    images.push_back({wpos[3 * a] + off.x,
                                      wpos[3 * a + 1] + off.y,
                                      wpos[3 * a + 2] + off.z,
                                      (int)a, sx, sy, sz});
                }
            }

    // grid over the bounding box of all images, bin side >= cutoff
    double glo[3], ghi[3];
    for (int k = 0; k < 3; ++k) { glo[k] = 1e300; ghi[k] = -1e300; }
    for (const auto& im : images) {
        const double p[3] = {im.x, im.y, im.z};
        for (int k = 0; k < 3; ++k) {
            if (p[k] < glo[k]) glo[k] = p[k];
            if (p[k] > ghi[k]) ghi[k] = p[k];
        }
    }
    double side = cutoff > 1e-6 ? cutoff : 1.0;
    int nb[3];
    for (int k = 0; k < 3; ++k) {
        nb[k] = (int)std::floor((ghi[k] - glo[k]) / side) + 1;
        if (nb[k] < 1) nb[k] = 1;
    }
    auto bin_of = [&](double x, double y, double z) -> long long {
        int bx = (int)((x - glo[0]) / side);
        int by = (int)((y - glo[1]) / side);
        int bz = (int)((z - glo[2]) / side);
        if (bx >= nb[0]) bx = nb[0] - 1;
        if (by >= nb[1]) by = nb[1] - 1;
        if (bz >= nb[2]) bz = nb[2] - 1;
        return ((long long)bx * nb[1] + by) * nb[2] + bz;
    };
    long long nbins = (long long)nb[0] * nb[1] * nb[2];
    std::vector<int> count((size_t)nbins, 0);
    for (const auto& im : images) count[bin_of(im.x, im.y, im.z)]++;
    std::vector<long long> start((size_t)nbins + 1, 0);
    for (long long b = 0; b < nbins; ++b) start[b + 1] = start[b] + count[b];
    std::vector<int> order(images.size());
    {
        std::vector<long long> cur(start.begin(), start.end() - 1);
        for (size_t t = 0; t < images.size(); ++t) {
            long long b = bin_of(images[t].x, images[t].y, images[t].z);
            order[(size_t)cur[b]++] = (int)t;
        }
    }

    const double cut2 = cutoff * cutoff;
    long long n_edges = 0;
    for (long long a = 0; a < n; ++a) {
        double ax = wpos[3 * a], ay = wpos[3 * a + 1], az = wpos[3 * a + 2];
        int bx = (int)((ax - glo[0]) / side);
        int by = (int)((ay - glo[1]) / side);
        int bz = (int)((az - glo[2]) / side);
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    int cx = bx + dx, cy = by + dy, cz = bz + dz;
                    if (cx < 0 || cy < 0 || cz < 0 || cx >= nb[0]
                        || cy >= nb[1] || cz >= nb[2]) continue;
                    long long b = ((long long)cx * nb[1] + cy) * nb[2] + cz;
                    for (long long t = start[b]; t < start[b + 1]; ++t) {
                        const Image& im = images[(size_t)order[t]];
                        double ddx = im.x - ax, ddy = im.y - ay,
                               ddz = im.z - az;
                        double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 >= cut2 || d2 < 1e-16) continue;
                        if (n_edges < max_edges) {
                            out_i[n_edges] = (int)a;
                            out_j[n_edges] = im.atom;
                            // shift in the caller's raw coordinates
                            out_shift[3 * n_edges + 0] =
                                im.sx - wrap[3 * im.atom] + wrap[3 * a];
                            out_shift[3 * n_edges + 1] =
                                im.sy - wrap[3 * im.atom + 1]
                                + wrap[3 * a + 1];
                            out_shift[3 * n_edges + 2] =
                                im.sz - wrap[3 * im.atom + 2]
                                + wrap[3 * a + 2];
                        }
                        ++n_edges;
                    }
                }
    }
    if (n_edges > max_edges) return -n_edges;
    return n_edges;
}

}  // extern "C"
