// Cell-list neighbor build on the card: MD's edge list at cutoff + skin.
//
// Replaces: the host rebuild of VelocityVerlet._device_batch on a CUDA
// calculator -- native/neighborlist.cpp's sevennl_build, then collate's
// sorts and batch_to_torch's copies.  The same algorithm as that core, in
// float64, from the same inputs (the device positions widened from
// float32; the structure's float64 cell):
//
// 1. wrap each atom into the home cell along the periodic axes, keeping
//    the integer wrap offsets (nc_wrap_kernel, which also reduces the
//    bounding box block by block);
// 2. the images over reps = ceil(rc / height) per periodic axis, in the
//    core's order (shift-major, then atom: image t = s * n + a), binned on
//    the core's Cartesian grid of side rc over the images' bounding box
//    (nc_grid_kernel, nc_bin_kernel), counted, scanned (nc_scan_kernel),
//    placed (nc_place_kernel), then ordered inside each bin by image
//    index (nc_order_kernel: an image's slot is its rank among its bin's
//    images), so the placement is stable and every build gives the same
//    bits;
// 3. one warp per home atom over the 27 bins around it, lanes over a
//    bin's images in order, compacting the hits in scan order with
//    __ballot_sync / __popc: a count pass (neighbor_cells_count_kernel),
//    an exclusive scan of the counts whose total goes to status[0], then
//    a fill pass (neighbor_cells_fill_kernel) that writes i, j and the
//    raw-coordinate shift S - wrap[j] + wrap[i] of every pair with
//    1e-16 <= d2 < rc^2.  The edges come grouped by ascending i (the
//    collate contract's order), with no sort.
//
// Every float64 step is rounded as written (__dadd_rn, __dmul_rn, ...):
// the count and fill passes, and the two kernels that place an image,
// must reach the same bits.  The host core's compiler may contract a
// product and a sum into an fma; where that moves a value across a bin
// edge, a wrap or the cutoff, the two builds differ in that pair's place
// or presence (ulps from a boundary; tests/test_torch_neighbor_device.py
// reports the order case by case).
//
// Bound on the H100: launches.  A 6,144-atom rebuild reads 74 KB of
// positions and writes ~7.4 MB of edges (~2 us at 3.35 TB/s); its nine
// kernels are each a few microseconds of latency.
//
// Two C entry points: neighbor_count_f32 (steps 1-3 up to the counts'
// scan; the host then reads status) and neighbor_fill_f32 (the fill
// pass, into edge slots [0, total) of the batch's buffers; the padding
// past them is the wrapper's).  The buffers come as a host array of
// device pointers in the order of `Buf` (ops/neighbor.py's BUFFERS).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kWarps = kThreads / 32;

enum Buf {
  kWpos,      // double [n, 3]: wrapped positions
  kWrap,      // int [n, 3]: wrap offsets
  kPart,      // double [blocks of nc_wrap_kernel, 6]: bounding boxes
  kGridD,     // double [3]: the grid's origin
  kGridI,     // int [4]: bins per axis, bins in all (0 if over bin_cap)
  kBinCount,  // int [bin_cap]: images a bin, then the placement cursor
  kBinStart,  // int [bin_cap + 1]: first slot of each bin
  kImgBin,    // int [n_img]: bin of image t
  kImgTmp,    // int [n_img]: images by bin, in placement order
  kImgId,     // int [n_img]: images by bin, in image order
  kImgXyz,    // double [3, n_img]: their positions
  kAtomCnt,   // int [n]: neighbors a home atom
  kAtomOff,   // int [n + 1]: first edge slot of each home atom
  kStatus,    // long long [2]: edges in all; bins needed past bin_cap
  kNumBufs
};

struct Geom {
  double cell[9];  // rows are lattice vectors
  double inv[9];
  double side;     // bin side: rc (1 for rc <= 1e-6, as the core)
  double cut2;     // rc^2
  int n;
  int n_img;
  int bin_cap;
  int pbc[3];
  int reps[3];
  int any_pbc;
};

__device__ __forceinline__ double inf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// a * m0 + b * m1 + c * m2, each product and sum rounded as written
__device__ __forceinline__ double dot3(double a, double b, double c,
                                       double m0, double m1, double m2) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a, m0), __dmul_rn(b, m1)),
                   __dmul_rn(c, m2));
}

// the lattice shift of shift index s (sx outermost, as the core's loops)
__device__ __forceinline__ void shift_of(const Geom& g, int s, int* sh) {
  const int w1 = 2 * g.reps[1] + 1;
  const int w2 = 2 * g.reps[2] + 1;
  sh[0] = s / (w1 * w2) - g.reps[0];
  sh[1] = (s / w2) % w1 - g.reps[1];
  sh[2] = s % w2 - g.reps[2];
}

// the Cartesian offset of shift (sx, sy, sz): (sx, sy, sz) @ cell
__device__ __forceinline__ double offset(const Geom& g, const int* sh,
                                         int k) {
  return dot3(sh[0], sh[1], sh[2], g.cell[k], g.cell[3 + k], g.cell[6 + k]);
}

// image t's position (wrapped atom t % n plus the offset of shift t / n)
__device__ __forceinline__ void image_pos(const Geom& g,
                                          const double* __restrict__ wpos,
                                          int t, double* x) {
  int sh[3];
  shift_of(g, t / g.n, sh);
  const int a = t % g.n;
  for (int k = 0; k < 3; ++k) {
    x[k] = __dadd_rn(wpos[3 * a + k], offset(g, sh, k));
  }
}

// the bin coordinate of x along axis k (truncated, as the core's cast)
__device__ __forceinline__ int bin_coord(double x, double lo, double side) {
  return static_cast<int>(__ddiv_rn(__dsub_rn(x, lo), side));
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    nc_wrap_kernel(const float* __restrict__ pos, Geom g,
                   double* __restrict__ wpos, int* __restrict__ wrap,
                   double* __restrict__ part) {
  __shared__ double red[6][kWarps];
  const int a = blockIdx.x * kThreads + threadIdx.x;
  double lo[3] = {inf(), inf(), inf()};
  double hi[3] = {-inf(), -inf(), -inf()};
  if (a < g.n) {
    const double p[3] = {static_cast<double>(pos[3 * a]),
                         static_cast<double>(pos[3 * a + 1]),
                         static_cast<double>(pos[3 * a + 2])};
    double w[3] = {p[0], p[1], p[2]};
    int wr[3] = {0, 0, 0};
    if (g.any_pbc) {
      double fr[3];
      for (int k = 0; k < 3; ++k) {
        fr[k] = dot3(p[0], p[1], p[2], g.inv[k], g.inv[3 + k],
                     g.inv[6 + k]);
      }
      for (int k = 0; k < 3; ++k) {
        if (g.pbc[k]) {
          const double fl = floor(fr[k]);
          wr[k] = static_cast<int>(fl);
          fr[k] = __dsub_rn(fr[k], fl);
        }
      }
      for (int k = 0; k < 3; ++k) {
        w[k] = dot3(fr[0], fr[1], fr[2], g.cell[k], g.cell[3 + k],
                    g.cell[6 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      wpos[3 * a + k] = w[k];
      wrap[3 * a + k] = wr[k];
      lo[k] = w[k];
      hi[k] = w[k];
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < 3; ++k) {
    lo[k] = warp_min(lo[k]);
    hi[k] = warp_max(hi[k]);
    if (lane == 0) {
      red[k][warp] = lo[k];
      red[3 + k][warp] = hi[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    double v = red[k][0];
    for (int w = 1; w < kWarps; ++w) {
      v = k < 3 ? fmin(v, red[k][w]) : fmax(v, red[k][w]);
    }
    part[6 * blockIdx.x + k] = v;
  }
}

// one block: the images' bounding box (the atoms' box plus the shifts'
// extreme offsets: rounding is monotone, so min over (s, a) of
// fl(w_a + o_s) is fl(min w + min o)), the grid, the bin counts zeroed
__global__ void __launch_bounds__(kScanThreads)
    nc_grid_kernel(Geom g, const double* __restrict__ part, int n_part,
                   double* __restrict__ grid_d, int* __restrict__ grid_i,
                   int* __restrict__ bin_count,
                   long long* __restrict__ status) {
  __shared__ double red[6][kScanThreads / 32];
  __shared__ int nbins_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double v[6] = {inf(), inf(), inf(), -inf(), -inf(), -inf()};
  for (int b = threadIdx.x; b < n_part; b += kScanThreads) {
    for (int k = 0; k < 3; ++k) {
      v[k] = fmin(v[k], part[6 * b + k]);
      v[3 + k] = fmax(v[3 + k], part[6 * b + 3 + k]);
    }
  }
  for (int k = 0; k < 3; ++k) {
    v[k] = warp_min(v[k]);
    v[3 + k] = warp_max(v[3 + k]);
  }
  if (lane == 0) {
    for (int k = 0; k < 6; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double box[6];
    for (int k = 0; k < 6; ++k) {
      box[k] = red[k][0];
      for (int w = 1; w < kScanThreads / 32; ++w) {
        box[k] = k < 3 ? fmin(box[k], red[k][w]) : fmax(box[k], red[k][w]);
      }
    }
    double olo[3] = {inf(), inf(), inf()};
    double ohi[3] = {-inf(), -inf(), -inf()};
    const int n_shift = g.n_img / g.n;
    for (int s = 0; s < n_shift; ++s) {
      int sh[3];
      shift_of(g, s, sh);
      for (int k = 0; k < 3; ++k) {
        const double o = offset(g, sh, k);
        olo[k] = fmin(olo[k], o);
        ohi[k] = fmax(ohi[k], o);
      }
    }
    long long nbins = 1;
    for (int k = 0; k < 3; ++k) {
      const double glo = __dadd_rn(box[k], olo[k]);
      const double ghi = __dadd_rn(box[3 + k], ohi[k]);
      int nb = static_cast<int>(floor(__ddiv_rn(__dsub_rn(ghi, glo),
                                                g.side))) + 1;
      if (nb < 1) nb = 1;
      grid_d[k] = glo;
      grid_i[k] = nb;
      nbins *= nb;
    }
    const bool over = nbins > g.bin_cap;
    grid_i[3] = over ? 0 : static_cast<int>(nbins);
    status[0] = 0;
    status[1] = over ? nbins : 0;
    nbins_s = over ? 0 : static_cast<int>(nbins);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins_s; b += kScanThreads) bin_count[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
    nc_bin_kernel(Geom g, const double* __restrict__ wpos,
                  const double* __restrict__ grid_d,
                  const int* __restrict__ grid_i, int* __restrict__ img_bin,
                  int* __restrict__ bin_count) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.n_img || grid_i[3] == 0) return;
  double x[3];
  image_pos(g, wpos, t, x);
  int c[3];
  for (int k = 0; k < 3; ++k) {
    c[k] = bin_coord(x[k], grid_d[k], g.side);
    if (c[k] >= grid_i[k]) c[k] = grid_i[k] - 1;
  }
  const int b = (c[0] * grid_i[1] + c[1]) * grid_i[2] + c[2];
  img_bin[t] = b;
  atomicAdd(bin_count + b, 1);
}

// one block: out[i] = in[0] + ... + in[i - 1] for i in [0, len] (len from
// len_dev when given); in[] zeroed behind the read when zero_in; out[len]
// also to *total when given.  Each thread scans a contiguous chunk
__global__ void __launch_bounds__(kScanThreads)
    nc_scan_kernel(int* __restrict__ in, int* __restrict__ out, int len,
                   const int* __restrict__ len_dev, int zero_in,
                   long long* __restrict__ total) {
  __shared__ int warp_sum[kScanThreads / 32];
  if (len_dev != nullptr) len = *len_dev;
  const int chunk = (len + kScanThreads - 1) / kScanThreads;
  const int begin = min(len, static_cast<int>(threadIdx.x) * chunk);
  const int end = min(len, begin + chunk);
  int local = 0;
  for (int i = begin; i < end; ++i) local += in[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += u;
    }
    warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = begin; i < end; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
    if (zero_in) in[i] = 0;
  }
  if (threadIdx.x == kScanThreads - 1) {
    out[len] = warp_sum[kScanThreads / 32 - 1];
    if (total != nullptr) *total = warp_sum[kScanThreads / 32 - 1];
  }
}

__global__ void __launch_bounds__(kThreads)
    nc_place_kernel(Geom g, const int* __restrict__ grid_i,
                    const int* __restrict__ img_bin,
                    const int* __restrict__ bin_start,
                    int* __restrict__ cursor, int* __restrict__ img_tmp) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.n_img || grid_i[3] == 0) return;
  const int b = img_bin[t];
  img_tmp[bin_start[b] + atomicAdd(cursor + b, 1)] = t;
}

// slot p's image goes to its bin's start plus its rank among the bin's
// images by index, with its position
__global__ void __launch_bounds__(kThreads)
    nc_order_kernel(Geom g, const double* __restrict__ wpos,
                    const int* __restrict__ grid_i,
                    const int* __restrict__ img_bin,
                    const int* __restrict__ bin_start,
                    const int* __restrict__ img_tmp, int* __restrict__ img_id,
                    double* __restrict__ img_xyz) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= g.n_img || grid_i[3] == 0) return;
  const int t = img_tmp[p];
  const int b = img_bin[t];
  const int lo = bin_start[b];
  const int hi = bin_start[b + 1];
  int rank = 0;
  for (int q = lo; q < hi; ++q) rank += img_tmp[q] < t;
  const int dst = lo + rank;
  img_id[dst] = t;
  double x[3];
  image_pos(g, wpos, t, x);
  for (int k = 0; k < 3; ++k) img_xyz[k * g.n_img + dst] = x[k];
}

// one warp's walk of home atom a over the 27 bins around it: the hits
// counted, and with kFill written from slot `base` on, in scan order
template <bool kFill>
__device__ __forceinline__ int walk_atom(
    const Geom& g, int a, const double* __restrict__ wpos,
    const int* __restrict__ wrap, const double* __restrict__ grid_d,
    const int* __restrict__ grid_i, const int* __restrict__ bin_start,
    const int* __restrict__ img_id, const double* __restrict__ img_xyz,
    int base, int* __restrict__ edge_idx, float* __restrict__ shift,
    int cap) {
  const int lane = threadIdx.x & 31;
  const int nb[3] = {grid_i[0], grid_i[1], grid_i[2]};
  const double ax = wpos[3 * a];
  const double ay = wpos[3 * a + 1];
  const double az = wpos[3 * a + 2];
  // the home atom's bin, not clamped (the core's)
  const int bx = bin_coord(ax, grid_d[0], g.side);
  const int by = bin_coord(ay, grid_d[1], g.side);
  const int bz = bin_coord(az, grid_d[2], g.side);
  const double* ix = img_xyz;
  const double* iy = img_xyz + g.n_img;
  const double* iz = img_xyz + 2 * g.n_img;
  int found = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const int cx = bx + dx;
        const int cy = by + dy;
        const int cz = bz + dz;
        if (cx < 0 || cy < 0 || cz < 0 || cx >= nb[0] || cy >= nb[1] ||
            cz >= nb[2]) {
          continue;
        }
        const int b = (cx * nb[1] + cy) * nb[2] + cz;
        const int lo = bin_start[b];
        const int hi = bin_start[b + 1];
        for (int q0 = lo; q0 < hi; q0 += 32) {
          const int q = q0 + lane;
          bool hit = false;
          if (q < hi) {
            const double ddx = __dsub_rn(ix[q], ax);
            const double ddy = __dsub_rn(iy[q], ay);
            const double ddz = __dsub_rn(iz[q], az);
            const double d2 = __dadd_rn(
                __dadd_rn(__dmul_rn(ddx, ddx), __dmul_rn(ddy, ddy)),
                __dmul_rn(ddz, ddz));
            hit = !(d2 >= g.cut2 || d2 < 1e-16);
          }
          const unsigned m = __ballot_sync(~0u, hit);
          if (kFill && hit) {
            const int e = base + found + __popc(m & ((1u << lane) - 1u));
            if (e < cap) {
              const int t = img_id[q];
              const int j = t % g.n;
              int sh[3];
              shift_of(g, t / g.n, sh);
              edge_idx[e] = a;
              edge_idx[cap + e] = j;
              for (int k = 0; k < 3; ++k) {
                shift[3 * e + k] = static_cast<float>(
                    sh[k] - wrap[3 * j + k] + wrap[3 * a + k]);
              }
            }
          }
          found += __popc(m);
        }
      }
    }
  }
  return found;
}

__global__ void __launch_bounds__(kThreads) neighbor_cells_count_kernel(
    Geom g, const double* __restrict__ wpos, const int* __restrict__ wrap,
    const double* __restrict__ grid_d, const int* __restrict__ grid_i,
    const int* __restrict__ bin_start, const int* __restrict__ img_id,
    const double* __restrict__ img_xyz, int* __restrict__ atom_cnt) {
  const int a = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (a >= g.n) return;
  int found = 0;
  if (grid_i[3] != 0) {
    found = walk_atom<false>(g, a, wpos, wrap, grid_d, grid_i, bin_start,
                             img_id, img_xyz, 0, nullptr, nullptr, 0);
  }
  if ((threadIdx.x & 31) == 0) atom_cnt[a] = found;
}

__global__ void __launch_bounds__(kThreads) neighbor_cells_fill_kernel(
    Geom g, const double* __restrict__ wpos, const int* __restrict__ wrap,
    const double* __restrict__ grid_d, const int* __restrict__ grid_i,
    const int* __restrict__ bin_start, const int* __restrict__ img_id,
    const double* __restrict__ img_xyz, const int* __restrict__ atom_off,
    int* __restrict__ edge_idx, float* __restrict__ shift, int cap) {
  const int a = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (a >= g.n || grid_i[3] == 0) return;
  walk_atom<true>(g, a, wpos, wrap, grid_d, grid_i, bin_start, img_id,
                  img_xyz, atom_off[a], edge_idx, shift, cap);
}

bool make_geom(const double* geom, const int* dims, Geom* g) {
  for (int k = 0; k < 9; ++k) {
    g->cell[k] = geom[k];
    g->inv[k] = geom[9 + k];
  }
  g->side = geom[18];
  g->cut2 = geom[19];
  g->n = dims[0];
  g->n_img = dims[1];
  g->bin_cap = dims[2];
  g->any_pbc = 0;
  for (int k = 0; k < 3; ++k) {
    g->pbc[k] = dims[3 + k];
    g->reps[k] = dims[6 + k];
    g->any_pbc |= g->pbc[k] != 0;
  }
  return g->n > 0 && g->n_img >= g->n && g->n_img % g->n == 0 &&
         g->bin_cap > 0;
}

int blocks(long long n, int per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

}  // namespace

// geom: host [cell 9, inv 9, side, cut2]; dims: host [n, n_img, bin_cap,
// pbc 3, reps 3].  status[0] = the edges in all, status[1] = the bins the
// grid needs when they pass bin_cap (then nothing is counted)
extern "C" int neighbor_count_f32(const float* pos, void* const* bufs,
                                  const double* geom, const int* dims,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  if (!make_geom(geom, dims, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  double* wpos = static_cast<double*>(bufs[kWpos]);
  int* wrap = static_cast<int*>(bufs[kWrap]);
  double* part = static_cast<double*>(bufs[kPart]);
  double* grid_d = static_cast<double*>(bufs[kGridD]);
  int* grid_i = static_cast<int*>(bufs[kGridI]);
  int* bin_count = static_cast<int*>(bufs[kBinCount]);
  int* bin_start = static_cast<int*>(bufs[kBinStart]);
  int* img_bin = static_cast<int*>(bufs[kImgBin]);
  int* img_tmp = static_cast<int*>(bufs[kImgTmp]);
  int* img_id = static_cast<int*>(bufs[kImgId]);
  double* img_xyz = static_cast<double*>(bufs[kImgXyz]);
  int* atom_cnt = static_cast<int*>(bufs[kAtomCnt]);
  int* atom_off = static_cast<int*>(bufs[kAtomOff]);
  long long* status = static_cast<long long*>(bufs[kStatus]);
  const int n_part = blocks(g.n, kThreads);
  const int img_blocks = blocks(g.n_img, kThreads);
  nc_wrap_kernel<<<n_part, kThreads, 0, s>>>(pos, g, wpos, wrap, part);
  nc_grid_kernel<<<1, kScanThreads, 0, s>>>(g, part, n_part, grid_d, grid_i,
                                            bin_count, status);
  nc_bin_kernel<<<img_blocks, kThreads, 0, s>>>(g, wpos, grid_d, grid_i,
                                                img_bin, bin_count);
  nc_scan_kernel<<<1, kScanThreads, 0, s>>>(bin_count, bin_start, 0,
                                            grid_i + 3, 1, nullptr);
  nc_place_kernel<<<img_blocks, kThreads, 0, s>>>(g, grid_i, img_bin,
                                                  bin_start, bin_count,
                                                  img_tmp);
  nc_order_kernel<<<img_blocks, kThreads, 0, s>>>(
      g, wpos, grid_i, img_bin, bin_start, img_tmp, img_id, img_xyz);
  neighbor_cells_count_kernel<<<blocks(g.n, kWarps), kThreads, 0, s>>>(
      g, wpos, wrap, grid_d, grid_i, bin_start, img_id, img_xyz, atom_cnt);
  nc_scan_kernel<<<1, kScanThreads, 0, s>>>(atom_cnt, atom_off, g.n, nullptr,
                                            0, status);
  return static_cast<int>(cudaGetLastError());
}

// the fill pass after neighbor_count_f32 (same bufs, geom and dims):
// edge_idx [2, cap] int32 and shift [cap, 3] float32, slots [0, total)
extern "C" int neighbor_fill_f32(void* const* bufs, const double* geom,
                                 const int* dims, int* edge_idx,
                                 float* shift, int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  if (!make_geom(geom, dims, &g) || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  neighbor_cells_fill_kernel<<<blocks(g.n, kWarps), kThreads, 0, s>>>(
      g, static_cast<const double*>(bufs[kWpos]),
      static_cast<const int*>(bufs[kWrap]),
      static_cast<const double*>(bufs[kGridD]),
      static_cast<const int*>(bufs[kGridI]),
      static_cast<const int*>(bufs[kBinStart]),
      static_cast<const int*>(bufs[kImgId]),
      static_cast<const double*>(bufs[kImgXyz]),
      static_cast<const int*>(bufs[kAtomOff]), edge_idx, shift, cap);
  return static_cast<int>(cudaGetLastError());
}
