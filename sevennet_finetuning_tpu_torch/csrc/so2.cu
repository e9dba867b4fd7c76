// The edge frame of the 'equiformer_v2' family (ops/so2.py): the per-edge
// rotation by the Wigner-D rows of the edge, its gradient in D, and the
// separable S2 activation's grid round trip.  Replaces no TPU kernel: the
// JAX package has no such family.
//
// D [E, K, d] holds K m-major rows of a block-diagonal Wigner-D matrix
// (d = (lmax + 1)^2, lmax <= 5): row k of degree l is non-zero only in the
// 2l + 1 columns l^2..(l+1)^2 - 1, every other entry an exact zero (115 of
// 475 entries at lmax 4, mmax 2).  The wrapper passes each row's column
// span; the host turns the spans into a Frame (the rows of each degree and
// the packed support), a by-value launch argument.  The kernels touch only
// the support: a zero's multiply-add leaves a sum as it was, so no value
// changes.
//
// so2_rotate_f32: y[e, k, c] = sum_{i in span(k)} D[e, k, i] x[row(e), i,
//   c] (transpose = 0), or y[e, i, c] = sum_{k: i in span(k)} D[e, k, i]
//   x[row(e), k, c] (transpose = 1); row(e) = idx ? idx[e] : e.  One or
//   two legs (the source and the target) share D and one launch.  Bound:
//   the bytes of x and y (about 3 FLOPs a byte, against the card's 20).
//   A warp an edge, 8 edges a block and no block-wide barrier
//   but the one after the support's offsets are staged: the warp copies
//   its edge's support into its own slice of shared memory (all loads
//   issued before one __syncwarp), then each lane takes four channels as a
//   float4 (one scalar where the channels or strides are not a multiple of
//   4) and walks the degrees, issuing a degree's 2l + 1 row loads before
//   its multiply-adds.  The sums run in the order of the dense loop (over
//   i, or k, ascending).
// so2_rotate_grad_f32: out[e, k, i] (+)= sum_legs sum_c A[rowA(e), k, c]
//   B[rowB(e), i, c] for i in span(k); 0 elsewhere (those are cotangents of
//   D's structural zeros, which edge_rotation's backward multiplies by
//   zeros).  A warp an edge, a lane four channels: each lane's partial
//   products of up to 32 support entries at a time (a chunk of one
//   degree's rows) are summed over the warp by a butterfly that halves the
//   entries at each step (31 shuffles for 32 entries), in a fixed order
//   and with no atomics; the sums gather in the warp's dense [K, d] slice
//   of shared memory, written out coalesced.  Bound: the bytes of A, B
//   and out.
// s2_act_f32 / s2_act_bwd_f32: for each (row, channel) of x [R, K, C]:
//   g_p = sum_k T[p, k] x_k, y_k = sum_p F[p, k] silu(g_p); the backward
//   recomputes g_p and gives dx_k = sum_p T[p, k] silu'(g_p) sum_k' F[p,
//   k'] dy_k'.  A thread a (row, channel), K a template parameter (19,
//   25); T and F (P x K, rows padded to a multiple of 4) read as float4
//   through the read-only cache, the same address for every thread of a
//   warp.  Bound: FP32 FMAs (about 2 K P a channel forward,
//   3 K P backward) and one exp a grid point.
// Every entry point launches on the given stream and returns
// cudaGetLastError().
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDeg = 5;                          // lmax <= 5
constexpr int kMaxRows = (kMaxDeg + 1) * (kMaxDeg + 1);
constexpr int kMaxSupport = 286;                    // sum_l (2l + 1)^2
constexpr int kStage = (kMaxSupport + 31) / 32;     // support loads a lane
constexpr int kEdgeWarps = 8;                       // edges a block
constexpr int kRowChunk = 5;  // rows of a degree held at once in D^T x

// D's degree blocks, from the rows' spans: the rows of each degree in
// order, and the support packed degree by degree, row by row
struct Frame {
  int lmax, rows, d, n_sup;
  unsigned char n_deg[kMaxDeg + 1];                    // rows of degree l
  unsigned char row_of[kMaxDeg + 1][2 * kMaxDeg + 1];  // their indices
  unsigned short base[kMaxDeg + 1];  // first packed entry of degree l
  unsigned short at[kMaxSupport];    // packed entry -> k d + l^2 + j
};

// 0 or -1: the spans (first column, count) of `rows` rows must each be a
// degree's block of d = (lmax + 1)^2 columns, at most 2l + 1 rows a degree
int make_frame(const int* spans, int rows, int d, Frame* f) {
  std::memset(f, 0, sizeof(Frame));
  int lmax = 0;
  while ((lmax + 1) * (lmax + 1) < d) ++lmax;
  if ((lmax + 1) * (lmax + 1) != d || lmax > kMaxDeg || rows < 1 ||
      rows > kMaxRows)
    return -1;
  f->lmax = lmax;
  f->rows = rows;
  f->d = d;
  for (int k = 0; k < rows; ++k) {
    const int first = spans[2 * k], count = spans[2 * k + 1];
    const int l = (count - 1) / 2;
    if (count < 1 || count != 2 * l + 1 || first != l * l || l > lmax ||
        f->n_deg[l] >= 2 * l + 1)
      return -1;
    f->row_of[l][f->n_deg[l]++] = (unsigned char)k;
  }
  int p = 0;
  for (int l = 0; l <= kMaxDeg; ++l) {
    f->base[l] = (unsigned short)p;
    for (int r = 0; r < f->n_deg[l]; ++r)
      for (int j = 0; j < 2 * l + 1; ++j)
        f->at[p++] = (unsigned short)(f->row_of[l][r] * d + l * l + j);
  }
  f->n_sup = p;
  return 0;
}

template <int V>
struct Vec {
  float a[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vload(const float* __restrict__ p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.a[0] = t.x;
    r.a[1] = t.y;
    r.a[2] = t.z;
    r.a[3] = t.w;
  } else {
    r.a[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(float* __restrict__ p,
                                       const Vec<V>& v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v.a[0], v.a[1], v.a[2],
                                                v.a[3]);
  else
    *p = v.a[0];
}

// the packed support's offsets into the block's shared memory (the one
// block-wide barrier)
__device__ __forceinline__ void load_offsets(const Frame& f,
                                             unsigned short* off) {
  for (int t = threadIdx.x; t < f.n_sup; t += blockDim.x) off[t] = f.at[t];
  __syncthreads();
}

// one degree of y = D x (T = false) or y = D^T x (T = true) at a lane's
// channels c..c+V-1; Dl: the degree's packed rows
template <int L, int V, bool T>
__device__ __forceinline__ void rotate_degree(const Frame& f,
                                              const float* Ds,
                                              const float* __restrict__ xe,
                                              int x_r, float* __restrict__ ye,
                                              int y_r, int c) {
  if (L > f.lmax) return;
  constexpr int W = 2 * L + 1;
  const int nr = f.n_deg[L];
  const float* Dl = Ds + f.base[L];
  if constexpr (!T) {
    if (nr == 0) return;
    Vec<V> xv[W];
#pragma unroll
    for (int j = 0; j < W; ++j) xv[j] = vload<V>(xe + (L * L + j) * x_r + c);
    for (int r = 0; r < nr; ++r) {
      Vec<V> acc;
#pragma unroll
      for (int q = 0; q < V; ++q) acc.a[q] = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float w = Dl[r * W + j];
#pragma unroll
        for (int q = 0; q < V; ++q) acc.a[q] = fmaf(w, xv[j].a[q], acc.a[q]);
      }
      vstore<V>(ye + f.row_of[L][r] * y_r + c, acc);
    }
  } else {
    constexpr int RT = W < kRowChunk ? W : kRowChunk;
    Vec<V> acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j].a[q] = 0.f;
    for (int r0 = 0; r0 < nr; r0 += RT) {
      Vec<V> xv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r0 + r < nr)
          xv[r] = vload<V>(xe + f.row_of[L][r0 + r] * x_r + c);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r0 + r < nr) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const float w = Dl[(r0 + r) * W + j];
#pragma unroll
            for (int q = 0; q < V; ++q)
              acc[j].a[q] = fmaf(w, xv[r].a[q], acc[j].a[q]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) vstore<V>(ye + (L * L + j) * y_r + c, acc[j]);
  }
}

// LM: the largest degree the kernel unrolls (4, or 5 for lmax 5), which
// sizes its registers
template <int V, bool T, int LM>
__global__ void __launch_bounds__(32 * kEdgeWarps)
    so2_rotate_kernel(const __grid_constant__ Frame f,
                      const float* __restrict__ D, int d_e,
                      const float* __restrict__ x0,
                      const float* __restrict__ x1,
                      const int* __restrict__ idx0,
                      const int* __restrict__ idx1, int x_e, int x_r,
                      float* __restrict__ y0, float* __restrict__ y1,
                      int y_e, int y_r, int E, int C, int legs) {
  __shared__ unsigned short off[kMaxSupport];
  extern __shared__ float support[];
  load_offsets(f, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kEdgeWarps + warp;
  if (e >= E) return;
  // the edge's support into the warp's slice, every load in flight first
  float* Ds = support + warp * f.n_sup;
  const float* De = D + (long long)e * d_e;
  float v[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int p = lane + 32 * q;
    v[q] = p < f.n_sup ? __ldg(De + off[p]) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kStage; ++q)
    if (lane + 32 * q < f.n_sup) Ds[lane + 32 * q] = v[q];
  __syncwarp();
  for (int leg = 0; leg < legs; ++leg) {
    const int* idx = leg ? idx1 : idx0;
    const float* xe =
        (leg ? x1 : x0) + (idx ? (long long)idx[e] : (long long)e) * x_e;
    float* ye = (leg ? y1 : y0) + (long long)e * y_e;
    for (int c = lane * V; c < C; c += 32 * V) {
      rotate_degree<0, V, T>(f, Ds, xe, x_r, ye, y_r, c);
      rotate_degree<1, V, T>(f, Ds, xe, x_r, ye, y_r, c);
      rotate_degree<2, V, T>(f, Ds, xe, x_r, ye, y_r, c);
      rotate_degree<3, V, T>(f, Ds, xe, x_r, ye, y_r, c);
      rotate_degree<4, V, T>(f, Ds, xe, x_r, ye, y_r, c);
      if constexpr (LM > 4)
        rotate_degree<5, V, T>(f, Ds, xe, x_r, ye, y_r, c);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ constexpr int log2_of(int p) {
  int s = 0;
  while ((1 << s) < p) ++s;
  return s;
}

// Sum N (a power of two, <= 32) values over the warp: while more than one
// is left, each step at offset O keeps one half (the upper where the
// lane's bit O is set) and adds the partner's copy of it, then plain
// butterfly steps.  Entry q ends in the lanes q << (5 - log2 N) onwards,
// summed in one fixed order.
template <int N, int O>
__device__ __forceinline__ void warp_sum_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_sum_scatter<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_sum_scatter<1, O / 2>(v, lane);
    }
  }
}

// one degree of D's cotangent for one leg: the degree's rows in chunks of
// RC (at most 32 entries), each chunk's sums added into the warp's slice R
template <int L, int V>
__device__ __forceinline__ void grad_degree(
    const Frame& f, const unsigned short* off, float* R,
    const float* __restrict__ Ae, int a_r, const float* __restrict__ Be,
    int b_r, int C, int lane) {
  if (L > f.lmax) return;
  constexpr int W = 2 * L + 1;
  constexpr int RC = W < 32 / W ? W : 32 / W;
  constexpr int N = RC * W;
  constexpr int P = pow2_at_least(N);
  constexpr int S = 5 - log2_of(P);
  const int nr = f.n_deg[L];
  for (int r0 = 0; r0 < nr; r0 += RC) {
    float v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32 * V) {
      const int c = c0 + lane * V;
      const bool on = c < C;
      Vec<V> b[W], a[RC];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (on) {
          b[j] = vload<V>(Be + (L * L + j) * b_r + c);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) b[j].a[q] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (on && r0 + r < nr) {
          a[r] = vload<V>(Ae + f.row_of[L][r0 + r] * a_r + c);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) a[r].a[q] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int j = 0; j < W; ++j)
#pragma unroll
          for (int q = 0; q < V; ++q)
            v[r * W + j] = fmaf(a[r].a[q], b[j].a[q], v[r * W + j]);
    }
    warp_sum_scatter<P, 16>(v, lane);
    const int q = lane >> S;
    if ((lane & ((1 << S) - 1)) == 0 && q < N && r0 + q / W < nr)
      R[off[f.base[L] + r0 * W + q]] += v[0];
  }
}

template <int V, int LM>
__global__ void __launch_bounds__(32 * kEdgeWarps)
    so2_rotate_grad_kernel(const __grid_constant__ Frame f,
                           const float* __restrict__ A0,
                           const float* __restrict__ A1,
                           const int* __restrict__ ia0,
                           const int* __restrict__ ia1, int a_e, int a_r,
                           const float* __restrict__ B0,
                           const float* __restrict__ B1,
                           const int* __restrict__ ib0,
                           const int* __restrict__ ib1, int b_e, int b_r,
                           float* __restrict__ out, int out_e, int E, int C,
                           int legs, int accumulate) {
  __shared__ unsigned short off[kMaxSupport];
  extern __shared__ float slices[];
  load_offsets(f, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kEdgeWarps + warp;
  if (e >= E) return;
  const int n = f.rows * f.d;
  float* R = slices + warp * n;
  for (int t = lane; t < n; t += 32) R[t] = 0.f;
  __syncwarp();
  for (int leg = 0; leg < legs; ++leg) {
    const int* ia = leg ? ia1 : ia0;
    const int* ib = leg ? ib1 : ib0;
    const float* Ae =
        (leg ? A1 : A0) + (ia ? (long long)ia[e] : (long long)e) * a_e;
    const float* Be =
        (leg ? B1 : B0) + (ib ? (long long)ib[e] : (long long)e) * b_e;
    grad_degree<0, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
    grad_degree<1, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
    grad_degree<2, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
    grad_degree<3, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
    grad_degree<4, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
    if constexpr (LM > 4)
      grad_degree<5, V>(f, off, R, Ae, a_r, Be, b_r, C, lane);
  }
  __syncwarp();
  float* oe = out + (long long)e * out_e;
  for (int t = lane; t < n; t += 32)
    oe[t] = accumulate ? oe[t] + R[t] : R[t];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float sigmoidf_(float g) {
  return 1.f / (1.f + __expf(-g));
}

// KP: K rounded up to a multiple of 4 (float4 rows of T and F)
template <int K>
struct Grid {
  static constexpr int KP = (K + 3) / 4 * 4;
  __device__ static void row(const float* __restrict__ base, int p,
                             float* out) {
    const float4* r = reinterpret_cast<const float4*>(base + p * KP);
#pragma unroll
    for (int q = 0; q < KP / 4; ++q) {
      const float4 v = __ldg(r + q);
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  }
};

// x, y: [R, K, C] contiguous, C even; T, F: [P, KP].  A thread two
// channels, c and c + C/2, of one row: each row of T and F read serves
// both, and the two dot products run as four independent chains.
template <int K>
__global__ void s2_act_kernel(const float* __restrict__ x,
                              const float* __restrict__ T,
                              const float* __restrict__ F,
                              float* __restrict__ y, long long rows, int C,
                              int P) {
  constexpr int KP = Grid<K>::KP;
  const int H = C / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * H) return;
  const long long r = t / H;
  const int c = (int)(t % H);
  const float* xr = x + r * K * C + c;
  float xa[K], xb[K], aa[K], ab[K], tr[KP], fr[KP];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xa[k] = xr[k * C];
    xb[k] = xr[k * C + H];
    aa[k] = 0.f;
    ab[k] = 0.f;
  }
  for (int p = 0; p < P; ++p) {
    Grid<K>::row(T, p, tr);
    Grid<K>::row(F, p, fr);
    float g0 = 0.f, g1 = 0.f, h0 = 0.f, h1 = 0.f;
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      g0 = fmaf(tr[k], xa[k], g0);
      h0 = fmaf(tr[k], xb[k], h0);
      if (k + 1 < K) {
        g1 = fmaf(tr[k + 1], xa[k + 1], g1);
        h1 = fmaf(tr[k + 1], xb[k + 1], h1);
      }
    }
    const float ga = g0 + g1, gb = h0 + h1;
    const float sa = ga * sigmoidf_(ga), sb = gb * sigmoidf_(gb);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      aa[k] = fmaf(fr[k], sa, aa[k]);
      ab[k] = fmaf(fr[k], sb, ab[k]);
    }
  }
  float* yr = y + r * K * C + c;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    yr[k * C] = aa[k];
    yr[k * C + H] = ab[k];
  }
}

// a thread one (row, channel); the two dot products in two chains each
template <int K>
__global__ void s2_act_bwd_kernel(const float* __restrict__ x,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ T,
                                  const float* __restrict__ F,
                                  float* __restrict__ dx, long long rows,
                                  int C, int P) {
  constexpr int KP = Grid<K>::KP;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * C) return;
  const long long r = t / C;
  const int c = (int)(t % C);
  const float* xr = x + r * K * C + c;
  const float* dr = dy + r * K * C + c;
  float xv[K], dv[K], acc[K], tr[KP], fr[KP];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xv[k] = xr[k * C];
    dv[k] = dr[k * C];
    acc[k] = 0.f;
  }
  for (int p = 0; p < P; ++p) {
    Grid<K>::row(T, p, tr);
    Grid<K>::row(F, p, fr);
    float g0 = 0.f, g1 = 0.f, h0 = 0.f, h1 = 0.f;
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      g0 = fmaf(tr[k], xv[k], g0);
      h0 = fmaf(fr[k], dv[k], h0);
      if (k + 1 < K) {
        g1 = fmaf(tr[k + 1], xv[k + 1], g1);
        h1 = fmaf(fr[k + 1], dv[k + 1], h1);
      }
    }
    const float g = g0 + g1, h = h0 + h1;
    const float s = sigmoidf_(g);
    const float q = h * s * (1.f + g * (1.f - s));
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmaf(tr[k], q, acc[k]);
  }
  float* out = dx + r * K * C + c;
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * C] = acc[k];
}

}  // namespace

// spans: host ints, (first column, count) of each of D's `rows` rows;
// legs 1 or 2 (x1, idx1, y1 read only for 2); float4 channels where C,
// the strides and the pointers allow
extern "C" int so2_rotate_f32(const float* D, int d_e, const int* spans,
                              int rows, int d, const float* x0,
                              const float* x1, const int* idx0,
                              const int* idx1, int x_e, int x_r, float* y0,
                              float* y1, int y_e, int y_r, int E, int C,
                              int transpose, int legs, void* stream) {
  if (E <= 0) return 0;
  Frame f;
  if (make_frame(spans, rows, d, &f) != 0 || C < 1 || legs < 1 || legs > 2)
    return cudaErrorInvalidValue;
  const bool v4 = C % 4 == 0 && x_e % 4 == 0 && x_r % 4 == 0 &&
                  y_e % 4 == 0 && y_r % 4 == 0 && aligned16(x0) &&
                  aligned16(y0) && (legs < 2 || (aligned16(x1) &&
                                                 aligned16(y1)));
  const unsigned blocks = (unsigned)((E + kEdgeWarps - 1) / kEdgeWarps);
  const size_t smem = sizeof(float) * kEdgeWarps * f.n_sup;
  cudaStream_t s = (cudaStream_t)stream;
#define SO2_ROTATE(V, T, LM)                                               \
  so2_rotate_kernel<V, T, LM><<<blocks, 32 * kEdgeWarps, smem, s>>>(      \
      f, D, d_e, x0, x1, idx0, idx1, x_e, x_r, y0, y1, y_e, y_r, E, C, legs)
#define SO2_ROTATE_LM(V, T) \
  if (f.lmax > 4)           \
    SO2_ROTATE(V, T, 5);    \
  else                      \
    SO2_ROTATE(V, T, 4)
  if (v4 && transpose) {
    SO2_ROTATE_LM(4, true);
  } else if (v4) {
    SO2_ROTATE_LM(4, false);
  } else if (transpose) {
    SO2_ROTATE_LM(1, true);
  } else {
    SO2_ROTATE_LM(1, false);
  }
#undef SO2_ROTATE_LM
#undef SO2_ROTATE
  return (int)cudaGetLastError();
}

// out [E, rows, d] rows of out_e floats; A rows of D's rows, B of its
// columns; legs as so2_rotate_f32's
extern "C" int so2_rotate_grad_f32(const int* spans, int rows, int d,
                                   const float* A0, const float* A1,
                                   const int* ia0, const int* ia1, int a_e,
                                   int a_r, const float* B0, const float* B1,
                                   const int* ib0, const int* ib1, int b_e,
                                   int b_r, float* out, int out_e, int E,
                                   int C, int legs, int accumulate,
                                   void* stream) {
  if (E <= 0) return 0;
  Frame f;
  if (make_frame(spans, rows, d, &f) != 0 || C < 1 || legs < 1 || legs > 2)
    return cudaErrorInvalidValue;
  const bool v4 = C % 4 == 0 && a_e % 4 == 0 && a_r % 4 == 0 &&
                  b_e % 4 == 0 && b_r % 4 == 0 && aligned16(A0) &&
                  aligned16(B0) && (legs < 2 || (aligned16(A1) &&
                                                 aligned16(B1)));
  const unsigned blocks = (unsigned)((E + kEdgeWarps - 1) / kEdgeWarps);
  const size_t smem = sizeof(float) * kEdgeWarps * rows * d;
  cudaStream_t s = (cudaStream_t)stream;
#define SO2_GRAD(V, LM)                                                    \
  so2_rotate_grad_kernel<V, LM><<<blocks, 32 * kEdgeWarps, smem, s>>>(    \
      f, A0, A1, ia0, ia1, a_e, a_r, B0, B1, ib0, ib1, b_e, b_r, out, out_e, \
      E, C, legs, accumulate)
  if (v4 && f.lmax > 4)
    SO2_GRAD(4, 5);
  else if (v4)
    SO2_GRAD(4, 4);
  else if (f.lmax > 4)
    SO2_GRAD(1, 5);
  else
    SO2_GRAD(1, 4);
#undef SO2_GRAD
  return (int)cudaGetLastError();
}

// K (the kept coefficients) is a template parameter: 19 (lmax 4, mmax 2)
// or 25 (lmax 4); T and F rows padded to a multiple of 4 floats
extern "C" int s2_act_f32(const float* x, const float* T, const float* F,
                          float* y, int rows, int K, int C, int P,
                          void* stream) {
  if (rows <= 0) return 0;
  if (C % 2) return cudaErrorInvalidValue;
  const long long n = (long long)rows * (C / 2);
  const unsigned blocks = (unsigned)((n + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 19)
    s2_act_kernel<19><<<blocks, 128, 0, s>>>(x, T, F, y, rows, C, P);
  else if (K == 25)
    s2_act_kernel<25><<<blocks, 128, 0, s>>>(x, T, F, y, rows, C, P);
  else
    return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int s2_act_bwd_f32(const float* x, const float* dy,
                              const float* T, const float* F, float* dx,
                              int rows, int K, int C, int P, void* stream) {
  if (rows <= 0) return 0;
  const long long n = (long long)rows * C;
  const unsigned blocks = (unsigned)((n + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 19)
    s2_act_bwd_kernel<19><<<blocks, 128, 0, s>>>(x, dy, T, F, dx, rows, C,
                                                 P);
  else if (K == 25)
    s2_act_bwd_kernel<25><<<blocks, 128, 0, s>>>(x, dy, T, F, dx, rows, C,
                                                 P);
  else
    return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

