// The edge frame of the 'equiformer_v2' family (ops/so2.py): the per-edge
// rotation by the Wigner-D rows of the edge, its gradient in D, and the
// separable S2 activation's grid round trip.  Replaces no TPU kernel: the
// JAX package has no such family.  cuBLAS runs these as batched GEMMs of
// 19 x 25 by 25 x C per edge, or as GEMMs of depth 19 over every (edge,
// channel) row, far below the card's bandwidth; here they are plain
// memory- and FMA-bound loops.
//
// so2_rotate_f32: y[e, o, c] = sum_i D[e, o, i] x[row(e), i, c]
//   (transpose = 0; D rows of n_in) or sum_i D[e, i, o] x[row(e), i, c]
//   (transpose = 1; D rows of n_out), row(e) = idx ? idx[e] : e.  A block
//   an edge, a thread a channel, the n_out sums in registers, D in shared
//   memory.  Bound: the bytes of x and y (a few FLOPs a byte).
// so2_rotate_grad_f32: out[e, a, b] (+)= sum_c A[rowA(e), a, c]
//   B[rowB(e), b, c].  A block an edge, a thread an (a, b) pair, the rows
//   staged through shared memory 64 channels at a time.
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
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 36;   // (lmax + 1)^2 for lmax <= 5
constexpr int kTile = 64;      // channels a shared-memory tile

__global__ void rotate_kernel(const float* __restrict__ D, int d_e,
                              const float* __restrict__ x,
                              const int* __restrict__ idx, int x_e, int x_r,
                              float* __restrict__ y, int y_e, int y_r,
                              int n_in, int n_out, int C, int transpose) {
  __shared__ float Ds[kMaxRows * kMaxRows];
  const int e = blockIdx.x;
  const float* De = D + (long long)e * d_e;
  for (int t = threadIdx.x; t < n_in * n_out; t += blockDim.x) {
    // Ds[o * n_in + i]
    int o = t / n_in, i = t % n_in;
    Ds[t] = transpose ? De[i * n_out + o] : De[o * n_in + i];
  }
  __syncthreads();
  const long long row = idx ? (long long)idx[e] : (long long)e;
  const float* xe = x + row * x_e;
  float* ye = y + (long long)e * y_e;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[kMaxRows];
#pragma unroll
    for (int o = 0; o < kMaxRows; ++o) acc[o] = 0.f;
    for (int i = 0; i < n_in; ++i) {
      const float v = xe[i * x_r + c];
#pragma unroll
      for (int o = 0; o < kMaxRows; ++o)
        if (o < n_out) acc[o] = fmaf(Ds[o * n_in + i], v, acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kMaxRows; ++o)
      if (o < n_out) ye[o * y_r + c] = acc[o];
  }
}

__global__ void rotate_grad_kernel(const float* __restrict__ A,
                                   const int* __restrict__ ia, int a_e,
                                   int a_r, int na,
                                   const float* __restrict__ B,
                                   const int* __restrict__ ib, int b_e,
                                   int b_r, int nb, float* __restrict__ out,
                                   int out_e, int C, int accumulate) {
  __shared__ float As[kMaxRows * (kTile + 1)];
  __shared__ float Bs[kMaxRows * (kTile + 1)];
  const int e = blockIdx.x;
  const float* Ae = A + (ia ? (long long)ia[e] : (long long)e) * a_e;
  const float* Be = B + (ib ? (long long)ib[e] : (long long)e) * b_e;
  const int pairs = na * nb;
  // a thread owns pairs t, t + blockDim, ... (at most 4: na nb <= 4 x 512)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int w = min(kTile, C - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < na * kTile; t += blockDim.x) {
      int a = t / kTile, c = t % kTile;
      As[a * (kTile + 1) + c] = c < w ? Ae[a * a_r + c0 + c] : 0.f;
    }
    for (int t = threadIdx.x; t < nb * kTile; t += blockDim.x) {
      int b = t / kTile, c = t % kTile;
      Bs[b * (kTile + 1) + c] = c < w ? Be[b * b_r + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int t = threadIdx.x + s * blockDim.x;
      if (t < pairs) {
        const float* ar = As + (t / nb) * (kTile + 1);
        const float* br = Bs + (t % nb) * (kTile + 1);
        float sum = acc[s];
        for (int c = 0; c < kTile; ++c) sum = fmaf(ar[c], br[c], sum);
        acc[s] = sum;
      }
    }
  }
  float* oe = out + (long long)e * out_e;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int t = threadIdx.x + s * blockDim.x;
    if (t < pairs) oe[t] = accumulate ? oe[t] + acc[s] : acc[s];
  }
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

extern "C" int so2_rotate_f32(const float* D, int d_e, const float* x, const int* idx,
                   int x_e, int x_r, float* y, int y_e, int y_r, int E,
                   int n_in, int n_out, int C, int transpose, void* stream) {
  if (E <= 0) return 0;
  if (n_in > kMaxRows || n_out > kMaxRows) return cudaErrorInvalidValue;
  int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  rotate_kernel<<<E, threads, 0, (cudaStream_t)stream>>>(
      D, d_e, x, idx, x_e, x_r, y, y_e, y_r, n_in, n_out, C, transpose);
  return (int)cudaGetLastError();
}

extern "C" int so2_rotate_grad_f32(const float* A, const int* ia, int a_e, int a_r,
                        int na, const float* B, const int* ib, int b_e,
                        int b_r, int nb, float* out, int out_e, int E, int C,
                        int accumulate, void* stream) {
  if (E <= 0) return 0;
  if (na > kMaxRows || nb > kMaxRows || na * nb > 4 * 512)
    return cudaErrorInvalidValue;
  int threads = na * nb >= 512 ? 512 : ((na * nb + 31) / 32) * 32;
  rotate_grad_kernel<<<E, threads, 0, (cudaStream_t)stream>>>(
      A, ia, a_e, a_r, na, B, ib, b_e, b_r, nb, out, out_e, C, accumulate);
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

