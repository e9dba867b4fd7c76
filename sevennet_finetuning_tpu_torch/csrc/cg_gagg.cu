// Grouped fused convolution forward ('gagg'): a sum of NT agg terms whose
// legs come from a pool of edge arrays,
//   out[n, col] = sum_{t < NT} sum over edges e of node n of
//                 sum_{q in terms(col, t)} coef_q * row_e[a_q] * row_e[b_q]
//                                                 * row_e[c_q],
// with row_e = [pool_0[e] | pool_1[e] | ...] and the per-(column, term)
// entries built on the host (ops/cg_tables.py, gagg_table).  This is the
// ybar cotangent of the convolution's double backward: agg(ct_x, sh, w) +
// agg(x, ct_sh, w) + agg(x, sh, ct_w).  No [E, dim_msg] message tensor is
// stored.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py,
// gagg_pallas -> its pallas_call (a shared pool-slab DMA and visit loop,
// one VMEM accumulator per term, one-hot matmuls onto the node tile).
//
// Bound on the H100: memory, by the roofline count (each pool row read once
// per live edge, each node row of the output written once; a few
// multiply-adds per message element and term).  Like cg_agg, this first
// version is bound in practice by its shared-memory gathers and term-table
// reads.
//
// Design: cg_agg's, with a pool.  One block per destination node walks the
// node's contiguous dst-sorted edge range [offs[n], offs[n+1]) in tiles,
// staging each edge's pool rows in shared memory.  Each thread owns up to
// kMaxCols msg columns and keeps one register sum per (column, term); the
// term sums are added left to right at the end, as _gagg_kernel adds its
// accumulators.  No atomics, fixed order: every run gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;  // msg columns per thread: dim_msg <= 4096
constexpr int kMaxPool = 12;
constexpr int kMaxTerms = 6;

struct Pool {
  const float* ptr[kMaxPool];
  int dim[kMaxPool];
  int off[kMaxPool];
  int n;
};

template <int NT>
__global__ void __launch_bounds__(kThreads)
    cg_gagg_kernel(Pool pool, const int* __restrict__ offs,
                   const int* __restrict__ start,
                   const int4* __restrict__ terms, float* __restrict__ out,
                   int dim_msg, int row_len, int tile_e) {
  extern __shared__ float rows[];
  const int n = blockIdx.x;
  const int e_begin = offs[n];
  const int e_end = offs[n + 1];

  float acc[NT][kMaxCols];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[t][k] = 0.f;

  for (int eb = e_begin; eb < e_end; eb += tile_e) {
    const int ne = min(tile_e, e_end - eb);
    __syncthreads();  // the previous tile is no longer read
    for (int le = 0; le < ne; ++le) {
      const long long e = eb + le;
      float* r = rows + le * row_len;
      for (int p = 0; p < pool.n; ++p) {
        const float* src = pool.ptr[p] + e * pool.dim[p];
        float* dstp = r + pool.off[p];
        for (int c = threadIdx.x; c < pool.dim[p]; c += blockDim.x)
          dstp[c] = src[c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int col = threadIdx.x + k * kThreads;
      if (col < dim_msg) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int q_begin = start[col * NT + t];
          const int q_end = start[col * NT + t + 1];
          for (int le = 0; le < ne; ++le) {
            const float* r = rows + le * row_len;
            float m = 0.f;
            for (int q = q_begin; q < q_end; ++q) {
              const int4 tm = __ldg(terms + q);
              m += __int_as_float(tm.w) * r[tm.x] * r[tm.y] * r[tm.z];
            }
            acc[t][k] += m;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int col = threadIdx.x + k * kThreads;
    if (col < dim_msg) {
      float total = acc[0][k];
#pragma unroll
      for (int t = 1; t < NT; ++t) total += acc[t][k];
      out[static_cast<long long>(n) * dim_msg + col] = total;
    }
  }
}

template <int NT>
int launch(const Pool& pool, const int* offs, const int* start,
           const int* terms, float* out, int n_node, int dim_msg,
           int row_len, int tile_e, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile_e) * row_len * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cg_gagg_kernel<NT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (n_node > 0) {
    cg_gagg_kernel<NT><<<n_node, kThreads, smem, stream>>>(
        pool, offs, start, reinterpret_cast<const int4*>(terms), out,
        dim_msg, row_len, tile_e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool_ptrs / pool_dims: host arrays of n_pool device pointers and row
// widths; start: [dim_msg * n_terms + 1] CSR over (column, term).
extern "C" int cg_gagg_f32(const void* const* pool_ptrs, const int* pool_dims,
                           int n_pool, const int* offs, const int* start,
                           const int* terms, int n_terms, float* out,
                           int n_node, int dim_msg, int tile_e,
                           void* stream) {
  if (dim_msg > kThreads * kMaxCols || tile_e < 1 || n_pool < 1 ||
      n_pool > kMaxPool || n_terms < 1 || n_terms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pool pool;
  int row_len = 0;
  for (int p = 0; p < kMaxPool; ++p) {
    const bool live = p < n_pool;
    pool.ptr[p] = live ? static_cast<const float*>(pool_ptrs[p]) : nullptr;
    pool.dim[p] = live ? pool_dims[p] : 0;
    pool.off[p] = row_len;
    row_len += pool.dim[p];
  }
  pool.n = n_pool;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_terms) {
    case 1: return launch<1>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
    case 2: return launch<2>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
    case 3: return launch<3>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
    case 4: return launch<4>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
    case 5: return launch<5>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
    default: return launch<6>(pool, offs, start, terms, out, n_node, dim_msg, row_len, tile_e, s);
  }
}
