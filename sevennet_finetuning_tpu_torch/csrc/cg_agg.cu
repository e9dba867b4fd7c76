// Fused convolution forward ('agg'): uvu CG messages summed onto their
// destination nodes,
//   out[n, col] = sum over edges e of node n of
//                 sum_t coef_t * row_e[a_t] * row_e[b_t] * row_e[c_t],
// with row_e = [x[e] | sh[e] | w[e]] and the per-column terms (the nonzero
// Wigner-3j couplings, unrolled over the multiplicity) built on the host
// (ops/cg_tables.py, agg_table).  The [E, dim_msg] message tensor is never
// stored.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py, agg_pallas
// -> the pallas_call of _kernel (per edge tile: messages in VMEM, then a
// one-hot matmul onto the node tile).
//
// Bound on the H100: memory, by the roofline count (each edge row of x, sh
// and w read once, each node row of the output written once; about 2.2
// multiply-adds per message element).  This first version is bound in
// practice by its shared-memory gathers and term-table reads: every term
// reads three staged values and one 16-byte table entry.
//
// Design: one block per destination node (the edges are dst-sorted, so a
// node's edges are the contiguous range [offs[n], offs[n+1])).  The block
// stages tiles of its edges' x/sh/w rows in shared memory; each thread owns
// up to kMaxCols msg columns, keeps their sums in registers across all the
// node's edges, and writes each output element once.  No atomics; the sum
// over edges and terms runs in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;  // msg columns per thread: dim_msg <= 4096

__global__ void __launch_bounds__(kThreads)
    cg_agg_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                  const float* __restrict__ w, const int* __restrict__ offs,
                  const int* __restrict__ col_start,
                  const int4* __restrict__ terms, float* __restrict__ out,
                  int dim_x, int dim_sh, int dim_w, int dim_msg,
                  int tile_e) {
  extern __shared__ float rows[];
  const int n = blockIdx.x;
  const int row_len = dim_x + dim_sh + dim_w;
  const int e_begin = offs[n];
  const int e_end = offs[n + 1];

  float acc[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;

  for (int eb = e_begin; eb < e_end; eb += tile_e) {
    const int ne = min(tile_e, e_end - eb);
    __syncthreads();  // the previous tile is no longer read
    for (int le = 0; le < ne; ++le) {
      const long long e = eb + le;
      float* r = rows + le * row_len;
      for (int c = threadIdx.x; c < dim_x; c += blockDim.x)
        r[c] = x[e * dim_x + c];
      for (int c = threadIdx.x; c < dim_sh; c += blockDim.x)
        r[dim_x + c] = sh[e * dim_sh + c];
      for (int c = threadIdx.x; c < dim_w; c += blockDim.x)
        r[dim_x + dim_sh + c] = w[e * dim_w + c];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int col = threadIdx.x + k * kThreads;
      if (col < dim_msg) {
        const int t_begin = col_start[col];
        const int t_end = col_start[col + 1];
        for (int le = 0; le < ne; ++le) {
          const float* r = rows + le * row_len;
          float m = 0.f;
          for (int t = t_begin; t < t_end; ++t) {
            const int4 tm = __ldg(terms + t);
            m += __int_as_float(tm.w) * r[tm.x] * r[tm.y] * r[tm.z];
          }
          acc[k] += m;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int col = threadIdx.x + k * kThreads;
    if (col < dim_msg) out[static_cast<long long>(n) * dim_msg + col] = acc[k];
  }
}

}  // namespace

extern "C" int cg_agg_f32(const float* x, const float* sh, const float* w,
                          const int* offs, const int* col_start,
                          const int* terms, float* out, int n_node,
                          int dim_x, int dim_sh, int dim_w, int dim_msg,
                          int tile_e, void* stream) {
  if (dim_msg > kThreads * kMaxCols || tile_e < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(tile_e) * (dim_x + dim_sh + dim_w) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cg_agg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (n_node > 0) {
    cg_agg_kernel<<<n_node, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        x, sh, w, offs, col_start, reinterpret_cast<const int4*>(terms), out,
        dim_x, dim_sh, dim_w, dim_msg, tile_e);
  }
  return static_cast<int>(cudaGetLastError());
}
