// Fused convolution backward ('multi'): any subset of the edge cotangents
// xn / shn / wn from one node cotangent ybar,
//   out_job[e, col] = sum_t coef_t * row_e[a_t] * row_e[b_t] * row_e[c_t],
// with row_e = [g | x[e] | sh[e] | w[e]], g = ybar[dst[e]] (zeros where
// dst[e] >= n_node, the padding sentinel).  The work items and their terms
// are built on the host (ops/cg_tables.py, multi_table).
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py,
// multi_pallas -> _build_multi_call -> its pallas_call (a windowed ybar DMA
// and an exact bf16x3 one-hot selection of g on the TPU's matrix unit, then
// the shared per-group contractions).  On this card a direct row load of
// ybar is exact, so none of that selection machinery is needed.
//
// Bound on the H100: memory, by the roofline count (x, sh, w read once per
// edge, ybar once per node, every output written once).  This first version
// is bound in practice by its shared-memory gathers and term-table reads.
//
// Design: each block takes a run of consecutive edges and walks them one at
// a time: it stages g and the edge's x/sh/w rows in shared memory (g only
// when dst changes -- edges are dst-sorted, so consecutive edges mostly
// share it), then its threads evaluate the work items.  An xn or wn column
// is one item.  An shn column sums thousands of terms, so its terms come in
// chunks, each chunk an item writing a partial sum to shared memory, and a
// second pass adds each column's partials in order.  No atomics, fixed sum
// order: every run gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store_out(int v, long long e, float val,
                                          float* out0, float* out1,
                                          float* out2, int d0, int d1,
                                          int d2) {
  if (v < d0) {
    out0[e * d0 + v] = val;
  } else if (v < d0 + d1) {
    out1[e * d1 + (v - d0)] = val;
  } else {
    out2[e * d2 + (v - d0 - d1)] = val;
  }
}

__global__ void __launch_bounds__(kThreads) cg_multi_kernel(
    const float* __restrict__ ybar, const float* __restrict__ x,
    const float* __restrict__ sh, const float* __restrict__ w,
    const int* __restrict__ dst, const int* __restrict__ item_start,
    const int* __restrict__ item_out, const int4* __restrict__ terms,
    int n_items, const int* __restrict__ red_start,
    const int* __restrict__ red_out, int n_red, float* out0, float* out1,
    float* out2, int d0, int d1, int d2, int n_edge, int n_node, int dim_msg,
    int dim_x, int dim_sh, int dim_w, int edges_per_block) {
  extern __shared__ float smem[];
  const int row_len = dim_msg + dim_x + dim_sh + dim_w;
  float* row = smem;             // [g | x | sh | w]
  float* part = smem + row_len;  // shn partial sums
  float* xr = row + dim_msg;
  float* shr = xr + dim_x;
  float* wr = shr + dim_sh;

  const long long e_begin =
      static_cast<long long>(blockIdx.x) * edges_per_block;
  const long long e_end =
      e_begin + edges_per_block < n_edge ? e_begin + edges_per_block : n_edge;
  int g_node = -2;  // node whose ybar row is staged (-1: the zero row)

  for (long long e = e_begin; e < e_end; ++e) {
    const int d = dst[e];
    const int node = d < n_node ? d : -1;
    __syncthreads();  // the previous edge's row and partials are consumed
    if (node != g_node) {
      if (node >= 0) {
        const float* src = ybar + static_cast<long long>(node) * dim_msg;
        for (int c = threadIdx.x; c < dim_msg; c += blockDim.x)
          row[c] = src[c];
      } else {
        for (int c = threadIdx.x; c < dim_msg; c += blockDim.x)
          row[c] = 0.f;
      }
      g_node = node;
    }
    for (int c = threadIdx.x; c < dim_x; c += blockDim.x)
      xr[c] = x[e * dim_x + c];
    for (int c = threadIdx.x; c < dim_sh; c += blockDim.x)
      shr[c] = sh[e * dim_sh + c];
    for (int c = threadIdx.x; c < dim_w; c += blockDim.x)
      wr[c] = w[e * dim_w + c];
    __syncthreads();

    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      const int t_begin = item_start[it];
      const int t_end = item_start[it + 1];
      float acc = 0.f;
      for (int t = t_begin; t < t_end; ++t) {
        const int4 tm = __ldg(terms + t);
        acc += __int_as_float(tm.w) * row[tm.x] * row[tm.y] * row[tm.z];
      }
      const int o = item_out[it];
      if (o >= 0) {
        store_out(o, e, acc, out0, out1, out2, d0, d1, d2);
      } else {
        part[-o - 1] = acc;
      }
    }
    if (n_red > 0) {
      __syncthreads();
      for (int q = threadIdx.x; q < n_red; q += blockDim.x) {
        float acc = 0.f;
        for (int p = red_start[q]; p < red_start[q + 1]; ++p) acc += part[p];
        store_out(red_out[q], e, acc, out0, out1, out2, d0, d1, d2);
      }
    }
  }
}

}  // namespace

extern "C" int cg_multi_f32(const float* ybar, const float* x,
                            const float* sh, const float* w, const int* dst,
                            const int* item_start, const int* item_out,
                            const int* terms, int n_items,
                            const int* red_start, const int* red_out,
                            int n_red, int n_part, float* out0, float* out1,
                            float* out2, int d0, int d1, int d2, int n_edge,
                            int n_node, int dim_msg, int dim_x, int dim_sh,
                            int dim_w, int edges_per_block, void* stream) {
  if (edges_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(dim_msg + dim_x + dim_sh + dim_w +
                                          n_part) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cg_multi_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (n_edge > 0) {
    const int blocks = (n_edge + edges_per_block - 1) / edges_per_block;
    cg_multi_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        ybar, x, sh, w, dst, item_start, item_out,
        reinterpret_cast<const int4*>(terms), n_items, red_start, red_out,
        n_red, out0, out1, out2, d0, d1, d2, n_edge, n_node, dim_msg, dim_x,
        dim_sh, dim_w, edges_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
