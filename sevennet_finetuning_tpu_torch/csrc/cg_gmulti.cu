// Grouped multi-job backward of the fused convolution ('gmulti'): jobs
// (emit mode xn / shn / wn, two legs from a pool of edge arrays, group)
// over one shared node cotangent ybar; the jobs of a group add into one
// output,
//   out_grp[e, col] = sum_{jobs of grp, in order}
//                     sum_q coef_q * row_e[a_q] * row_e[b_q] * row_e[c_q],
// with row_e = [g | pool_0[e] | pool_1[e] | ...], g = ybar[dst[e]] (zeros
// where dst[e] >= n_node, the padding sentinel).  The items, their per-job
// segments and terms are built on the host (ops/cg_tables.py,
// gmulti_table).  This gives every edge-side cotangent of the
// convolution's double backward in one launch.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py,
// gmulti_pallas -> _build_gmulti_call -> its pallas_call (one windowed
// ybar DMA and bf16x3 one-hot selection of g shared by all jobs, then the
// per-job contractions into grouped outputs).  On this card a direct row
// load of ybar is exact, so none of that selection machinery is needed.
//
// Bound on the H100: memory, by the roofline count (each pool row read
// once per live edge, ybar once per node, every output written once).
// Like cg_multi, this first version is bound in practice by its
// shared-memory gathers and term-table reads.
//
// Design: cg_multi.cu's, generalised.  A block takes a run of consecutive
// edges and walks them one at a time: it stages g (only when dst changes:
// edges are dst-sorted) and the edge's pool rows in shared memory, then
// its threads evaluate the work items.  An xn or wn item is a list of
// segments, one per job of its group in job order; each segment is summed
// on its own and added to the item's total.  An shn column sums thousands
// of terms, so its terms come in chunks (job after job), each chunk an
// item writing a partial sum, and a second pass adds each column's
// partials in order.  No atomics, fixed order: every run gives the same
// bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPool = 12;
constexpr int kMaxOut = 12;

struct Pool {
  const float* ptr[kMaxPool];
  int dim[kMaxPool];
  int off[kMaxPool];
  int n;
};

struct Outs {
  float* ptr[kMaxOut];
  int dim[kMaxOut];
  int n;
};

__device__ __forceinline__ void store_out(const Outs& outs, int v,
                                          long long e, float val) {
  int g = 0;
  while (g < outs.n - 1 && v >= outs.dim[g]) {
    v -= outs.dim[g];
    ++g;
  }
  outs.ptr[g][e * outs.dim[g] + v] = val;
}

__global__ void __launch_bounds__(kThreads) cg_gmulti_kernel(
    const float* __restrict__ ybar, Pool pool, const int* __restrict__ dst,
    const int* __restrict__ item_seg, const int* __restrict__ seg_start,
    const int* __restrict__ item_out, const int4* __restrict__ terms,
    int n_items, const int* __restrict__ red_start,
    const int* __restrict__ red_out, int n_red, Outs outs, int n_edge,
    int n_node, int dim_msg, int row_len, int edges_per_block) {
  extern __shared__ float smem[];
  float* row = smem;             // [g | pool_0 | pool_1 | ...]
  float* part = smem + row_len;  // shn partial sums

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
    for (int p = 0; p < pool.n; ++p) {
      const float* src = pool.ptr[p] + e * pool.dim[p];
      float* dstp = row + pool.off[p];
      for (int c = threadIdx.x; c < pool.dim[p]; c += blockDim.x)
        dstp[c] = src[c];
    }
    __syncthreads();

    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      float total = 0.f;
      for (int s = item_seg[it]; s < item_seg[it + 1]; ++s) {
        float acc = 0.f;
        for (int q = seg_start[s]; q < seg_start[s + 1]; ++q) {
          const int4 tm = __ldg(terms + q);
          acc += __int_as_float(tm.w) * row[tm.x] * row[tm.y] * row[tm.z];
        }
        total += acc;
      }
      const int o = item_out[it];
      if (o >= 0) {
        store_out(outs, o, e, total);
      } else {
        part[-o - 1] = total;
      }
    }
    if (n_red > 0) {
      __syncthreads();
      for (int q = threadIdx.x; q < n_red; q += blockDim.x) {
        float acc = 0.f;
        for (int p = red_start[q]; p < red_start[q + 1]; ++p) acc += part[p];
        store_out(outs, red_out[q], e, acc);
      }
    }
  }
}

}  // namespace

// pool_ptrs / pool_dims: host arrays of n_pool device pointers and row
// widths; out_ptrs / out_dims: host arrays of the n_out group outputs.
extern "C" int cg_gmulti_f32(const float* ybar, const void* const* pool_ptrs,
                             const int* pool_dims, int n_pool, const int* dst,
                             const int* item_seg, const int* seg_start,
                             const int* item_out, const int* terms,
                             int n_items, const int* red_start,
                             const int* red_out, int n_red, int n_part,
                             void* const* out_ptrs, const int* out_dims,
                             int n_out, int n_edge, int n_node, int dim_msg,
                             int edges_per_block, void* stream) {
  if (edges_per_block < 1 || n_pool < 1 || n_pool > kMaxPool || n_out < 1 ||
      n_out > kMaxOut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pool pool;
  int row_len = dim_msg;
  for (int p = 0; p < kMaxPool; ++p) {
    const bool live = p < n_pool;
    pool.ptr[p] = live ? static_cast<const float*>(pool_ptrs[p]) : nullptr;
    pool.dim[p] = live ? pool_dims[p] : 0;
    pool.off[p] = row_len;
    row_len += pool.dim[p];
  }
  pool.n = n_pool;
  Outs outs;
  for (int g = 0; g < kMaxOut; ++g) {
    const bool live = g < n_out;
    outs.ptr[g] = live ? static_cast<float*>(out_ptrs[g]) : nullptr;
    outs.dim[g] = live ? out_dims[g] : 0;
  }
  outs.n = n_out;
  const size_t smem = static_cast<size_t>(row_len + n_part) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cg_gmulti_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (n_edge > 0) {
    const int blocks = (n_edge + edges_per_block - 1) / edges_per_block;
    cg_gmulti_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        ybar, pool, dst, item_seg, seg_start, item_out,
        reinterpret_cast<const int4*>(terms), n_items, red_start, red_out,
        n_red, outs, n_edge, n_node, dim_msg, row_len, edges_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
