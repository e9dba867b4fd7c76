// Per-edge quadrilinear family ('cg_quad'): one mode of the uvu CG
// convolution for every edge, with no aggregation,
//   out[e, col] = sum_t coef_t * row_e[a_t] * row_e[b_t] * row_e[c_t],
// with row_e = [a[e] | b[e] | c[e]], the mode's three legs edge-major:
//   msg: (x, sh, w) -> [E, dim_msg]      x: (g, sh, w) -> [E, dim_x]
//   sh:  (g, x, w)  -> [E, dim_sh]       w: (g, x, sh) -> [E, dim_w]
// The work items and their terms (the nonzero Wigner-3j couplings,
// unrolled over the multiplicity) are built on the host
// (ops/cg_tables.py, quad_table).  An msg, x or w column is one item.  An
// sh column sums every term of its filter component (hundreds to
// thousands), so its terms come in chunks, each chunk an item writing a
// partial sum, and a second pass adds each column's partials in order.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_kernel.py, pallas_impl ->
// _build_call -> its pallas_call (per 128-edge tile, feature-major, the
// couplings unrolled into vector multiply-adds at trace time).
//
// Bound on the H100: memory.  Every mode reads three legs and writes the
// fourth once per edge; at SevenNet-0's interior blocks that is 18,340
// bytes against about 20,500 fp32 operations per edge, far below the
// card's 20 operations per byte.  This first version is bound in practice
// by its term-table reads and shared-memory gathers, as the cg_* kernels
// are: every term reads one 16-byte table entry and three staged values.
//
// Design: each block takes a tile of up to kMaxTile consecutive edges and
// stages their three legs in shared memory (each leg's tile is one
// contiguous run of global memory, read coalesced).  Each thread owns work
// items; it reads each table entry once and applies it to every staged
// edge, keeping one register sum per edge.  Neighbouring items are
// neighbouring output columns (the multiplicity index u is fastest), so a
// warp's stores to one edge row are contiguous.  No atomics: every sum
// runs in a fixed order, so every run gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8;  // edges per block (register sums per item)

__global__ void __launch_bounds__(kThreads) cg_quad_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, int da, int db, int dc,
    const int* __restrict__ item_start, const int* __restrict__ item_out,
    const int4* __restrict__ terms, int n_items,
    const int* __restrict__ red_start, const int* __restrict__ red_out,
    int n_red, int n_part, float* __restrict__ out, int d_out,
    long long n_edge, int tile_e) {
  extern __shared__ float smem[];
  const int row_len = da + db + dc;
  float* rows = smem;                    // [tile_e][a | b | c]
  float* part = smem + tile_e * row_len;  // [tile_e][n_part]
  const long long e0 = static_cast<long long>(blockIdx.x) * tile_e;
  const int ne = static_cast<int>(
      n_edge - e0 < tile_e ? n_edge - e0 : static_cast<long long>(tile_e));

  for (int i = threadIdx.x; i < ne * da; i += blockDim.x) {
    const int le = i / da;
    rows[le * row_len + (i - le * da)] = a[e0 * da + i];
  }
  for (int i = threadIdx.x; i < ne * db; i += blockDim.x) {
    const int le = i / db;
    rows[le * row_len + da + (i - le * db)] = b[e0 * db + i];
  }
  for (int i = threadIdx.x; i < ne * dc; i += blockDim.x) {
    const int le = i / dc;
    rows[le * row_len + da + db + (i - le * dc)] = c[e0 * dc + i];
  }
  __syncthreads();

  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    float acc[kMaxTile];
#pragma unroll
    for (int le = 0; le < kMaxTile; ++le) acc[le] = 0.f;
    const int t_end = item_start[it + 1];
    for (int t = item_start[it]; t < t_end; ++t) {
      const int4 tm = __ldg(terms + t);
      const float coef = __int_as_float(tm.w);
#pragma unroll
      for (int le = 0; le < kMaxTile; ++le) {
        if (le < ne) {
          const float* r = rows + le * row_len;
          acc[le] += coef * r[tm.x] * r[tm.y] * r[tm.z];
        }
      }
    }
    const int o = item_out[it];
#pragma unroll
    for (int le = 0; le < kMaxTile; ++le) {
      if (le < ne) {
        if (o >= 0) {
          out[(e0 + le) * d_out + o] = acc[le];
        } else {
          part[le * n_part + (-o - 1)] = acc[le];
        }
      }
    }
  }
  if (n_red > 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < ne * n_red; i += blockDim.x) {
      const int le = i / n_red;
      const int q = i - le * n_red;
      float s = 0.f;
      for (int p = red_start[q]; p < red_start[q + 1]; ++p) {
        s += part[le * n_part + p];
      }
      out[(e0 + le) * d_out + red_out[q]] = s;
    }
  }
}

}  // namespace

extern "C" int cg_quad_f32(const float* a, const float* b, const float* c,
                           int da, int db, int dc, const int* item_start,
                           const int* item_out, const int* terms,
                           int n_items, const int* red_start,
                           const int* red_out, int n_red, int n_part,
                           float* out, int d_out, int n_edge, int tile_e,
                           void* stream) {
  if (tile_e < 1 || tile_e > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(tile_e) *
                      (static_cast<size_t>(da) + db + dc + n_part) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cg_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_edge > 0) {
    const int blocks = (n_edge + tile_e - 1) / tile_e;
    cg_quad_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        a, b, c, da, db, dc, item_start, item_out,
        reinterpret_cast<const int4*>(terms), n_items, red_start, red_out,
        n_red, n_part, out, d_out, static_cast<long long>(n_edge), tile_e);
  }
  return static_cast<int>(cudaGetLastError());
}
