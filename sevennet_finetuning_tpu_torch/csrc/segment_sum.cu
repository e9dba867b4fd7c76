// Sorted segment sum: out[n, :] = sum over e with dst[e] == n of msg[e, :].
//
// Replaces: sevennet_finetuning_tpu/ops/pallas_scatter.py, segment_sum_sorted
// -> _forward -> the pallas_call of _kernel (a one-hot [TN, TE] x [TE, D]
// matmul per edge tile on the TPU's matrix unit).
//
// Bound on the H100: memory.  Each input row is read once and each output
// row written once, with one add per input element, so the function moves
// (E + N) * D * 4 bytes and the arithmetic is negligible.  At the model's
// small shapes the launch and the wrapper's host work are the time.
//
// Design: the destination index is sorted (the collate contract), so row
// n owns the edges [lower_bound(dst, n), lower_bound(dst, n + 1)); the
// kernels find those bounds themselves by binary search, so one call is
// one launch and one output allocation.  Edges whose destination is >=
// n_rows lie past lower_bound(dst, n_rows) and are dropped, as the JAX
// kernel drops its sentinel; a row without edges gets zeros.
//
// Every output element adds its row's edges in edge order, from 0: JAX's
// order.  The per-graph energy and virial of a converged checkpoint have
// residuals at float32 rounding, and in another order (a tree over lane
// groups) the first batch-8 gradient of the last convolution's
// denominator moved from 0.065 to 0.149 of the JAX golden's (limit 0.1).
// The wrapper (ops/scatter.py, segment_plan) picks one of two shapes:
//
// - rows (many rows, or short ones): one thread per (row, column) walking
//   the row's edges, 16-byte loads where d % 4 == 0; a block covers a run
//   of rows whose bounds its threads search in parallel.
// - staged (few output elements over long rows, d <= 256 -- the
//   per-graph virial, ~4,800 edges a row): one block per row.  Its threads copy the row's
//   edges into shared memory in chunks of `chunk` edges with cp.async, two
//   buffers deep, and thread t < d adds column t of each chunk in order,
//   while the next chunk lands.  The loads run in parallel; the adds stay
//   a chain of four-cycle adds, ~10 us for the virial.
//
// No atomics and a fixed order in both: every run gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kStagedThreads = 256;
constexpr int kStagedFloats = 4096;  // floats of one staging buffer

// first e in [0, n) with dst[e] >= v (n when there is none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ dst, int n,
                                           int v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(dst + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kStagedThreads) seg_sum_staged_kernel(
    const float* __restrict__ msg, const int* __restrict__ dst,
    float* __restrict__ out, int n_edge, int d, int chunk) {
  extern __shared__ float buf[];  // two buffers of chunk * d floats
  __shared__ int range[2];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 2) range[t] = lower_bound(dst, n_edge, row + t);
  __syncthreads();
  const int begin = range[0];
  const int n = range[1] - begin;
  const int n_chunks = (n + chunk - 1) / chunk;
  const float* src = msg + static_cast<long long>(begin) * d;
  auto load = [&](int c) {
    const int lo = c * chunk * d;
    const int hi = min(n, (c + 1) * chunk) * d;
    float* b = buf + (c & 1) * chunk * d - lo;
    for (int q = lo + t; q < hi; q += blockDim.x) cp_async4(b + q, src + q);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  float acc = 0.f;
  if (n_chunks > 0) load(0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    if (t < d) {
      const float* b = buf + (c & 1) * chunk * d + t;
      const int m = min(n - c * chunk, chunk);
#pragma unroll 8
      for (int e = 0; e < m; ++e) acc += b[e * d];
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
  if (t < d) out[static_cast<long long>(row) * d + t] = acc;
}

template <int VEC>
__global__ void __launch_bounds__(kRowThreads) seg_sum_rows_kernel(
    const float* __restrict__ msg, const int* __restrict__ dst,
    float* __restrict__ out, int n_edge, int n_rows, int d,
    int rows_per_block) {
  extern __shared__ int offs[];  // [rows_per_block + 1] edge bounds
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, n_rows - r0);
  for (int t = threadIdx.x; t <= nr; t += blockDim.x)
    offs[t] = lower_bound(dst, n_edge, r0 + t);
  __syncthreads();
  const int dv = d / VEC;
  for (int q = threadIdx.x; q < nr * dv; q += blockDim.x) {
    const int r = q / dv;
    const int c = (q - r * dv) * VEC;
    const int e_end = offs[r + 1];
    if (VEC == 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e = offs[r]; e < e_end; ++e) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            msg + static_cast<long long>(e) * d + c));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<long long>(r0 + r) * d +
                                 c) = acc;
    } else {
      float acc = 0.f;
      for (int e = offs[r]; e < e_end; ++e)
        acc += __ldg(msg + static_cast<long long>(e) * d + c);
      out[static_cast<long long>(r0 + r) * d + c] = acc;
    }
  }
}

}  // namespace

// chunk: 0 for the rows shape, else the staged shape's edges per chunk
// (chunk * d <= 4096, d <= 256: one thread a column).
extern "C" int seg_sum_sorted_f32(const float* msg, const int* dst,
                                  float* out, int n_edge, int n_rows, int d,
                                  int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_edge < 0 || n_rows < 0 || d < 0 || chunk < 0 ||
      static_cast<long long>(chunk) * d > kStagedFloats ||
      (chunk > 0 && d > kStagedThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (chunk > 0) {
    seg_sum_staged_kernel<<<n_rows, kStagedThreads,
                            2 * static_cast<size_t>(chunk) * d *
                                sizeof(float),
                            s>>>(msg, dst, out, n_edge, d, chunk);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(msg) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const int dv = vec4 ? d / 4 : d;
  const int rows_per_block = dv >= kRowThreads ? 1 : kRowThreads / dv;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  long long want = static_cast<long long>(rows_per_block) * dv;
  const int threads = want >= kRowThreads
                          ? kRowThreads
                          : static_cast<int>((want + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(rows_per_block + 1) * sizeof(int);
  if (vec4) {
    seg_sum_rows_kernel<4><<<blocks, threads, smem, s>>>(
        msg, dst, out, n_edge, n_rows, d, rows_per_block);
  } else {
    seg_sum_rows_kernel<1><<<blocks, threads, smem, s>>>(
        msg, dst, out, n_edge, n_rows, d, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
