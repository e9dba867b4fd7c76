// Grouped fused convolution forward ('gagg'): a sum of agg terms whose
// legs come from a pool of edge arrays,
//   out[n, msg_off + k*mul + u] = sum_t sum over edges e of node n of
//       W_t[e, w_off + u] * sum_{(k, i, j, c) of the path}
//                           c * X_t[e, x_off + i*mul + u] * S_t[e, sh_off + j]
// for every path of the layout (x chunk, sh irrep, output irrep, mul
// channels u), with the terms' legs (X_t, S_t, W_t) given as pool indices.
// This is the ybar cotangent of the convolution's double backward:
// agg(ct_x, sh, w) + agg(x, ct_sh, w) + agg(x, sh, ct_w).  No
// [E, dim_msg] message tensor is stored.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py,
// gagg_pallas -> its pallas_call (a shared pool-slab DMA and visit loop,
// one VMEM accumulator per term, one-hot matmuls onto the node tile).
//
// Bound on the H100: memory.  Each pool row is read once per live edge
// and each node row of the output written once; the arithmetic (a few
// operations per scalar coupling, channel and term) is a small fraction
// of the bytes' time.
//
// Design: the function is built on channels, and so is the kernel.  A
// warp takes one node and one unit, a path and a 32-channel slice of its
// x chunk (ops/cg_tables.py, gagg_plan: 30 units at SevenNet-0's interior
// block), and walks the node's dst-sorted edges [offs[n], offs[n+1]) in
// order.  A lane is a channel u: its X and W loads run along u and
// coalesce, and the S row (at most 7 floats of one sh irrep) is loaded
// once a warp and broadcast by shuffles.  Per edge and term a message
// component is
//     m[k] = W[u] * sum_i X[i, u] * B[k][i],  B[k][i] = sum c * S[j],
// and B does not depend on the channel: lane k*d1 + i forms B[k][i] from
// its own short coupling list (at most d2 steps, lists zero-padded to the
// path's longest), and each lane then takes the d1 * d3 values it needs by
// shuffles.  Templates on d1 and d3 keep X, B and the running sums in
// registers.  A lane keeps one running sum per term and component over
// the node's edges and, at the end, adds the terms left to right (the
// order of the plain version and of JAX's per-term accumulators) and
// writes each of its output columns once.  The paths write disjoint
// columns, so no two warps touch one element: no atomics, a fixed order,
// every run gives the same bits.  A node with no edges writes zeros;
// sentinel edges (dst = n_node) lie outside every node's range.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPool = 12;
constexpr int kMaxTerms = 6;
constexpr int kMaxSteps = 7;  // couplings of one (k, i): at most d2 <= 7
constexpr int kUnit = 12;     // ints of a unit (cg_tables.GAGG_UNIT)

// the legs of each term
struct Terms {
  const float* X[kMaxTerms];
  const float* S[kMaxTerms];
  const float* W[kMaxTerms];
  int n;
};

struct Dims {
  int x, sh, w, msg;
  int n_node, n_unit;
};

template <int D1, int D3>
__device__ __forceinline__ void run_unit(const int* __restrict__ unit,
                                         const int2* __restrict__ coup,
                                         const int* __restrict__ offs,
                                         int node, int lane, const Terms& tm,
                                         const Dims& dm,
                                         float* __restrict__ out) {
  constexpr int NH = (D1 * D3 + kWarp - 1) / kWarp;  // segment halves
  const int x_off = __ldg(unit + 0);
  const int mul = __ldg(unit + 2);
  const int u = __ldg(unit + 3) + lane;
  const int sh_off = __ldg(unit + 4);
  const int d2 = __ldg(unit + 5);
  const int msg_off = __ldg(unit + 6);
  const int w_off = __ldg(unit + 7);
  const int n_step = __ldg(unit + 10);
  const bool active = u < mul;
  const int uc = active ? u : mul - 1;
  // this lane's segments (k, i) = h * 32 + lane: their (j, c), in steps
  const int2* cp = coup + __ldg(unit + 9);
  int cj[kMaxSteps][NH];
  float cc[kMaxSteps][NH];
#pragma unroll
  for (int st = 0; st < kMaxSteps; ++st) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int2 c = st < n_step ? __ldg(cp + (st * NH + h) * kWarp + lane)
                                 : make_int2(0, 0);
      cj[st][h] = c.x;
      cc[st][h] = __int_as_float(c.y);
    }
  }
  float acc[kMaxTerms][D3];
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t)
#pragma unroll
    for (int k = 0; k < D3; ++k) acc[t][k] = 0.f;

  const int e_end = __ldg(offs + node + 1);
  for (int e = __ldg(offs + node); e < e_end; ++e) {
    const long long ee = e;
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t >= tm.n) break;
      const float s_l =
          lane < d2 ? __ldg(tm.S[t] + ee * dm.sh + sh_off + lane) : 0.f;
      float xv[D1];
#pragma unroll
      for (int i = 0; i < D1; ++i)
        xv[i] = __ldg(tm.X[t] + ee * dm.x + x_off + i * mul + uc);
      const float wv = __ldg(tm.W[t] + ee * dm.w + w_off + uc);
      float b[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) b[h] = 0.f;
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        if (st >= n_step) break;
#pragma unroll
        for (int h = 0; h < NH; ++h)
          b[h] = fmaf(cc[st][h], __shfl_sync(0xffffffffu, s_l, cj[st][h]),
                      b[h]);
      }
#pragma unroll
      for (int k = 0; k < D3; ++k) {
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < D1; ++i) {
          const int src = k * D1 + i;
          m = fmaf(__shfl_sync(0xffffffffu, b[src / kWarp], src % kWarp),
                   xv[i], m);
        }
        acc[t][k] = fmaf(wv, m, acc[t][k]);
      }
    }
  }
  if (!active) return;
  float* o = out + static_cast<long long>(node) * dm.msg + msg_off + u;
#pragma unroll
  for (int k = 0; k < D3; ++k) {
    float total = acc[0][k];
#pragma unroll
    for (int t = 1; t < kMaxTerms; ++t)
      if (t < tm.n) total += acc[t][k];
    o[k * mul] = total;
  }
}

template <int D1>
__device__ __forceinline__ void run_d3(int d3, const int* unit,
                                       const int2* coup, const int* offs,
                                       int node, int lane, const Terms& tm,
                                       const Dims& dm, float* out) {
  switch (d3) {
    case 1: run_unit<D1, 1>(unit, coup, offs, node, lane, tm, dm, out); break;
    case 3: run_unit<D1, 3>(unit, coup, offs, node, lane, tm, dm, out); break;
    case 5: run_unit<D1, 5>(unit, coup, offs, node, lane, tm, dm, out); break;
    default: run_unit<D1, 7>(unit, coup, offs, node, lane, tm, dm, out); break;
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock) cg_gagg_kernel(
    const int* __restrict__ offs, const int* __restrict__ plan,
    const int2* __restrict__ coup, float* __restrict__ out,
    const __grid_constant__ Terms tm, const __grid_constant__ Dims dm) {
  const long long gw =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (gw >= static_cast<long long>(dm.n_node) * dm.n_unit) return;
  const int node = static_cast<int>(gw / dm.n_unit);
  const int* unit = plan + (gw % dm.n_unit) * kUnit;
  const int lane = threadIdx.x % kWarp;
  const int d1 = __ldg(unit + 1);
  const int d3 = __ldg(unit + 8);
  switch (d1) {
    case 1: run_d3<1>(d3, unit, coup, offs, node, lane, tm, dm, out); break;
    case 3: run_d3<3>(d3, unit, coup, offs, node, lane, tm, dm, out); break;
    case 5: run_d3<5>(d3, unit, coup, offs, node, lane, tm, dm, out); break;
    default: run_d3<7>(d3, unit, coup, offs, node, lane, tm, dm, out); break;
  }
}

}  // namespace

// pool_ptrs: host array of n_pool device pointers (edge arrays [E, dim]);
// terms: host array [n_terms][3] of the terms' (x, sh, w) pool indices;
// offs: [n_node + 1] dst-sorted edge ranges; plan: the device copy of
// GAggPlan.packed(); plan_meta: host array (n_unit, offset of the
// couplings, plan length) (ops/cg_tables.py, gagg_plan).
extern "C" int cg_gagg_f32(const void* const* pool_ptrs, int n_pool,
                           const int* terms, int n_terms, const int* offs,
                           const int* plan, const int* plan_meta, float* out,
                           int n_node, int dim_x, int dim_sh, int dim_w,
                           int dim_msg, void* stream) {
  if (n_pool < 1 || n_pool > kMaxPool || n_terms < 1 ||
      n_terms > kMaxTerms || plan_meta[0] < 0 || plan_meta[1] % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Terms tm;
  const float** legs[3] = {tm.X, tm.S, tm.W};
  for (int t = 0; t < kMaxTerms; ++t) {
    for (int l = 0; l < 3; ++l) {
      const int idx = t < n_terms ? terms[3 * t + l] : -1;
      if (t < n_terms && (idx < 0 || idx >= n_pool))
        return static_cast<int>(cudaErrorInvalidValue);
      legs[l][t] = idx < 0 ? nullptr : static_cast<const float*>(
                                           pool_ptrs[idx]);
    }
  }
  tm.n = n_terms;
  Dims dm;
  dm.x = dim_x;
  dm.sh = dim_sh;
  dm.w = dim_w;
  dm.msg = dim_msg;
  dm.n_node = n_node;
  dm.n_unit = plan_meta[0];
  const long long warps = static_cast<long long>(n_node) * dm.n_unit;
  if (warps > 0) {
    const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cg_gagg_kernel<<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock,
                     0, static_cast<cudaStream_t>(stream)>>>(
        offs, plan, reinterpret_cast<const int2*>(plan + plan_meta[1]), out,
        tm, dm);
  }
  return static_cast<int>(cudaGetLastError());
}
