// Grouped multi-job backward of the fused convolution ('gmulti'): jobs
// (emit mode x / sh / w, two legs from a pool of edge arrays, group) over
// one shared node cotangent ybar; the jobs of a group add into one output.
// With g = ybar[dst[e]] (zero where dst[e] >= n_node, the padding
// sentinel) and, per path p of a group (x chunk, sh chunk, mul channels
// u) and coupling (k, i, j, c) of p,
//
//   x  job (legs S, W): out[e, x_off + i*mul + u] += c S[j] g[k, u] W[p, u]
//   sh job (legs X, W): out[e, sh_off + j]        += c X[i, u] g[k, u] W[p, u]
//   w  job (legs X, S): out[e, w_off(p) + u]      += c X[i, u] S[j] g[k, u]
//
// summed over every other index.  This gives every edge-side cotangent of
// the convolution's double backward in one launch.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py,
// gmulti_pallas -> _build_gmulti_call -> its pallas_call (one windowed
// ybar DMA and bf16x3 one-hot selection of g shared by all jobs, then the
// per-job contractions on [mul, TE] slices per path and coupling), and
// through cg_multi_f32 multi_pallas -> _build_multi_call -> its
// pallas_call (the same for the first-order jobs xn / shn / wn).  On
// this card a direct row load of ybar is exact, so none of that selection
// machinery is needed.
//
// Bound on the H100: memory.  Each pool row is read once per live edge
// and each output row written once; the arithmetic (about three fp32
// operations per scalar coupling and job) is a third of the bytes' time.
//
// Design: the function is built on channels, and so is the kernel.  A
// lane of a warp is one channel u of one x irrep (a chunk): its leg loads
// x[e, x_off + i*mul + u], w[e, w_off + u], ybar[dst, msg_off + k*mul + u]
// and its x and w outputs run along u and coalesce, and each is read or
// written by one thread.  The host lists each path's couplings once
// (ops/cg_tables.py, gmulti_plan: 137 at SevenNet-0's interior block),
// sorted by (i, j); a block copies the list into shared memory and every
// lane of a warp reads the same entry.  Per path a lane first forms
//     A[i][j] = sum_{couplings (k, i, j, c)} c * g[k, u],
// which no job depends on, and then each job contracts it with its legs
// (D1 x D2 multiply-adds): x: W * sum_j S[j] A[i][j]; sh: W * sum_i X[i]
// A[i][j]; w: sum_ij X[i] S[j] A[i][j].  Templates on the irrep dims keep
// A and every per-lane vector in registers.  A pass takes up to two jobs
// of each emit mode whose legs pair as in CGNodeMulti.backward's six
// (legs X[2], S[2], W[2]; see Pass), so each leg is loaded once for every
// job that reads it (ops/cg_tables.py, gmulti_passes); another job set
// runs as several passes, each adding to the groups the earlier ones
// wrote.
//
// The first-order backward ('multi', cg_multi_f32) is the same pass over
// the pool [x, sh, w] with one job of each emit mode it asks for: xn is
// the x job (S0 = sh, W0 = w), shn the sh job (X0 = x, W0 = w), wn the w
// job (X0 = x, S1 = sh).  It never fills a slot 1, so its entry point
// runs the kernel built for one slot (the template argument NS), whose
// w slot reads S[0], with the arrays and branches of slot 1 compiled out.
// Its forces and their parameter gradients are held against the JAX
// package's goldens, so it keeps the rounding of the plain composition
// where that decides: the x and sh jobs contract gw = g * w, each
// product rounded, instead of applying w to the path's sum (which moved
// the first batch-8 train step's gradients of the converged checkpoint,
// float32 rounding at the size of the leaf for a few leaves, past their
// limits against JAX).  With one W leg that costs one multiply a
// coupling; the w job, which needs the couplings without w, keeps a
// second sum in the same loop.
//
// A block takes a tile of consecutive edges.  A work unit is 32 channels
// of one chunk (a slice) and the tile's edges e with e % n_phase == phase;
// a warp takes one unit or more.  The kernel waits on dependent global
// loads more than it computes (at SevenNet-0's interior block, neither
// its bytes nor its instructions come near the card's rates), so the
// phases give a block more warps to hide them (gmulti_plan; the count
// was measured, tools/gmulti_phases.py), and the legs, read once, are
// streamed (ld.global.cs) so as not to evict the ybar rows that every
// edge of a tile rereads.  Staging a
// tile's legs in shared memory and prefetching the next edge's rows were
// tried and were slower.  An sh output sums over
// channels: each warp adds its lanes' partials by a fixed xor butterfly
// and stores one value per (edge, slice, job, column) in shared memory;
// after the tile the block adds the slices in order.  A sentinel edge
// writes zeros and reads no leg.  No atomics and a fixed order: every run
// gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;
constexpr int kThreads = kWarp * kMaxWarps;
constexpr int kSlots = 2;
constexpr int kMaxPool = 12;
constexpr int kMaxOut = 12;
constexpr int kMaxSmem = 232448;

// one emit mode's jobs in a pass: output and add-to-output flag per slot
// (a null output: the slot is unused)
struct Mode {
  float* out[kSlots];
  int add[kSlots];
  int same;  // both slots write one group: slot 1 adds to slot 0
};

// A pass: the legs, and per emit mode two job slots.  Slot s of the x
// mode reads (S[s], W[s]), of the sh mode (X[s], W[s]), of the w mode
// (X[s], S[1 - s]): the pairing of CGNodeMulti.backward's six jobs, so
// each leg is loaded once for the jobs that share it.  A kernel built for
// NS = 1 slot takes slot 0 only, and its w slot reads S[0].
struct Pass {
  const float* X[kSlots];
  const float* S[kSlots];
  const float* W[kSlots];
  Mode x, sh, w;
};

// the S leg of w slot s (an involution: S[s] is read by w slot ws(s))
template <int NS>
__host__ __device__ __forceinline__ constexpr int ws(int s) {
  return NS == 1 ? 0 : 1 - s;
}

struct Dims {
  int x, sh, w, msg;
  int n_edge, n_node, te;
  int n_desc, n_slice;
  int off_chunk, off_group, off_path, off_pair, off_coup, off_desc, plan_len;
};

// the slots' values at one element of their outputs
template <int NS>
__device__ __forceinline__ void emit(const Mode& m, long long idx,
                                     const float (&v)[NS]) {
  if (NS == 1) {
    if (m.out[0]) m.out[0][idx] = m.add[0] ? m.out[0][idx] + v[0] : v[0];
    return;
  }
  if (m.same) {
    const float a = m.add[0] ? m.out[0][idx] + v[0] : v[0];
    m.out[0][idx] = a + v[NS - 1];
    return;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (m.out[s]) m.out[s][idx] = m.add[s] ? m.out[s][idx] + v[s] : v[s];
}

template <int NS>
__device__ __forceinline__ bool live(const Mode& m) {
  bool on = false;
#pragma unroll
  for (int s = 0; s < NS; ++s) on = on || m.out[s] != nullptr;
  return on;
}

struct Lane {
  long long e;     // edge
  int el;          // edge within the tile
  int u;           // channel (clamped into the chunk for idle lanes)
  bool active;     // u < mul
  int lane;
  int slice;
  const float* g;  // ybar[dst[e]] + u
};

template <int NS, int D1, int D2>
__device__ __forceinline__ void run_group(
    const int* __restrict__ plan, const int* grp, const Lane& ln,
    const Pass& ps, const Dims& dm, float* red, const float (&xs)[NS][D1],
    float (&accx)[NS][D1]) {
  const int sh_off = grp[0];
  const long long se = ln.e * dm.sh + sh_off;
  float sv[NS][D2], acc_sh[NS][D2];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const bool need = ps.x.out[s] || ps.w.out[ws<NS>(s)];
#pragma unroll
    for (int j = 0; j < D2; ++j) {
      sv[s][j] = need ? __ldg(ps.S[s] + se + j) : 0.f;
      acc_sh[s][j] = 0.f;
    }
  }
  const int2* coup = reinterpret_cast<const int2*>(plan + dm.off_coup);
  for (int p = grp[2]; p < grp[3]; ++p) {
    const int* path = plan + dm.off_path + 4 * p;
    const long long wi = ln.e * dm.w + path[1] + ln.u;
    float wv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      wv[s] = (ps.x.out[s] || ps.sh.out[s]) && ln.active
                  ? __ldcs(ps.W[s] + wi)
                  : 0.f;
    const float* gp = ln.g + path[0];
    const int* seg = plan + dm.off_pair + path[2];
    if constexpr (NS == 1) {
      // the first-order backward in the plain composition's order
      // (ops/fused_conv.py, cg_modes): the x and sh jobs contract
      // gw = g * w, rounded, with the couplings; the w job adds
      // X[i] * S[j] * sum c * g of each (i, j)
      float a[D1][D2];
      float wo = 0.f;
#pragma unroll
      for (int i = 0; i < D1; ++i) {
#pragma unroll
        for (int j = 0; j < D2; ++j) {
          float acc = 0.f, acc_g = 0.f;
          const int q1 = seg[i * D2 + j + 1];
#pragma unroll 4
          for (int q = seg[i * D2 + j]; q < q1; ++q) {
            const int2 c = coup[q];
            const float cf = __int_as_float(c.y);
            const float g = __ldg(gp + c.x);
            acc = fmaf(cf, __fmul_rn(g, wv[0]), acc);
            acc_g = fmaf(cf, g, acc_g);
          }
          a[i][j] = acc;
          wo = fmaf(xs[0][i] * sv[0][j], acc_g, wo);
        }
      }
      if (ps.x.out[0]) {
#pragma unroll
        for (int i = 0; i < D1; ++i) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < D2; ++j) t = fmaf(sv[0][j], a[i][j], t);
          accx[0][i] = __fadd_rn(accx[0][i], t);
        }
      }
      if (ps.sh.out[0]) {
#pragma unroll
        for (int j = 0; j < D2; ++j) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < D1; ++i) t = fmaf(xs[0][i], a[i][j], t);
          acc_sh[0][j] = __fadd_rn(acc_sh[0][j], t);
        }
      }
      if (ps.w.out[0] && ln.active) {
        const float v[NS] = {wo};
        emit<NS>(ps.w, wi, v);
      }
      continue;
    }
    float a[D1][D2];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
#pragma unroll
      for (int j = 0; j < D2; ++j) {
        float acc = 0.f;
        const int q1 = seg[i * D2 + j + 1];
#pragma unroll 4
        for (int q = seg[i * D2 + j]; q < q1; ++q) {
          const int2 c = coup[q];
          acc = fmaf(__int_as_float(c.y), __ldg(gp + c.x), acc);
        }
        a[i][j] = acc;
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (ps.x.out[s]) {
#pragma unroll
        for (int i = 0; i < D1; ++i) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < D2; ++j) t = fmaf(sv[s][j], a[i][j], t);
          accx[s][i] = fmaf(wv[s], t, accx[s][i]);
        }
      }
      if (ps.sh.out[s]) {
#pragma unroll
        for (int j = 0; j < D2; ++j) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < D1; ++i) t = fmaf(xs[s][i], a[i][j], t);
          acc_sh[s][j] = fmaf(wv[s], t, acc_sh[s][j]);
        }
      }
    }
    if (live<NS>(ps.w)) {
      float wo[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float t = 0.f;
        if (ps.w.out[s]) {
#pragma unroll
          for (int i = 0; i < D1; ++i) {
            float r = 0.f;
#pragma unroll
            for (int j = 0; j < D2; ++j)
              r = fmaf(sv[ws<NS>(s)][j], a[i][j], r);
            t = fmaf(xs[s][i], r, t);
          }
        }
        wo[s] = t;
      }
      if (ln.active) emit<NS>(ps.w, wi, wo);
    }
  }
  // the channels' sh partials: a fixed butterfly, then one store a warp
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (ps.sh.out[s]) {
#pragma unroll
      for (int j = 0; j < D2; ++j) {
        float v = acc_sh[s][j];
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (ln.lane == 0)
          red[((ln.el * dm.n_slice + ln.slice) * NS + s) * dm.sh + sh_off +
              j] = v;
      }
    }
  }
}

template <int NS, int D1>
__device__ __forceinline__ void run_chunk(
    const int* __restrict__ plan, const int* chunk, const int* desc,
    int lane, const float* __restrict__ ybar, const int* __restrict__ dst,
    const Pass& ps, const Dims& dm, float* red, long long e0, int te) {
  const int x_off = chunk[0];
  const int mul = chunk[2];
  const float zero[NS] = {};
  Lane ln;
  ln.lane = lane;
  ln.active = desc[1] + lane < mul;
  ln.u = ln.active ? desc[1] + lane : mul - 1;
  ln.slice = chunk[5] + desc[1] / kWarp;
  for (int el = desc[2]; el < te; el += desc[3]) {
    ln.e = e0 + el;
    ln.el = el;
    const long long xe = ln.e * dm.x + x_off + ln.u;
    const int node = __ldg(dst + ln.e);
    if (node >= dm.n_node) {  // sentinel: zero cotangents, no leg read
      if (ln.active) {
#pragma unroll
        for (int i = 0; i < D1; ++i) emit<NS>(ps.x, xe + i * mul, zero);
        for (int g = chunk[3]; g < chunk[4]; ++g) {
          const int* grp = plan + dm.off_group + 4 * g;
          for (int p = grp[2]; p < grp[3]; ++p)
            emit<NS>(ps.w,
                     ln.e * dm.w + plan[dm.off_path + 4 * p + 1] + ln.u,
                     zero);
        }
      }
      continue;
    }
    ln.g = ybar + static_cast<long long>(node) * dm.msg + ln.u;
    float xs[NS][D1], accx[NS][D1];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool need = (ps.sh.out[s] || ps.w.out[s]) && ln.active;
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        xs[s][i] = need ? __ldcs(ps.X[s] + xe + i * mul) : 0.f;
        accx[s][i] = 0.f;
      }
    }
    for (int g = chunk[3]; g < chunk[4]; ++g) {
      const int* grp = plan + dm.off_group + 4 * g;
      switch (grp[1]) {
        case 1:
          run_group<NS, D1, 1>(plan, grp, ln, ps, dm, red, xs, accx);
          break;
        case 3:
          run_group<NS, D1, 3>(plan, grp, ln, ps, dm, red, xs, accx);
          break;
        case 5:
          run_group<NS, D1, 5>(plan, grp, ln, ps, dm, red, xs, accx);
          break;
        default:
          run_group<NS, D1, 7>(plan, grp, ln, ps, dm, red, xs, accx);
          break;
      }
    }
    if (ln.active && live<NS>(ps.x)) {
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        float v[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) v[s] = accx[s][i];
        emit<NS>(ps.x, xe + i * mul, v);
      }
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1) cg_gmulti_kernel(
    const float* __restrict__ ybar, const int* __restrict__ dst,
    const int* __restrict__ plan_g, const __grid_constant__ Pass ps,
    const __grid_constant__ Dims dm) {
  extern __shared__ int smem[];
  int* plan = smem;
  float* red = reinterpret_cast<float*>(smem + dm.plan_len);
  const int red_len = dm.te * dm.n_slice * NS * dm.sh;
  for (int q = threadIdx.x; q < dm.plan_len; q += blockDim.x)
    plan[q] = plan_g[q];
  const long long e0 = static_cast<long long>(blockIdx.x) * dm.te;
  const int te = static_cast<int>(
      e0 + dm.te <= dm.n_edge ? dm.te : dm.n_edge - e0);
  for (int q = threadIdx.x; q < red_len; q += blockDim.x) red[q] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  for (int d = threadIdx.x / kWarp; d < dm.n_desc;
       d += blockDim.x / kWarp) {
    const int* desc = plan + dm.off_desc + 4 * d;
    const int* chunk = plan + dm.off_chunk + 6 * desc[0];
    switch (chunk[1]) {
      case 1:
        run_chunk<NS, 1>(plan, chunk, desc, lane, ybar, dst, ps, dm, red, e0,
                         te);
        break;
      case 3:
        run_chunk<NS, 3>(plan, chunk, desc, lane, ybar, dst, ps, dm, red, e0,
                         te);
        break;
      case 5:
        run_chunk<NS, 5>(plan, chunk, desc, lane, ybar, dst, ps, dm, red, e0,
                         te);
        break;
      default:
        run_chunk<NS, 7>(plan, chunk, desc, lane, ybar, dst, ps, dm, red, e0,
                         te);
        break;
    }
  }
  if (!live<NS>(ps.sh)) return;
  __syncthreads();
  // sh outputs: each job's slices added in order
  const int per_edge = dm.n_slice * NS * dm.sh;
  for (int q = threadIdx.x; q < te * dm.sh; q += blockDim.x) {
    const int el = q / dm.sh;
    const int col = q - el * dm.sh;
    const float* r = red + el * per_edge + col;
    float v[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float p = 0.f;
      if (ps.sh.out[s]) {
        for (int sl = 0; sl < dm.n_slice; ++sl)
          p += r[(sl * NS + s) * dm.sh];
      }
      v[s] = p;
    }
    emit<NS>(ps.sh, (e0 + el) * dm.sh + col, v);
  }
}

// The passes of one launch of the kernel built for NS slots; the
// arguments are those of cg_gmulti_f32.  With NS = 1 a pass may fill
// slot 0 only, and the w slot's S leg is S0 or, where that is unset, S1.
template <int NS>
int launch(const float* ybar, const void* const* pool_ptrs, int n_pool,
           void* const* out_ptrs, int n_out, const int* dst, const int* plan,
           const int* plan_meta, const int* passes, int n_pass, int n_edge,
           int n_node, int dim_x, int dim_sh, int dim_w, int dim_msg,
           int edges_per_block, void* stream) {
  if (edges_per_block < 1 || n_pool < 1 || n_pool > kMaxPool || n_out < 1 ||
      n_out > kMaxOut || n_pass < 1 || plan_meta[1] < 1 ||
      plan_meta[7] % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims dm;
  dm.x = dim_x;
  dm.sh = dim_sh;
  dm.w = dim_w;
  dm.msg = dim_msg;
  dm.n_edge = n_edge;
  dm.n_node = n_node;
  dm.te = edges_per_block;
  dm.n_desc = plan_meta[1];
  dm.n_slice = plan_meta[2];
  dm.off_chunk = plan_meta[3];
  dm.off_group = plan_meta[4];
  dm.off_path = plan_meta[5];
  dm.off_pair = plan_meta[6];
  dm.off_coup = plan_meta[7];
  dm.off_desc = plan_meta[8];
  dm.plan_len = plan_meta[9];
  const size_t smem =
      (static_cast<size_t>(dm.plan_len) +
       static_cast<size_t>(dm.te) * dm.n_slice * NS * dm.sh) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cg_gmulti_kernel<NS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  for (int q = 0; q < n_pass; ++q) {
    const int* pr = passes + 18 * q;
    Pass ps;
    const float** legs[3] = {ps.X, ps.S, ps.W};
    for (int l = 0; l < 3 * kSlots; ++l) {
      const int idx = pr[l];
      if (idx >= n_pool) return static_cast<int>(cudaErrorInvalidValue);
      legs[l / kSlots][l % kSlots] =
          idx < 0 ? nullptr : static_cast<const float*>(pool_ptrs[idx]);
    }
    Mode* modes[3] = {&ps.x, &ps.sh, &ps.w};
    for (int m = 0; m < 3; ++m) {
      Mode& md = *modes[m];
      for (int s = 0; s < kSlots; ++s) {
        const int grp = pr[6 + (m * kSlots + s) * 2];
        if (grp >= n_out) return static_cast<int>(cudaErrorInvalidValue);
        md.out[s] = grp < 0 ? nullptr : static_cast<float*>(out_ptrs[grp]);
        md.add[s] = pr[7 + (m * kSlots + s) * 2] > 0;
      }
      md.same = md.out[0] != nullptr && md.out[0] == md.out[1];
    }
    if (NS == 1) {
      // one slot: nothing in slot 1, and the w job's S leg moves to S0
      if (ps.x.out[1] || ps.sh.out[1] || ps.w.out[1] || ps.X[1] ||
          ps.W[1] || (ps.S[0] && ps.S[1] && ps.S[0] != ps.S[1])) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (!ps.S[0]) ps.S[0] = ps.S[1];
      ps.S[1] = nullptr;
    }
    // every live slot has its legs: x (S[s], W[s]), sh (X[s], W[s]),
    // w (X[s], S[ws(s)])
    for (int s = 0; s < NS; ++s) {
      if ((ps.x.out[s] && (!ps.S[s] || !ps.W[s])) ||
          (ps.sh.out[s] && (!ps.X[s] || !ps.W[s])) ||
          (ps.w.out[s] && (!ps.X[s] || !ps.S[ws<NS>(s)]))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (n_edge > 0) {
      const int warps = dm.n_desc < kMaxWarps ? dm.n_desc : kMaxWarps;
      const int blocks = (n_edge + edges_per_block - 1) / edges_per_block;
      cg_gmulti_kernel<NS><<<blocks, warps * kWarp, smem,
                             static_cast<cudaStream_t>(stream)>>>(
          ybar, dst, plan, ps, dm);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// pool_ptrs: host array of n_pool device pointers (edge arrays); out_ptrs:
// host array of the n_out group outputs; plan: the device copy of
// GMultiPlan.packed(); plan_meta: host array (n_chunk, n_desc, n_slice,
// offsets of chunks, groups, paths, pair starts, couplings, descs, plan
// length); passes: host array [n_pass][18]: the pool indices of legs X0,
// X1, S0, S1, W0, W1, then (group, add) of each slot of the x, sh and w
// modes, -1 where unused (ops/cg_tables.py, gmulti_passes).  One launch
// per pass.
extern "C" int cg_gmulti_f32(const float* ybar, const void* const* pool_ptrs,
                             int n_pool, void* const* out_ptrs, int n_out,
                             const int* dst, const int* plan,
                             const int* plan_meta, const int* passes,
                             int n_pass, int n_edge, int n_node, int dim_x,
                             int dim_sh, int dim_w, int dim_msg,
                             int edges_per_block, void* stream) {
  return launch<2>(ybar, pool_ptrs, n_pool, out_ptrs, n_out, dst, plan,
                   plan_meta, passes, n_pass, n_edge, n_node, dim_x, dim_sh,
                   dim_w, dim_msg, edges_per_block, stream);
}

// The first-order backward's jobs (pool [x, sh, w], one job of each emit
// mode at most, each its own group): the arguments of cg_gmulti_f32, the
// kernel built for one slot.
extern "C" int cg_multi_f32(const float* ybar, const void* const* pool_ptrs,
                            int n_pool, void* const* out_ptrs, int n_out,
                            const int* dst, const int* plan,
                            const int* plan_meta, const int* passes,
                            int n_pass, int n_edge, int n_node, int dim_x,
                            int dim_sh, int dim_w, int dim_msg,
                            int edges_per_block, void* stream) {
  return launch<1>(ybar, pool_ptrs, n_pool, out_ptrs, n_out, dst, plan,
                   plan_meta, passes, n_pass, n_edge, n_node, dim_x, dim_sh,
                   dim_w, dim_msg, edges_per_block, stream);
}
