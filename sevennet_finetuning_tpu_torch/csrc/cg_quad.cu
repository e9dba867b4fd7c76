// Per-edge quadrilinear family ('cg_quad'): one mode of the uvu CG
// convolution for every edge slot, with no aggregation.  Per path p (an x
// chunk of d1 x mul, an sh irrep of d2, an output irrep of d3, mul
// channels u) and coupling (k, i, j, c) of p, with
//     B[k][i] = sum_j c * sh[j]   (per edge and path, not per channel)
// and g the cotangent at the message leg, the modes are
//   msg: (x, sh, w) -> [E, dim_msg]  m[k, u] = sum_i x[i, u] B[k][i],
//                                    msg[msg_off + k*mul + u] = m[k, u] w[u]
//   x:   (g, sh, w) -> [E, dim_x]    x[x_off + i*mul + u] = sum over the
//                                    chunk's paths, k of B[k][i] gw[k, u],
//                                    gw = g[k, u] w[u]
//   sh:  (g, x, w)  -> [E, dim_sh]   sh[sh_off + j] = sum over u, the
//                                    group's paths and their couplings of
//                                    c x[i, u] gw[k, u]
//   w:   (g, x, sh) -> [E, dim_w]    w[w_off + u] = sum_k m[k, u] g[k, u]
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_kernel.py, pallas_impl ->
// _build_call -> its pallas_call (per 128-edge tile, feature-major, the
// couplings unrolled into vector multiply-adds at trace time).
//
// Bound on the H100: memory.  Every mode reads three legs and writes the
// fourth once per edge: 18,340 bytes an edge at SevenNet-0's interior
// block, against a few thousand fp32 operations once B is shared by the
// channels.
//
// Design: the function is built on channels, as cg_agg.cu and
// cg_gmulti.cu are.  A block walks a contiguous run of edge tiles (the
// grid is persistent: as many blocks as fit the card at once, each a
// near-equal share of the tiles) through a ring of `stages` stages in
// shared memory.  One thread issues each tile's three legs as bulk
// asynchronous copies (cp.async.bulk, completion on the stage's
// mbarrier) `stages` - 1 tiles ahead of the tile being computed; a bulk
// copy needs a 16-byte aligned source, destination and size, so each
// leg's tile is copied as its enclosing 16-byte span and read at an
// offset (the sh rows are 9 floats; ops/cg_tables.py, agg_span), and
// rows that reach into the array's last partial 16 bytes are finished by
// plain loads.  Per tile, the block first forms every edge's B rows (an
// entry a (path, k, i), the path's couplings from the staged sh row) in
// shared memory, then each warp runs its items (ops/cg_tables.py,
// quad_plan): an item is a unit, 32 channels of one x chunk (a lane is a
// channel), and one edge of the tile; the items go to the warps by
// estimated cost.  A unit is one path in the msg and w modes, every
// group of the chunk in the x mode, one group in the sh mode.  Lanes read
// the staged legs on consecutive channels (no bank conflicts) and B by
// broadcast as float4s, and write the msg, x and w outputs along u, one
// writer a column.  The sh mode has d2 outputs a group: each lane sums
// its channel's part over the group's paths, with each path's couplings
// at the entries of the real-basis Wigner-3j selection rule, which the
// kernel knows at compile time (quad_nz), their values copied once into
// shared memory and read by broadcast.  Reading the sparse coupling list
// lane by lane (its offsets, then the coupling, then g: dependent loads)
// made the mode several times slower than the others on an H100; dense
// [d1][d2][d3] blocks cost 4.3 times the multiply-adds at SevenNet-0's
// interior block (0.46 against 0.40 ms, tools/quad_sweep.py).  An sh
// item takes two edges of the tile where the tile has them (the
// coefficients' loads serve both, and the second chain of arithmetic
// hides the first's latency); the warp adds its lanes by a fixed xor
// butterfly, and lane 0 stores the slice's partial in shared memory;
// after the next tile's barrier the block adds each column's partials,
// per group its slices in order and the groups in group order (as
// cg_modes assembles them), and writes the column.
// No atomics and a fixed order: every launch gives the same bits.
//
// Rounding: the order of the plain composition (ops/fused_conv.py,
// cg_modes, a port of JAX's), where it is cheap to keep.  B is formed by
// fma.  msg: m = sum_i rn(x B), each product rounded before its add, then
// rn(m w).  w: the same m, then sum_k rn(m g).  x: gw = rn(g w), then
// fma(B, gw) over each group's paths and k, the groups added rounded in
// order.  sh: gw = rn(g w), A[i][j] = fma(c, gw) over the couplings' k,
// then fma(x[i], A[i][j]) over i, added rounded path by path
// (cg_gmulti.cu's first-order sh job).  The intrinsics keep nvcc from
// contracting the rounded products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;  // cg_tables.QUAD_MAX_WARPS warps
constexpr int kMaxStages = 8;     // cg_tables.QUAD_MAX_STAGES
constexpr int kUnit = 7;          // cg_tables.QUAD_UNIT
constexpr int kPath = 5;          // cg_tables.QUAD_PATH
constexpr int kEntry = 16;        // cg_tables.AGG_ENTRY
constexpr int kMaxSteps = 7;      // cg_tables.AGG_MAX_STEPS
constexpr int kMaxTile = 64;      // cg_tables.QUAD_MAX_TILE
// shared memory of a block: 232,448 bytes, of which the static mbarriers
// take 64 (cg_tables.QUAD_SMEM_MAX)
constexpr int kSmemMax = 232448;
constexpr int kStaticSmem = 64;
constexpr int kModes = 4;         // msg, x, sh, w (cg_tables.QUAD_MODES)
constexpr int kMsg = 0, kX = 1, kSh = 2, kW = 3;

struct Args {
  const float* leg[3];     // the mode's legs in _MODE_LEGS order
  const int* plan;         // cg_tables.QuadPlan.packed()
  float* out;              // [n_edge, d_out]
  long long n_leg[3];      // floats of each leg
  int dim[3];
  int n_edge, d_out;
  int tile, stages, n_tile;
  // shared memory in floats (cg_tables.quad_smem)
  int cap[3];
  int stage, b_base, red_base, b_row, red_row, coef_base;
  // the plan's sections (cg_tables.QuadPlan.packed's meta)
  int n_entry, units, groups, paths, entries, warp_start, items, col_start,
      col_parts, coef, n_coef;
};

// which leg (index into Args::leg) holds x, sh, w and g in each mode
// (ops/fused_conv.py, _MODE_LEGS): msg (x, sh, w), x (g, sh, w),
// sh (g, x, w), w (g, x, sh)
template <int M> struct Legs;
template <> struct Legs<kMsg> {
  static constexpr int X = 0, S = 1, W = 2, G = -1;
};
template <> struct Legs<kX> {
  static constexpr int X = -1, S = 1, W = 2, G = 0;
};
template <> struct Legs<kSh> {
  static constexpr int X = 1, S = -1, W = 2, G = 0;
};
template <> struct Legs<kW> {
  static constexpr int X = 1, S = 2, W = -1, G = 0;
};

// Runs the statement with NAME bound to the irrep dim d as a constant:
// 1, 3, 5 and, where the kernel is built for them (MD = 7), 7.  A kernel
// built for dims up to 5 (every layout of lmax <= 2) leaves out the
// largest instances, whose registers would otherwise set the whole
// kernel's
#define QUAD_DIMS(d, MD, NAME, ...)                     \
  switch (d) {                                          \
    case 1: { constexpr int NAME = 1; __VA_ARGS__; } break; \
    case 3: { constexpr int NAME = 3; __VA_ARGS__; } break; \
    case 5: { constexpr int NAME = 5; __VA_ARGS__; } break; \
    default:                                            \
      if constexpr (MD >= 7) {                          \
        constexpr int NAME = 7;                         \
        __VA_ARGS__;                                    \
      } else {                                          \
        __trap();                                       \
      }                                                 \
  }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// a stage's copies land in microseconds: a wait of ~2^30 polls is a
// fault (a copy that was never issued), which traps as a launch error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst_smem)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The staging of rows [e0, e0 + ne) of an array of width dim (cg_tables.
// agg_span): floats [a0, a0 + bulk) by a bulk copy, [a0 + bulk, f1) by
// plain loads, float f to buf[f - a0]; row 0 starts at buf[off].
struct Span {
  long long a0, bulk, f1;
  int off;
};

__device__ __forceinline__ Span span_of(long long e0, int ne, int dim,
                                        long long total) {
  const long long f0 = e0 * dim;
  const long long f1 = (e0 + ne) * dim;
  const long long a0 = f0 & ~3LL;
  long long a1 = (f1 + 3) & ~3LL;
  const long long last = total & ~3LL;
  if (a1 > last) a1 = last;
  Span s;
  s.a0 = a0;
  s.bulk = a1 > a0 ? a1 - a0 : 0;
  s.f1 = f1;
  s.off = static_cast<int>(f0 - a0);
  return s;
}

// thread 0: local tile c (edges from e_begin) into its stage
__device__ void issue_tile(const Args& a, float* smem, uint64_t* full,
                           long long e_begin, long long e_end, int c) {
  const long long e0 = e_begin + static_cast<long long>(c) * a.tile;
  const int ne = static_cast<int>(min(static_cast<long long>(a.tile),
                                      e_end - e0));
  const int s = c % a.stages;
  float* buf = smem + s * a.stage;
  Span sp[3];
  uint32_t bytes = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    sp[l] = span_of(e0, ne, a.dim[l], a.n_leg[l]);
    bytes += static_cast<uint32_t>(sp[l].bulk * 4);
  }
  // the stage's earlier reads (generic proxy) before the copies' writes
  // (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* b = buf;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    for (long long f = sp[l].a0 + sp[l].bulk; f < sp[l].f1; ++f)
      b[f - sp[l].a0] = a.leg[l][f];
    b += a.cap[l];
  }
  // the arrive releases the tails' plain stores to the waiting threads
  mbar_expect_tx(&full[s], bytes);
  b = buf;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    if (sp[l].bulk)
      bulk_load(b, a.leg[l] + sp[l].a0,
                static_cast<uint32_t>(sp[l].bulk * 4), &full[s]);
    b += a.cap[l];
  }
}

// One lane's view of an item: the edge's staged rows (row 0 of each leg
// already offset to the lane's channel where the leg runs along u), its B
// row and output row
struct Lane {
  const float* row[3];   // staged rows of the edge, each leg
  const float* br;       // B row of the edge
  float* o;              // output row of the edge
  int u;                 // channel (clamped into the chunk for idle lanes)
  int mul;
  bool active;
};

// B[k][i] of one path as floats, loaded as float4s (a path's block starts
// 16-byte aligned)
template <int D1, int D3>
__device__ __forceinline__ void load_b(const float* bp,
                                       float (&b)[((D1 * D3 + 3) / 4) * 4]) {
  constexpr int NB = (D1 * D3 + 3) / 4;
  const float4* b4 = reinterpret_cast<const float4*>(bp);
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const float4 v = b4[q];
    b[4 * q] = v.x;
    b[4 * q + 1] = v.y;
    b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
}

// m[k] = sum_i rn(x[i] B[k][i]), each product rounded before its add
template <int D1, int D3>
__device__ __forceinline__ void messages(const float* xr, int mul,
                                         const float* bp, float (&m)[D3]) {
  float xv[D1], b[((D1 * D3 + 3) / 4) * 4];
#pragma unroll
  for (int i = 0; i < D1; ++i) xv[i] = xr[i * mul];
  load_b<D1, D3>(bp, b);
#pragma unroll
  for (int k = 0; k < D3; ++k) {
    m[k] = __fmul_rn(b[k * D1], xv[0]);
#pragma unroll
    for (int i = 1; i < D1; ++i)
      m[k] = __fadd_rn(m[k], __fmul_rn(b[k * D1 + i], xv[i]));
  }
}

// msg (M = kMsg) or w (M = kW) of one path
template <int M, int D1, int D3>
__device__ __forceinline__ void path_item(const Args& a, const Lane& ln,
                                          int x_off, const int* path) {
  const int msg_off = __ldg(path);
  const int w_off = __ldg(path + 1);
  const int b_off = __ldg(path + 3);
  float m[D3];
  messages<D1, D3>(ln.row[Legs<M>::X] + x_off, ln.mul, ln.br + b_off, m);
  if constexpr (M == kMsg) {
    const float wv = ln.row[Legs<M>::W][w_off];
    if (ln.active) {
#pragma unroll
      for (int k = 0; k < D3; ++k)
        ln.o[msg_off + k * ln.mul] = __fmul_rn(m[k], wv);
    }
  } else {
    const float* gr = ln.row[Legs<M>::G] + msg_off;
    float acc = __fmul_rn(m[0], gr[0]);
#pragma unroll
    for (int k = 1; k < D3; ++k)
      acc = __fadd_rn(acc, __fmul_rn(m[k], gr[k * ln.mul]));
    if (ln.active) ln.o[w_off] = acc;
  }
}

template <int M, int MD, int D1>
__device__ __forceinline__ void path_d3(const Args& a, const Lane& ln,
                                        int x_off, const int* path) {
  QUAD_DIMS(__ldg(path + 2), MD, D3, path_item<M, D1, D3>(a, ln, x_off, path))
}

// x: t[i] += sum_k B[k][i] rn(g[k] w) over one path
template <int D1, int D3>
__device__ __forceinline__ void x_path(const Lane& ln, const int* path,
                                       float (&t)[D1]) {
  const int msg_off = __ldg(path);
  const int w_off = __ldg(path + 1);
  const int b_off = __ldg(path + 3);
  const float wv = ln.row[Legs<kX>::W][w_off];
  const float* gr = ln.row[Legs<kX>::G] + msg_off;
  float b[((D1 * D3 + 3) / 4) * 4];
  load_b<D1, D3>(ln.br + b_off, b);
#pragma unroll
  for (int k = 0; k < D3; ++k) {
    const float gw = __fmul_rn(gr[k * ln.mul], wv);
#pragma unroll
    for (int i = 0; i < D1; ++i) t[i] = fmaf(b[k * D1 + i], gw, t[i]);
  }
}

// x of one chunk slice: its groups in order, each group's paths summed
// by fma, the groups added rounded
template <int MD, int D1>
__device__ __forceinline__ void x_item(const Args& a, const Lane& ln,
                                       const int* unit) {
  const int x_off = __ldg(unit);
  float acc[D1];
#pragma unroll
  for (int i = 0; i < D1; ++i) acc[i] = 0.f;
  for (int g = __ldg(unit + 4); g < __ldg(unit + 5); ++g) {
    const int* grp = a.plan + a.groups + 4 * g;
    float t[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) t[i] = 0.f;
    for (int p = __ldg(grp + 2); p < __ldg(grp + 3); ++p) {
      const int* path = a.plan + a.paths + kPath * p;
      QUAD_DIMS(__ldg(path + 2), MD, D3, x_path<D1, D3>(ln, path, t))
    }
#pragma unroll
    for (int i = 0; i < D1; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
  }
  if (ln.active) {
#pragma unroll
    for (int i = 0; i < D1; ++i) ln.o[x_off + i * ln.mul] = acc[i];
  }
}

// (i, j, k) may be nonzero in a real-basis Wigner-3j block of irrep dims
// d1 x d2 -> d3 (the twin of ops/cg_tables.py, w3j_pattern): with l =
// d / 2 and m = index - l, |m3| is |m1| + |m2| or ||m1| - |m2||, and the
// negative m's and l1 + l2 + l3 have an even sum
__host__ __device__ constexpr bool quad_nz(int d1, int d2, int d3, int i,
                                           int j, int k) {
  const int l1 = d1 / 2, l2 = d2 / 2, l3 = d3 / 2;
  const int m1 = i < l1 ? l1 - i : i - l1;
  const int m2 = j < l2 ? l2 - j : j - l2;
  const int m3 = k < l3 ? l3 - k : k - l3;
  const int neg = (i < l1) + (j < l2) + (k < l3);
  return (m3 == m1 + m2 || m3 == (m1 > m2 ? m1 - m2 : m2 - m1)) &&
         (neg + l1 + l2 + l3) % 2 == 0;
}

// the block's pattern: each (i, j, k)'s place among a path's
// coefficients (-1 where the block is zero), and their count
template <int D1, int D2, int D3>
struct W3j {
  int at[D1 * D2 * D3];
  int n;
};

template <int D1, int D2, int D3>
__host__ __device__ constexpr W3j<D1, D2, D3> w3j_pattern() {
  W3j<D1, D2, D3> p{};
  int n = 0;
  for (int q = 0; q < D1 * D2 * D3; ++q) {
    p.at[q] = quad_nz(D1, D2, D3, q / (D2 * D3), q / D3 % D2, q % D3) ? n++
                                                                      : -1;
  }
  p.n = n;
  return p;
}

// sh: acc[r][j] += sum_i x[i] sum_k C[i][j][k] rn(g[k] w) over one path
// for R consecutive edges r of the tile.  The path's coefficients (its
// block at the pattern's entries, in shared memory) are read by broadcast
// as float4s once for the R edges; the pattern is known here at compile
// time, so the block's zeros cost nothing
template <int D1, int D2, int D3, int R>
__device__ __forceinline__ void sh_path(const Args& a, const Lane& ln,
                                        const int* path, const float* coef,
                                        const float (&xv)[R][D1],
                                        float (&acc)[R][D2]) {
  constexpr W3j<D1, D2, D3> P = w3j_pattern<D1, D2, D3>();
  // dims that break the triangle rule have no coupling (and no path)
  if constexpr (P.n == 0) return;
  constexpr int NC = P.n > 0 ? (P.n + 3) / 4 * 4 : 4;
  const int dg = a.dim[Legs<kSh>::G];
  const int dw = a.dim[Legs<kSh>::W];
  const float* wr = ln.row[Legs<kSh>::W] + __ldg(path + 1);
  const float* gr = ln.row[Legs<kSh>::G] + __ldg(path);
  const float4* cp = reinterpret_cast<const float4*>(coef + __ldg(path + 4));
  float c[NC], gw[R][D3], t[R][D2];
#pragma unroll
  for (int q = 0; q < NC / 4; ++q) {
    const float4 v = cp[q];
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float wv = wr[r * dw];
#pragma unroll
    for (int k = 0; k < D3; ++k)
      gw[r][k] = __fmul_rn(gr[r * dg + k * ln.mul], wv);
#pragma unroll
    for (int j = 0; j < D2; ++j) t[r][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < D1; ++i) {
#pragma unroll
    for (int j = 0; j < D2; ++j) {
      bool hit = false;
#pragma unroll
      for (int k = 0; k < D3; ++k)
        hit = hit || P.at[(i * D2 + j) * D3 + k] >= 0;
      if (!hit) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < D3; ++k) {
          const int q = P.at[(i * D2 + j) * D3 + k];
          if (q >= 0) s = fmaf(c[q], gw[r][k], s);
        }
        t[r][j] = fmaf(xv[r][i], s, t[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < D2; ++j) acc[r][j] = __fadd_rn(acc[r][j], t[r][j]);
  }
}

// sh of one group slice for R consecutive edges: each lane's part over
// the group's paths, the lanes added by a fixed xor butterfly, lane 0's
// sums to the edges' partials
template <int MD, int D1, int D2, int R>
__device__ __forceinline__ void sh_item(const Args& a, const Lane& ln,
                                        const int* unit, const float* coef,
                                        float* red, int lane) {
  const int x_off = __ldg(unit);
  const int* grp = a.plan + a.groups + 4 * __ldg(unit + 4);
  const int dx = a.dim[Legs<kSh>::X];
  const float* xr = ln.row[Legs<kSh>::X] + x_off;
  float xv[R][D1], acc[R][D2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < D1; ++i)
      xv[r][i] = ln.active ? xr[r * dx + i * ln.mul] : 0.f;
#pragma unroll
    for (int j = 0; j < D2; ++j) acc[r][j] = 0.f;
  }
  for (int p = __ldg(grp + 2); p < __ldg(grp + 3); ++p) {
    const int* path = a.plan + a.paths + kPath * p;
    QUAD_DIMS(__ldg(path + 2), MD, D3,
              sh_path<D1, D2, D3, R>(a, ln, path, coef, xv, acc))
  }
  const int q = __ldg(unit + 6);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < D2; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) red[r * a.red_row + q + j] = v;
    }
  }
}

template <int MD, int D1, int R>
__device__ __forceinline__ void sh_d2(const Args& a, const Lane& ln,
                                      const int* unit, const float* coef,
                                      float* red, int lane) {
  QUAD_DIMS(__ldg(a.plan + a.groups + 4 * __ldg(unit + 4) + 1), MD, D2,
            sh_item<MD, D1, D2, R>(a, ln, unit, coef, red, lane))
}

// one item; in the sh mode `pair`: the item's edge and the next
template <int M, int MD, int D1>
__device__ __forceinline__ void run_item(const Args& a, const Lane& ln,
                                         const int* unit, const float* coef,
                                         float* red, int lane, bool pair) {
  if constexpr (M == kX) {
    x_item<MD, D1>(a, ln, unit);
  } else if constexpr (M == kSh) {
    if (pair) {
      sh_d2<MD, D1, 2>(a, ln, unit, coef, red, lane);
    } else {
      sh_d2<MD, D1, 1>(a, ln, unit, coef, red, lane);
    }
  } else {
    path_d3<M, MD, D1>(a, ln, __ldg(unit),
                   a.plan + a.paths + kPath * __ldg(unit + 4));
  }
}

// the sh columns of the tile's ne edges from their partials (red rows
// of red_row floats): per group covering the column, in group order, its
// slices in order; a column no group covers is 0
__device__ __forceinline__ void sh_combine(const Args& a, const float* red,
                                           long long e0, int ne) {
  const int* start = a.plan + a.col_start;
  const int* parts = a.plan + a.col_parts;
  for (int q = threadIdx.x; q < ne * a.d_out; q += blockDim.x) {
    const int le = q / a.d_out;
    const int col = q - le * a.d_out;
    const float* rr = red + le * a.red_row;
    float v = 0.f;
    for (int p = __ldg(start + col); p < __ldg(start + col + 1); ++p) {
      const int first = __ldg(parts + 3 * p);
      const int n = __ldg(parts + 3 * p + 1);
      const int stride = __ldg(parts + 3 * p + 2);
      float s = rr[first];
      for (int t = 1; t < n; ++t) s = __fadd_rn(s, rr[first + t * stride]);
      v = __fadd_rn(v, s);
    }
    a.out[(e0 + le) * a.d_out + col] = v;
  }
}

template <int M, int MD>
__global__ void __launch_bounds__(kMaxThreads)
    cg_quad_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[kMaxStages];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  // this block's tiles [t0, t1) of the launch's n_tile
  const long long t0 = static_cast<long long>(blockIdx.x) * a.n_tile /
                       gridDim.x;
  const long long t1 = static_cast<long long>(blockIdx.x + 1) * a.n_tile /
                       gridDim.x;
  const long long e_begin = t0 * a.tile;
  const long long e_end = min(static_cast<long long>(a.n_edge), t1 * a.tile);
  const int n_tile = static_cast<int>(t1 - t0);

  // the sh mode's path coefficients, read by every tile
  float* coef = smem + a.coef_base;
  if constexpr (M == kSh) {
    for (int q = tid; q < a.n_coef; q += blockDim.x)
      coef[q] = __int_as_float(__ldg(a.plan + a.coef + q));
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < a.stages && c < n_tile; ++c)
      issue_tile(a, smem, full, e_begin, e_end, c);
  }
  const int it_begin = __ldg(a.plan + a.warp_start + warp);
  const int it_end = __ldg(a.plan + a.warp_start + warp + 1);
  const int* ent = a.plan + a.entries;

  for (int c = 0; c < n_tile; ++c) {
    const int s = c % a.stages;
    const long long e0 = e_begin + static_cast<long long>(c) * a.tile;
    const int ne = static_cast<int>(min(static_cast<long long>(a.tile),
                                        e_end - e0));
    mbar_wait(&full[s], static_cast<uint32_t>((c / a.stages) & 1));
    const float* rows[3];
    {
      const float* buf = smem + s * a.stage;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        rows[l] = buf + span_of(e0, ne, a.dim[l], a.n_leg[l]).off;
        buf += a.cap[l];
      }
    }
    float* bs = smem + a.b_base + (c & 1) * a.tile * a.b_row;
    float* rs = smem + a.red_base + (c & 1) * a.tile * a.red_row;

    if constexpr (M != kSh) {
      // the tile's B rows: entry q of edge le, its couplings in order
      const float* ss = rows[Legs<M>::S];
      const int ds = a.dim[Legs<M>::S];
      for (int q = tid; q < a.n_entry; q += blockDim.x) {
        const int* eq = ent + q * kEntry;
        const int col = __ldg(eq);
        const int steps = __ldg(eq + 1);
        int sj[kMaxSteps];
        float sc[kMaxSteps];
#pragma unroll
        for (int st = 0; st < kMaxSteps; ++st) {
          sj[st] = st < steps ? __ldg(eq + 2 + 2 * st) : 0;
          sc[st] = st < steps ? __int_as_float(__ldg(eq + 3 + 2 * st)) : 0.f;
        }
        for (int le = 0; le < ne; ++le) {
          const float* sr = ss + le * ds;
          float b = 0.f;
#pragma unroll
          for (int st = 0; st < kMaxSteps; ++st) {
            if (st >= steps) break;
            b = fmaf(sc[st], sr[sj[st]], b);
          }
          bs[le * a.b_row + col] = b;
        }
      }
    }
    // the B rows are complete, and every thread is done with tile c - 1
    // (its stage, and in the sh mode its partials' writes)
    __syncthreads();
    if (M == kSh && c >= 1) {
      const long long ep = e0 - a.tile;
      sh_combine(a, smem + a.red_base + ((c - 1) & 1) * a.tile * a.red_row,
                 ep, a.tile);
    }
    if (tid == 0 && c >= 1 && c - 1 + a.stages < n_tile)
      issue_tile(a, smem, full, e_begin, e_end, c - 1 + a.stages);

    for (int it = it_begin; it < it_end; ++it) {
      const int2 item = __ldg(reinterpret_cast<const int2*>(
                                  a.plan + a.items) + it);
      const int le = item.y;
      if (le >= ne) continue;
      const int* unit = a.plan + a.units + kUnit * item.x;
      Lane ln;
      ln.mul = __ldg(unit + 2);
      const int u = __ldg(unit + 3) + lane;
      ln.active = u < ln.mul;
      ln.u = ln.active ? u : ln.mul - 1;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        // the legs along u (x, w, g) at the lane's channel; sh as is
        const bool along_u = l != Legs<M>::S;
        ln.row[l] = rows[l] + le * a.dim[l] + (along_u ? ln.u : 0);
      }
      ln.br = bs + le * a.b_row;
      ln.o = a.out + (e0 + le) * a.d_out + (M == kSh ? 0 : ln.u);
      float* red = rs + le * a.red_row;
      const bool pair = M == kSh && le + 1 < ne;
      QUAD_DIMS(__ldg(unit + 1), MD, D1,
                run_item<M, MD, D1>(a, ln, unit, coef, red, lane, pair))
    }
  }
  if (M == kSh && n_tile > 0) {
    __syncthreads();
    const int c = n_tile - 1;
    const long long e0 = e_begin + static_cast<long long>(c) * a.tile;
    sh_combine(a, smem + a.red_base + (c & 1) * a.tile * a.red_row, e0,
               static_cast<int>(e_end - e0));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

using Kernel = void (*)(Args);
// per mode, built for irrep dims up to 5 and up to 7
const Kernel kKernels[kModes][2] = {
    {cg_quad_kernel<kMsg, 5>, cg_quad_kernel<kMsg, 7>},
    {cg_quad_kernel<kX, 5>, cg_quad_kernel<kX, 7>},
    {cg_quad_kernel<kSh, 5>, cg_quad_kernel<kSh, 7>},
    {cg_quad_kernel<kW, 5>, cg_quad_kernel<kW, 7>}};

}  // namespace

// One mode (0 msg, 1 x, 2 sh, 3 w) on legs a, b, c [n_edge, da / db / dc]
// (16-byte aligned) -> out [n_edge, d_out]; plan: the device copy of
// QuadPlan.packed(), plan_meta its meta (host array); cfg: host array
// (tile, stages, warps, the layout's largest irrep dim); smem: host array
// (cap a, cap b, cap c, stage, b_base, red_base, b_row, red_row,
// coef_base, total floats) (ops/cg_tables.py, quad_plan / quad_smem).
// One launch: as many blocks as the card holds at once (or one a tile, if
// fewer), each a contiguous run of tiles.
extern "C" int cg_quad_f32(int mode, const float* a, const float* b,
                           const float* c, const int* plan,
                           const int* plan_meta, const int* cfg,
                           const int* smem, float* out, int n_edge, int da,
                           int db, int dc, int d_out, void* stream) {
  // per mode and device: the largest dynamic shared memory granted, and
  // the blocks an SM holds at the last (threads, bytes) asked
  static int smem_set[kModes * 2][64] = {};
  static int occ_key[kModes * 2][64][2] = {};
  static int occ_val[kModes * 2][64] = {};
  static int n_sm[64] = {};
  const int tile = cfg[0], stages = cfg[1], warps = cfg[2], max_d = cfg[3];
  const long long bytes = 4LL * smem[9];
  if (mode < 0 || mode >= kModes || tile < 1 || tile > kMaxTile ||
      stages < 2 || stages > kMaxStages || warps < 1 || max_d < 1 ||
      max_d > 7 ||
      warps * kWarp > kMaxThreads || bytes + kStaticSmem > kSmemMax ||
      !aligned16(a) || !aligned16(b) || !aligned16(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 9; ++i) {  // every section starts 16-byte aligned
    if (smem[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_edge <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int kid = mode * 2 + (max_d > 5 ? 1 : 0);
  const Kernel kern = kKernels[mode][kid % 2];
  if (bytes > smem_set[kid][dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[kid][dev] = static_cast<int>(bytes);
  }
  if (n_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = warps * kWarp;
  if (occ_key[kid][dev][0] != threads ||
      occ_key[kid][dev][1] != static_cast<int>(bytes)) {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kern, threads, static_cast<size_t>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_key[kid][dev][0] = threads;
    occ_key[kid][dev][1] = static_cast<int>(bytes);
    occ_val[kid][dev] = occ;
  }
  Args args;
  const float* legs[3] = {a, b, c};
  const int dims[3] = {da, db, dc};
  for (int l = 0; l < 3; ++l) {
    args.leg[l] = legs[l];
    args.dim[l] = dims[l];
    args.n_leg[l] = static_cast<long long>(n_edge) * dims[l];
    args.cap[l] = smem[l];
  }
  args.plan = plan;
  args.out = out;
  args.n_edge = n_edge;
  args.d_out = d_out;
  args.tile = tile;
  args.stages = stages;
  args.n_tile = (n_edge + tile - 1) / tile;
  args.stage = smem[3];
  args.b_base = smem[4];
  args.red_base = smem[5];
  args.b_row = smem[6];
  args.red_row = smem[7];
  args.coef_base = smem[8];
  args.n_entry = plan_meta[0];
  args.units = plan_meta[1];
  args.groups = plan_meta[2];
  args.paths = plan_meta[3];
  args.entries = plan_meta[4];
  args.warp_start = plan_meta[5];
  args.items = plan_meta[6];
  args.col_start = plan_meta[7];
  args.col_parts = plan_meta[8];
  args.coef = plan_meta[9];
  args.n_coef = plan_meta[10];
  const long long fit = static_cast<long long>(n_sm[dev]) * occ_val[kid][dev];
  const int blocks = static_cast<int>(
      args.n_tile < fit ? args.n_tile : fit);
  kern<<<blocks, threads, static_cast<size_t>(bytes),
         static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
