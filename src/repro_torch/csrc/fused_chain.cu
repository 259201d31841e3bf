// Fused-group megakernels for Hopper (sm_90a): a merged graph group's
// stages in ONE persistent cooperative launch.  Two entry points share one
// body:
//
//   fused_chain_launch -- replaces the reference's
//     kernels/fused_chain.py:fused_chain_matmul (_chain_kernel,
//     _stage_kernel): stage j computes x = cast(epi_j(x @ W_j + b_j)).
//   fused_dag_launch   -- replaces kernels/fused_chain.py:fused_dag
//     (_dag_kernel): stage-major DAG of `dot` and `batched` stages, a
//     scratch-sourced rhs read transposed, an fp32 or chain-dtype
//     residual added after the epilogue, tap outputs.
//
// The TPU keeps every intermediate and every weight in VMEM and runs the
// stages as ordered grid phases.  On Hopper neither holds: a CTA has at
// most 227 KB of shared memory and CTAs run in no order.  So the launch is
// cooperative, with the grid sized to the CTAs that can be co-resident
// (one an SM: the 128 x 128 tile takes every register), and the stages run
// as phases separated by cooperative_groups' grid sync.  Intermediates
// live in a global workspace of the chain dtype that the wrapper allocates
// (41 MB for the h2o-danube-1.8b layer at l = 512); every buffer is
// written in one phase and read only in later ones.  Split partials and
// softmax rows go to an fp32 workspace that each level reuses from its
// start (15.7 MB there: 57 MB in all, a little over the 50 MB L2).
//
// What bounds it on the H100: fp32 FLOPs on the CUDA cores at the main
// path's shapes (danube layer at l = 512: 65.8 GFLOP, 0.98 ms at 67
// TFLOP/s; its MLP chain 36.2 GFLOP, 0.54 ms).  The design:
// - a `dot` stage runs the SIMT tile mainloop of simt_tile.cuh, as the
//   output-stationary template's stt_tile_kernel does: operands staged in
//   SLAB_K-deep swizzled slabs double-buffered through registers (the next
//   slab's loads issued before this slab's fma_quads, one barrier a
//   slab), 16-byte loads along each operand's unit-stride axis (the
//   staging mode stage_mode picks from the stage's pointers and strides),
//   float4 fragments;
// - the host's launch plan (kernels/fused_chain.py:launch_plan) groups
//   the stages into dependency levels: a stage runs in the first phase
//   after every stage its lhs, rhs and residual read.  The stages of one
//   level share one list of work items (output tile x k split), spread
//   round-robin over the grid, and one grid sync;
// - each stage has its own CTA tile (128 x 128, or 64 x 64 where the
//   level fills under a wave) and its own k split.  A split stage writes
//   raw fp32 partials; after the grid sync, one thread an output adds
//   them in split order (never atomics: the same bits every call) and
//   flushes -- for a softmax stage inside its row phase, which sums its
//   row's partials before row_epilogue;
// - the stage descriptor lives in shared memory (one thread loads it
//   when a CTA's work moves to another stage), so the mainloop carries no
//   descriptor in registers.
// Each output's partial sums run in ascending k from the split's start,
// one fmaf a product; bf16 operands convert to fp32 at staging.  The
// flush applies the epilogue in fp32, casts, adds the residual in fp32
// and casts again, then writes the stage's output and its tap.  `chain`
// and `stage` interleaves differ on the TPU only in the order of
// m-blocks; here only in the tile raster (m_fast).
//
// Launch contract: runs on the given stream, allocates nothing, and each
// entry point returns the launch's error code.

#include <cooperative_groups.h>

#include "simt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// Stage-table word offsets (int64 words per stage); the Python side's
// fused_chain.FIELDS mirrors this list.
enum Field {
  F_KIND = 0,  // 0 = dot, 1 = batched
  F_M, F_K, F_N,
  F_LHS, F_LS0, F_LS1, F_LS2,  // dot: (m, k); batched: (m, k, n)
  F_RHS, F_RS0, F_RS1,         // dot: (k, n); batched: (m, k)
  F_RES, F_RES0, F_RES1, F_RES_F32,
  F_BIAS, F_OUT, F_TAP,
  F_TILE,     // CTA tile edge of a dot stage (64 or 128)
  F_SPLIT,    // k splits (1: none)
  F_KCHUNK,   // k extent of a split, a multiple of SLAB_K
  F_ITEM0,    // the stage's first work item in its phase
  F_PART,     // fp32 offset in ws of its split partials or softmax rows,
              // or -1: flushed straight from registers
  F_NOPS,
  F_CODE,
  F_PARAM = F_CODE + MAX_OPS,
  STAGE_WORDS = F_PARAM + MAX_OPS
};

// Phase-table words, after the stage table: the phase's stage rows
// [first, end), its work items, and whether a post phase (split sums,
// softmax rows) follows its grid sync.
enum PhaseField { P_FIRST = 0, P_END, P_ITEMS, P_POST, PHASE_WORDS };

// the largest tile's two slabs of each operand: 64 KB
constexpr int FUSED_SMEM = 2 * SLAB_K * 2 * 128 * (int)sizeof(float);

struct StageDesc {
  int kind, m, k, n, tile, split, kchunk, item0, a_mode, b_mode, vec,
      res_f32, softmax;
  const void* lhs;
  long long ls0, ls1, ls2;
  const void* rhs;
  long long rs0, rs1;
  const void* res;
  long long res0, res1;
  void* out;
  void* tap;
  long long part;
  Epi epi;
};

__device__ __forceinline__ const void* as_ptr(long long v) {
  return reinterpret_cast<const void*>(static_cast<size_t>(v));
}

// 4-element stores to p: p on a 4-element boundary (or absent)
template <typename T>
__device__ __forceinline__ bool aligned4(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % (4 * sizeof(T)) == 0;
}

// Stage s's descriptor from the table, with the staging modes of its
// operands (lhs as (m, k), rhs as (n, k)) and whether out and tap take
// 4-element stores.
template <typename T>
__device__ void load_stage(const long long* table, int s, StageDesc& d) {
  const long long* t = table + (long long)s * STAGE_WORDS;
  d.kind = (int)t[F_KIND];
  d.m = (int)t[F_M];
  d.k = (int)t[F_K];
  d.n = (int)t[F_N];
  d.lhs = as_ptr(t[F_LHS]);
  d.ls0 = t[F_LS0];
  d.ls1 = t[F_LS1];
  d.ls2 = t[F_LS2];
  d.rhs = as_ptr(t[F_RHS]);
  d.rs0 = t[F_RS0];
  d.rs1 = t[F_RS1];
  d.res = as_ptr(t[F_RES]);
  d.res0 = t[F_RES0];
  d.res1 = t[F_RES1];
  d.res_f32 = (int)t[F_RES_F32];
  d.out = const_cast<void*>(as_ptr(t[F_OUT]));
  d.tap = const_cast<void*>(as_ptr(t[F_TAP]));
  d.tile = (int)t[F_TILE];
  d.split = (int)t[F_SPLIT];
  d.kchunk = (int)t[F_KCHUNK];
  d.item0 = (int)t[F_ITEM0];
  d.part = t[F_PART];
  d.a_mode = stage_mode<T>(d.lhs, 0, d.ls1, d.ls0);
  d.b_mode = stage_mode<T>(d.rhs, 0, d.rs0, d.rs1);
  d.vec = d.n % 4 == 0 && aligned4<T>(d.out) && aligned4<T>(d.tap);
  d.epi.n_ops = (int)t[F_NOPS];
  d.epi.bias = static_cast<const float*>(as_ptr(t[F_BIAS]));
  d.softmax = 0;
  for (int i = 0; i < MAX_OPS; ++i) {
    d.epi.code[i] = (int)t[F_CODE + i];
    d.epi.param[i] = __int_as_float((int)t[F_PARAM + i]);
    if (i < d.epi.n_ops && d.epi.code[i] == OP_SOFTMAX) d.softmax = 1;
  }
}

// Every thread of the CTA then reads stage s's descriptor from `d`; the
// first barrier keeps the previous stage's readers ahead of the load.
template <typename T>
__device__ __forceinline__ void enter_stage(const long long* table, int s,
                                            StageDesc& d) {
  __syncthreads();
  if (threadIdx.x == 0) load_stage<T>(table, s, d);
  __syncthreads();
}

// Elements of one split's partials: m x n rounded up to whole float4s.
__device__ __forceinline__ long long plane(const StageDesc& d) {
  return ((long long)d.m * d.n + 3) & ~3LL;
}

// The post-epilogue fp32 value at (r, c) as the stage stores it: cast,
// the residual added in fp32, cast again.
template <typename T>
__device__ __forceinline__ float out_value(const StageDesc& d, int r, int c,
                                           float y) {
  float v = round_to<T>(y);
  if (d.res != nullptr) {
    const long long ri = (long long)r * d.res0 + (long long)c * d.res1;
    v = round_to<T>(v + (d.res_f32 ? static_cast<const float*>(d.res)[ri]
                                    : to_f(static_cast<const T*>(d.res)[ri])));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store_out(const StageDesc& d, int r, int c,
                                          float y) {
  const long long idx = (long long)r * d.n + c;
  const T o = from_f<T>(out_value<T>(d, r, c, y));
  static_cast<T*>(d.out)[idx] = o;
  if (d.tap != nullptr) static_cast<T*>(d.tap)[idx] = o;
}

// 4 values already in T's range at p[idx .. idx + 3], one vector store
__device__ __forceinline__ void put4(float* p, long long idx,
                                     const float (&y)[4]) {
  *reinterpret_cast<float4*>(p + idx) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, long long idx,
                                     const float (&y)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p + idx) = u;
}

// 4 raw fp32 sums of split `sp` at (r, c .. c + 3), columns < n: to the
// stage's partials (or softmax rows), or through the epilogue, the cast
// and the residual to its output and tap.
template <typename T>
__device__ __forceinline__ void flush_quad(const StageDesc& d, float* ws,
                                           int sp, int r, int c, float4 v) {
  const int n = d.n;
  const long long idx = (long long)r * n + c;
  if (d.part >= 0) {
    store4(ws + d.part + sp * plane(d), idx, v, c, n, n % 4 == 0);
    return;
  }
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x = at(v, j);
    if (c + j < n) {
      for (int i = 0; i < d.epi.n_ops; ++i)
        x = apply_op(x, d.epi.code[i], d.epi.param[i], d.epi.bias, c + j);
      x = out_value<T>(d, r, c + j, x);
    }
    y[j] = x;
  }
  T* out = static_cast<T*>(d.out);
  T* tap = static_cast<T*>(d.tap);
  if (d.vec && c + 3 < n) {
    put4(out, idx, y);
    if (tap != nullptr) put4(tap, idx, y);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) {
      out[idx + j] = from_f<T>(y[j]);
      if (tap != nullptr) tap[idx + j] = from_f<T>(y[j]);
    }
}

// One work item of a dot stage: the BM x BM output tile `w` of its
// raster over k in [kb, ke) of split `sp`, on simt_tile.cuh's mainloop
// (as stt_tile_kernel), flushed straight from registers.
template <typename T, int BM>
__device__ void dot_item(const StageDesc& d, float* ws, int item,
                         int m_fast, float* smem) {
  constexpr int BN = BM, TM = BM / 16, TN = BN / 16, QM = TM / 4,
                QN = TN / 4;
  constexpr int LDA = Slab<T, BM, true>::LD, LDB = Slab<T, BN, true>::LD;
  float* As = smem;                   // 2 x SLAB_K x LDA
  float* Bs = As + 2 * SLAB_K * LDA;  // 2 x SLAB_K x LDB
  const int tiles_m = cdiv(d.m, BM), tiles_n = cdiv(d.n, BN);
  const int sp = item / (tiles_m * tiles_n), w = item % (tiles_m * tiles_n);
  const int m0 = (m_fast ? w % tiles_m : w / tiles_n) * BM;
  const int n0 = (m_fast ? w / tiles_m : w % tiles_n) * BN;
  const int kb = sp * d.kchunk, ke = min(d.k, kb + d.kchunk);
  const View<T> A{static_cast<const T*>(d.lhs), 0, d.ls0, d.ls1};
  const View<T> Bt{static_cast<const T*>(d.rhs), 0, d.rs1, d.rs0};
  const int tx = quad_tx(), ty = quad_ty();
  const int nsl = cdiv(ke - kb, SLAB_K);
  Slab<T, BM, true> na;
  Slab<T, BN, true> nb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  na.load(A, 0, m0, kb, d.m, ke, d.a_mode);
  nb.load(Bt, 0, n0, kb, d.n, ke, d.b_mode);
  na.store(As, d.a_mode);
  nb.store(Bs, d.b_mode);
  __syncthreads();
  for (int s = 0; s < nsl; ++s) {
    const bool more = s + 1 < nsl;
    if (more) {
      na.load(A, 0, m0, kb + (s + 1) * SLAB_K, d.m, ke, d.a_mode);
      nb.load(Bt, 0, n0, kb + (s + 1) * SLAB_K, d.n, ke, d.b_mode);
    }
    fma_quads<BM, BN, TM, TN, LDB, true>(
        acc, As + (s & 1) * SLAB_K * LDA, Bs + (s & 1) * SLAB_K * LDB, ty,
        tx);
    if (more) {
      na.store(As + ((s + 1) & 1) * SLAB_K * LDA, d.a_mode);
      nb.store(Bs + ((s + 1) & 1) * SLAB_K * LDB, d.b_mode);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i / 4) * (BM / QM) + 4 * ty + i % 4;
    if (r >= d.m) continue;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int c = n0 + q * (BN / QN) + 4 * tx;
      if (c >= d.n) continue;
      flush_quad<T>(d, ws, sp, r, c,
                    make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                acc[i][4 * q + 2], acc[i][4 * q + 3]));
    }
  }
}

// A batched stage, out[b, c] = sum_k lhs[b, k, c] * rhs[b, k]: one thread
// an output over the whole grid; raw sums to the softmax rows when the
// epilogue has a softmax.
template <typename T>
__device__ void batched_stage(const StageDesc& d, float* ws) {
  const T* a3 = static_cast<const T*>(d.lhs);
  const T* v = static_cast<const T*>(d.rhs);
  const long long total = (long long)d.m * d.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int b = (int)(e / d.n), c = (int)(e % d.n);
    const T* ab = a3 + (long long)b * d.ls0 + (long long)c * d.ls2;
    const T* vb = v + (long long)b * d.rs0;
    float acc = 0.0f;
    for (int kk = 0; kk < d.k; ++kk)
      acc = fmaf(to_f(ab[(long long)kk * d.ls1]),
                 to_f(vb[(long long)kk * d.rs1]), acc);
    if (d.part >= 0) {
      ws[d.part + e] = acc;
      continue;
    }
    for (int i = 0; i < d.epi.n_ops; ++i)
      acc = apply_op(acc, d.epi.code[i], d.epi.param[i], d.epi.bias, c);
    store_out<T>(d, b, c, acc);
  }
}

// A split stage's sums, one thread an output over the whole grid: its
// partials added in split order, then the epilogue and the flush.
template <typename T>
__device__ void reduce_phase(const StageDesc& d, const float* ws) {
  const long long total = (long long)d.m * d.n, pl = plane(d);
  const float* p = ws + d.part;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    float acc = p[e];
    for (int s = 1; s < d.split; ++s) acc += p[s * pl + e];
    const int c = (int)(e % d.n);
    for (int i = 0; i < d.epi.n_ops; ++i)
      acc = apply_op(acc, d.epi.code[i], d.epi.param[i], d.epi.bias, c);
    store_out<T>(d, (int)(e / d.n), c, acc);
  }
}

// A softmax stage's row phase, one warp a row over the whole grid: the
// row's split partials added in split order into the first, then
// row_epilogue and the flush.  A lane owns the same columns throughout.
template <typename T>
__device__ void row_phase(const StageDesc& d, float* ws) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int nw = gridDim.x * wpb;
  const long long pl = plane(d);
  for (int r = blockIdx.x * wpb + (threadIdx.x >> 5); r < d.m; r += nw) {
    float* w = ws + d.part + (long long)r * d.n;
    if (d.split > 1)
      for (int c = lane; c < d.n; c += 32) {
        float a = w[c];
        for (int s = 1; s < d.split; ++s) a += w[s * pl + c];
        w[c] = a;
      }
    row_epilogue(w, d.n, d.epi, lane);
    for (int c = lane; c < d.n; c += 32) store_out<T>(d, r, c, w[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    stages_kernel(const long long* table, int n_stage, int n_phase,
                  float* ws, int m_fast) {
  extern __shared__ __align__(16) float tsm[];
  __shared__ StageDesc sd;
  cg::grid_group grid = cg::this_grid();
  const long long* phases = table + (long long)n_stage * STAGE_WORDS;
  for (int p = 0; p < n_phase; ++p) {
    const long long* ph = phases + p * PHASE_WORDS;
    const int first = (int)ph[P_FIRST], end = (int)ph[P_END];
    const int items = (int)ph[P_ITEMS];
    // the phase's dot items, round-robin over the grid; a phase's rows
    // hold its dot stages first, in item order
    int s = first, cur = -1;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      while (s + 1 < end && it >= table[(s + 1) * STAGE_WORDS + F_ITEM0])
        ++s;
      if (s != cur) {
        enter_stage<T>(table, s, sd);
        cur = s;
      }
      if (sd.tile == 128)
        dot_item<T, 128>(sd, ws, it - sd.item0, m_fast, tsm);
      else
        dot_item<T, 64>(sd, ws, it - sd.item0, m_fast, tsm);
    }
    for (int b = first; b < end; ++b)
      if (table[b * STAGE_WORDS + F_KIND] == 1) {
        enter_stage<T>(table, b, sd);
        batched_stage<T>(sd, ws);
      }
    if (!ph[P_POST]) {
      if (p + 1 < n_phase) grid.sync();
      continue;
    }
    grid.sync();
    for (int b = first; b < end; ++b)
      if (table[b * STAGE_WORDS + F_PART] >= 0) {
        enter_stage<T>(table, b, sd);
        if (sd.softmax)
          row_phase<T>(sd, ws);
        else
          reduce_phase<T>(sd, ws);
      }
    if (p + 1 < n_phase) grid.sync();
  }
}

// Opt the kernel into FUSED_SMEM bytes of dynamic shared memory (once)
// and return how many CTAs of it fit an SM, or a negative error code.
template <typename T>
int ctas_per_sm() {
  static bool attr_set = false;
  cudaError_t e = cudaSuccess;
  if (!attr_set) {
    e = cudaFuncSetAttribute(stages_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FUSED_SMEM);
    attr_set = e == cudaSuccess;
  }
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stages_kernel<T>, TILE_THREADS, FUSED_SMEM);
  return e == cudaSuccess ? per_sm : -(int)e;
}

template <typename T>
int stages_launch(const long long* table, int n_stage, int n_phase,
                  float* ws, int m_fast, int grid, cudaStream_t st) {
  const int per_sm = ctas_per_sm<T>();
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (grid < 1 || grid > sms * per_sm)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&table, (void*)&n_stage, (void*)&n_phase,
                  (void*)&ws, (void*)&m_fast};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&stages_kernel<T>), dim3(grid),
      dim3(TILE_THREADS), args, FUSED_SMEM, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* table, int n_stage, int n_phase,
             void* ws, int m_fast, int grid, void* stream) {
  const long long* t = static_cast<const long long*>(table);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stages_launch<float>(t, n_stage, n_phase, w, m_fast, grid, st);
  if (dtype == 1)
    return stages_launch<__nv_bfloat16>(t, n_stage, n_phase, w, m_fast,
                                        grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16 (the
// chain dtype; residual streams may be fp32, bias rows are fp32).
// `table` holds n_stage * STAGE_WORDS stage words then n_phase *
// PHASE_WORDS phase words, int64, in device memory; `ws` is the fp32
// workspace of split partials and softmax rows, each level's from its
// start (may be null when no stage uses it); `grid` CTAs, at most SMs x fused_ctas_per_sm.
extern "C" int fused_chain_launch(int dtype, const void* table, int n_stage,
                                  int n_phase, void* ws, int m_fast,
                                  int grid, void* stream) {
  return dispatch(dtype, table, n_stage, n_phase, ws, m_fast, grid, stream);
}

extern "C" int fused_dag_launch(int dtype, const void* table, int n_stage,
                                int n_phase, void* ws, int grid,
                                void* stream) {
  return dispatch(dtype, table, n_stage, n_phase, ws, 0, grid, stream);
}

// CTAs of the kernel an SM (for the launch plan's grid), or a negative
// CUDA error code.
extern "C" int fused_ctas_per_sm(int dtype) {
  if (dtype == 0) return ctas_per_sm<float>();
  if (dtype == 1) return ctas_per_sm<__nv_bfloat16>();
  return -(int)cudaErrorInvalidValue;
}

// STAGE_WORDS and PHASE_WORDS, for the Python side to check its layout
// against.
extern "C" int fused_stage_words() { return STAGE_WORDS; }
extern "C" int fused_phase_words() { return PHASE_WORDS; }
