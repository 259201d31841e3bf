// Fused-group megakernels for Hopper (sm_90a): a merged graph group's
// stages in ONE persistent cooperative launch.  Two entry points share one
// body:
//
//   fused_chain_launch -- replaces the reference's
//     kernels/fused_chain.py:fused_chain_matmul (_chain_kernel,
//     _stage_kernel): stage j computes x = cast(epi_j(x @ W_j + b_j)).
//   fused_dag_launch   -- replaces kernels/fused_chain.py:fused_dag
//     (_dag_kernel): stage-major DAG of `dot` and `batched` stages, a
//     scratch-sourced rhs read transposed, an fp32 residual added after the
//     epilogue, tap outputs.
//
// The TPU keeps every intermediate and every weight in VMEM and runs the
// stages as ordered grid phases.  On Hopper neither holds: a CTA has at
// most 227 KB of shared memory and CTAs run in no order.  So the launch is
// cooperative, with the grid sized to the CTAs that can be co-resident;
// the stages come from a stage table in device memory (int64 words, laid
// out by kernels/fused_chain.py); each stage's output tiles are spread
// over all CTAs, and cooperative_groups' grid sync separates the stages.
// Intermediates live in a global workspace of the chain dtype that the
// wrapper allocates (dag_scratch_bytes / stage_scratch_bytes: 41 MB for
// the h2o-danube-1.8b layer at l = 512, the size of the 50 MB L2).  Every
// buffer is written in one stage and read only in later ones, and each
// softmax stage has its own rows of the fp32 row workspace.
//
// A stage's operands are strided views: a scratch-sourced rhs is the
// producer's (n, k) output read with swapped strides, never copied.  A
// `dot` stage runs the output-stationary tile of common.cuh (128x128,
// fp32 sums in registers over the full k); a `batched` stage is the
// (batch, n) image out[b, c] = sum_k lhs[b, k, c] * rhs[b, k], one thread
// per output.  The flush applies the epilogue in fp32, casts, adds the
// residual in fp32 and casts again, then writes the stage's output and,
// for a tapped stage, its tap slot.  An epilogue with a softmax writes raw
// sums to the fp32 row workspace; after a grid sync, one warp per row
// (spread over the whole grid) runs common.cuh's row_epilogue and flushes.
//
// `chain` and `stage` interleaves differ on the TPU only in the order of
// m-blocks; the math is the same, so here they differ only in the tile
// raster (m_fast).  The planner's bm is not the CTA tile.
//
// What bounds it on the H100: fp32 FLOPs on the CUDA cores at the main
// path's shapes (danube layer at l = 512: 65.8 GFLOP, 0.98 ms at 67
// TFLOP/s; its MLP chain 36.2 GFLOP, 0.54 ms).  This first version does
// nothing about the bound beyond keeping intermediates out of separate
// launches: stages with fewer 128x128 tiles than CTAs leave SMs idle until
// the next grid sync (split-k and wgmma are later work).
//
// Launch contract: runs on the given stream, allocates nothing, and each
// entry point returns the launch's error code.

#include <cooperative_groups.h>

#include "common.cuh"

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
  F_BIAS, F_OUT, F_TAP, F_WS,  // F_WS: element offset of the softmax rows
  F_NOPS,
  F_CODE,
  F_PARAM = F_CODE + MAX_OPS,
  STAGE_WORDS = F_PARAM + MAX_OPS
};

struct StageDesc {
  int kind, m, k, n;
  const void* lhs;
  long long ls0, ls1, ls2;
  const void* rhs;
  long long rs0, rs1;
  const void* res;
  long long res0, res1;
  int res_f32;
  void* out;
  void* tap;
  long long ws;
  bool softmax;
  Epi epi;
};

__device__ __forceinline__ const void* as_ptr(long long v) {
  return reinterpret_cast<const void*>(static_cast<size_t>(v));
}

__device__ StageDesc load_stage(const long long* table, int s) {
  const long long* t = table + (long long)s * STAGE_WORDS;
  StageDesc d;
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
  d.ws = t[F_WS];
  d.epi.n_ops = (int)t[F_NOPS];
  d.epi.bias = static_cast<const float*>(as_ptr(t[F_BIAS]));
  d.softmax = false;
  for (int i = 0; i < MAX_OPS; ++i) {
    d.epi.code[i] = (int)t[F_CODE + i];
    d.epi.param[i] = __int_as_float((int)t[F_PARAM + i]);
    if (i < d.epi.n_ops && d.epi.code[i] == OP_SOFTMAX) d.softmax = true;
  }
  return d;
}

// The stage's flush of one post-epilogue fp32 value at (r, c): cast, the
// residual added in fp32 and cast again, then the output and the tap.
template <typename T>
__device__ __forceinline__ void store_out(const StageDesc& d, int r, int c,
                                          float y) {
  float v = round_to<T>(y);
  if (d.res != nullptr) {
    const long long ri = (long long)r * d.res0 + (long long)c * d.res1;
    const float rv = d.res_f32 ? static_cast<const float*>(d.res)[ri]
                               : to_f(static_cast<const T*>(d.res)[ri]);
    v = v + rv;
  }
  const long long idx = (long long)r * d.n + c;
  const T o = from_f<T>(v);
  static_cast<T*>(d.out)[idx] = o;
  if (d.tap != nullptr) static_cast<T*>(d.tap)[idx] = o;
}

// Raw fp32 sum at (r, c): straight through the epilogue to store_out, or
// into the softmax rows for the row phase.
template <typename T>
__device__ __forceinline__ void flush_value(const StageDesc& d, float* ws,
                                            int r, int c, float acc) {
  if (d.softmax) {
    ws[d.ws + (long long)r * d.n + c] = acc;
    return;
  }
  for (int i = 0; i < d.epi.n_ops; ++i)
    acc = apply_op(acc, d.epi.code[i], d.epi.param[i], d.epi.bias, c);
  store_out<T>(d, r, c, acc);
}

template <typename T, typename C>
__device__ void dot_stage(const StageDesc& d, float* ws, int m_fast,
                          float* As, float* Bs) {
  const View<T> A{static_cast<const T*>(d.lhs), 0, d.ls0, d.ls1};
  const View<T> B{static_cast<const T*>(d.rhs), 0, d.rs0, d.rs1};
  const int tiles_m = cdiv(d.m, C::BM), tiles_n = cdiv(d.n, C::BN);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
  for (int w = blockIdx.x; w < tiles_m * tiles_n; w += gridDim.x) {
    const int tm = m_fast ? w % tiles_m : w / tiles_n;
    const int tn = m_fast ? w / tiles_m : w % tiles_n;
    float acc[C::TM][C::TN];
    tile_product<T, C::BM, C::BN, C::BK, C::TM, C::TN, false>(
        A, B, 0, d.m, d.n, d.k, tm * C::BM, tn * C::BN, d.k, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int r = tm * C::BM + ty + i * (C::BM / C::TM);
        const int c = tn * C::BN + tx + j * (C::BN / C::TN);
        if (r < d.m && c < d.n) flush_value<T>(d, ws, r, c, acc[i][j]);
      }
  }
}

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
    flush_value<T>(d, ws, b, c, acc);
  }
}

// The softmax stage's row phase, one warp per row over the whole grid.
template <typename T>
__device__ void row_phase(const StageDesc& d, float* ws) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int nw = gridDim.x * wpb;
  for (int r = blockIdx.x * wpb + (threadIdx.x >> 5); r < d.m; r += nw) {
    float* w = ws + d.ws + (long long)r * d.n;
    row_epilogue(w, d.n, d.epi, lane);
    for (int c = lane; c < d.n; c += 32) store_out<T>(d, r, c, w[c]);
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__((C::BM / C::TM) * (C::BN / C::TN))
    stages_kernel(const long long* table, int n_stage, float* ws,
                  int m_fast) {
  __shared__ float As[C::BK * C::BM];
  __shared__ float Bs[C::BK * C::BN];
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < n_stage; ++s) {
    const StageDesc d = load_stage(table, s);
    if (d.kind == 0)
      dot_stage<T, C>(d, ws, m_fast, As, Bs);
    else
      batched_stage<T>(d, ws);
    grid.sync();
    if (d.softmax) {
      row_phase<T>(d, ws);
      grid.sync();
    }
  }
}

template <typename T>
int stages_launch(const long long* table, int n_stage, float* ws,
                  int m_fast, cudaStream_t st) {
  using C = TileL;
  const void* kern = reinterpret_cast<const void*>(&stages_kernel<T, C>);
  const int threads = (C::BM / C::TM) * (C::BN / C::TN);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      stages_kernel<T, C>,
                                                      threads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&table, (void*)&n_stage, (void*)&ws,
                  (void*)&m_fast};
  e = cudaLaunchCooperativeKernel(kern, dim3(sms * per_sm), dim3(threads),
                                  args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* table, int n_stage, void* ws,
             int m_fast, void* stream) {
  const long long* t = static_cast<const long long*>(table);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stages_launch<float>(t, n_stage, w, m_fast, st);
  if (dtype == 1)
    return stages_launch<__nv_bfloat16>(t, n_stage, w, m_fast, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16 (the
// chain dtype; residual streams and bias rows are fp32).  `table` holds
// n_stage * STAGE_WORDS int64 words in device memory; `ws` is the fp32
// softmax row workspace (may be null when no stage has a softmax).
extern "C" int fused_chain_launch(int dtype, const void* table, int n_stage,
                                  void* ws, int m_fast, void* stream) {
  return dispatch(dtype, table, n_stage, ws, m_fast, stream);
}

extern "C" int fused_dag_launch(int dtype, const void* table, int n_stage,
                                void* ws, void* stream) {
  return dispatch(dtype, table, n_stage, ws, 0, stream);
}

// STAGE_WORDS, for the Python side to check its layout against.
extern "C" int fused_stage_words() { return STAGE_WORDS; }
