// STT GEMM templates for Hopper (sm_90a): the three residency structures
// that the reference realizes as Pallas kernels in kernels/stt_gemm.py.
//
//   C[b] = epilogue(A[b|.] @ B[b|.]),  A (m, k), B (k, n), C (m, n)
//
// Each operand is read through a strided view (batch, row and column
// strides in elements), so the wrappers pass transposed views -- gemm's
// B.T, the input-stationary transposition -- without a copy, and an
// operand broadcast over the batch has batch stride 0.  Tile loads walk
// the operand's unit-stride axis so that neighbouring threads read
// neighbouring addresses.  Inputs are fp32 or bf16; products and sums are
// fp32 on the CUDA cores (TF32 is off so fp32 results match the
// reference); the output has the input dtype.
//
// The plan's blocks (bm, bn, bk) come from the 16x16 PE-array tile
// chooser and define semantics (residency, the in-place rounding step,
// the softmax row), not the CTA tile: a CTA works on its own tile and
// masks the ragged edge.
//
// What bounds these kernels on the H100: fp32 without TF32 is bound by
// CUDA-core FLOPs (67 TFLOP/s) at the main path's shapes, except the
// skinny batched forms (batched_gemv, depthwise_conv), which are bound by
// bytes.  The operand-stationary strip adds its own term: the fp32 (m, bn)
// strip is read-modify-written once per k-chunk.  These first versions
// are plain SIMT tiles (register micro-tiles fed from shared memory);
// wgmma, TMA and warp specialisation are later work.
//
// Launch contract: every kernel runs on the stream it is given, allocates
// nothing (outputs and the fp32 workspace come from the caller), and each
// host entry point returns cudaGetLastError() right after its launch.

#include "common.cuh"

namespace {

// Shared body of the output-stationary and reduction-tree kernels.
// Without a workspace each CTA owns one output tile (n_fast: consecutive
// CTAs walk along n) and flushes it straight from registers.  With a
// workspace (softmax epilogues) each CTA owns BM full rows: it writes the
// raw sums of every n tile to the fp32 workspace, then runs the row phase.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool INPLACE>
__device__ __forceinline__ void tiles_body(View<T> A, View<T> B, T* out,
                                           float* ws, int m, int n, int k,
                                           int kstep, int n_fast,
                                           const Epi& epi) {
  __shared__ float As[BK * BM];
  __shared__ float Bs[BK * BN];
  const int b = blockIdx.z;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const long long cbase = (long long)b * m * n;
  float acc[TM][TN];
  if (ws == nullptr) {
    const int tm = n_fast ? blockIdx.y : blockIdx.x;
    const int tn = n_fast ? blockIdx.x : blockIdx.y;
    tile_product<T, BM, BN, BK, TM, TN, INPLACE>(
        A, B, b, m, n, k, tm * BM, tn * BN, kstep, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = tm * BM + ty + i * (BM / TM);
        const int c = tn * BN + tx + j * (BN / TN);
        if (r < m && c < n)
          flush_store<T>(out, cbase + (long long)r * n + c, acc[i][j], c,
                         epi);
      }
    return;
  }
  const int tm = blockIdx.x;
  for (int tn = 0; tn * BN < n; ++tn) {
    tile_product<T, BM, BN, BK, TM, TN, INPLACE>(
        A, B, b, m, n, k, tm * BM, tn * BN, kstep, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = tm * BM + ty + i * (BM / TM);
        const int c = tn * BN + tx + j * (BN / TN);
        if (r < m && c < n) ws[cbase + (long long)r * n + c] = acc[i][j];
      }
  }
  __syncthreads();
  flush_rows<T>(ws + cbase, out + cbase, tm * BM, min(m, tm * BM + BM), n,
                epi);
}

// Output-stationary template; replaces the reference's
// kernels/stt_gemm.py:matmul_output_stationary (_os_kernel_scratch,
// _os_kernel_inplace).  The C tile is the resident accumulator: it stays
// in registers for the whole k loop while A and B tiles stream through
// shared memory.  accum="scratch" keeps it fp32 and casts once at the
// flush; accum="inplace" rounds it to the output dtype after every plan
// k-step of bk (kstep).  On the TPU the k-outer grid orders ("kmn",
// "knm") revisit the output block between k-steps; here CTAs do not run
// in order, so those orders compute exactly the k-inner in-place sums
// and only pick the raster order (n_fast).  Bound on the H100: fp32
// FLOPs at the main path's shapes (gemm 4096^3: 2.05 ms at 67 TFLOP/s);
// the 128x128 tile gives every staged element 128 FMAs of reuse, and
// the 8x128 skinny tile keeps the m=1 batch slices of grid-folded forms
// from wasting 128x the FMAs.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool INPLACE>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    os_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n, int k,
              int kstep, int n_fast, Epi epi) {
  tiles_body<T, BM, BN, BK, TM, TN, INPLACE>(A, B, out, ws, m, n, k, kstep,
                                             n_fast, epi);
}

// Reduction-tree template (also "streaming"); replaces the reference's
// kernels/stt_gemm.py:matmul_reduction_tree (_rt_kernel).  One pass per
// output tile over the full K with nothing resident between tiles; the
// split-K adder-tree form across CTAs is later work.  Bound on the H100:
// bytes on its main-path users (streaming batched_gemv and
// depthwise_conv, one pass over a batched operand), where the skinny
// tile keeps the FMA work near the algebra's; FLOPs on large square
// shapes, as for the output-stationary kernel.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    rt_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n, int k,
              int n_fast, Epi epi) {
  tiles_body<T, BM, BN, BK, TM, TN, false>(A, B, out, ws, m, n, k, k,
                                           n_fast, epi);
}

// Operand-stationary template (stationary="B"); replaces the reference's
// kernels/stt_gemm.py:matmul_operand_stationary (_ws_kernel).  Per batch
// slice and n tile, each KC-deep chunk of B is loaded into shared memory
// once and stays pinned while the CTA sweeps its whole range of m rows;
// the (m, BN) strip of partial sums accumulates in the caller's fp32
// global workspace (read-modify-write once per chunk; it should stay in
// L2).  The flush (epilogue + cast) runs after the last chunk.  CTAs along
// y split m so that the card has enough CTAs; each row range still sees
// one B chunk per k-chunk.  With `row_mode` (softmax) a CTA covers every
// n tile and ends with the row phase.  Bound on the H100: fp32 FLOPs,
// plus the strip's own term -- (2 * k / KC - 1) passes over the fp32
// (m, n) strip (4.2 GB at 4096^3, 1.26 ms at full memory rate, under the
// 2.05 ms FLOP bound); KC-deep chunks keep that term below the FLOPs.
template <typename T, int BM, int BN, int BK, int TM, int TN, int KC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ws_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n, int k,
              int rows_per_cta, int row_mode, Epi epi) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(KC % BK == 0, "B chunk must hold whole slabs");
  __shared__ float Bs[KC * BN];  // the stationary B chunk
  __shared__ float As[BK * BM];
  const int b = blockIdx.z;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const long long aoff = (long long)b * A.sb, boff = (long long)b * B.sb;
  const long long cbase = (long long)b * m * n;
  float* wsb = ws + cbase;
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(m, r_begin + rows_per_cta);
  const int tiles_n = (n + BN - 1) / BN;
  const int tn_begin = row_mode ? 0 : blockIdx.x;
  const int tn_end = row_mode ? tiles_n : blockIdx.x + 1;
  for (int tn = tn_begin; tn < tn_end; ++tn) {
    const int n0 = tn * BN;
    for (int kc = 0; kc < k; kc += KC) {
      const int kend = min(k, kc + KC);
      load_tile<T, KC, BN, false, NT>(Bs, B, boff, kc, n0, kend, n);
      __syncthreads();
      for (int m0 = r_begin; m0 < r_end; m0 += BM) {
        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
        for (int kk = kc; kk < kend; kk += BK) {
          load_tile<T, BM, BK, true, NT>(As, A, aoff, m0, kk, m, kend);
          __syncthreads();
          fma_slab<BM, BN, BK, TM, TN>(part, As, Bs + (kk - kc) * BN, ty,
                                       tx);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = m0 + ty + i * (BM / TM);
            const int c = n0 + tx + j * (BN / TN);
            if (r < r_end && c < n) {
              const long long idx = (long long)r * n + c;
              wsb[idx] = (kc == 0 ? 0.0f : wsb[idx]) + part[i][j];
            }
          }
      }
      __syncthreads();  // every slab read Bs before the next chunk lands
    }
    if (!row_mode) {
      // each thread flushes the strip entries it accumulated itself
      for (int m0 = r_begin; m0 < r_end; m0 += BM)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = m0 + ty + i * (BM / TM);
            const int c = n0 + tx + j * (BN / TN);
            if (r < r_end && c < n) {
              const long long idx = (long long)r * n + c;
              flush_store<T>(out, cbase + idx, wsb[idx], c, epi);
            }
          }
    }
  }
  if (row_mode) {
    __syncthreads();
    flush_rows<T>(wsb, out + cbase, r_begin, r_end, n, epi);
  }
}

// Operand-stationary configurations: a square tile and a narrow-n one for
// the input-stationary transposition of matvec-like forms (n of 1).
struct StripL { static constexpr int BM = 64, BN = 64, BK = 8, TM = 4, TN = 4, KC = 128; };
struct StripN { static constexpr int BM = 128, BN = 8, BK = 8, TM = 4, TN = 1, KC = 256; };

template <typename C>
dim3 tile_grid(int m, int n, int nb, bool row_mode, int n_fast) {
  const int tm = cdiv(m, C::BM), tn = cdiv(n, C::BN);
  if (row_mode) return dim3(tm, 1, nb);
  return n_fast ? dim3(tn, tm, nb) : dim3(tm, tn, nb);
}

template <typename T, typename C, bool INPLACE>
int os_launch_t(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                int n, int k, int kstep, int n_fast, Epi epi,
                cudaStream_t st) {
  const dim3 g = tile_grid<C>(m, n, nb, ws != nullptr, n_fast);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  os_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN, INPLACE>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k,
          INPLACE ? kstep : k, n_fast, epi);
  return (int)cudaGetLastError();
}

template <typename T>
int os_dispatch(const void* a, long long a_sb, long long a_sr,
                long long a_sc, const void* b, long long b_sb,
                long long b_sr, long long b_sc, void* out, void* ws, int nb,
                int m, int n, int k, int kstep, int inplace, int n_fast,
                Epi epi, cudaStream_t st) {
  View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
  View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
  const bool skinny = m <= TileS::BM;
  if (inplace)
    return skinny ? os_launch_t<T, TileS, true>(A, B, out, ws, nb, m, n, k,
                                                kstep, n_fast, epi, st)
                  : os_launch_t<T, TileL, true>(A, B, out, ws, nb, m, n, k,
                                                kstep, n_fast, epi, st);
  return skinny ? os_launch_t<T, TileS, false>(A, B, out, ws, nb, m, n, k,
                                               kstep, n_fast, epi, st)
                : os_launch_t<T, TileL, false>(A, B, out, ws, nb, m, n, k,
                                               kstep, n_fast, epi, st);
}

template <typename T, typename C>
int rt_launch_t(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                int n, int k, int n_fast, Epi epi, cudaStream_t st) {
  const dim3 g = tile_grid<C>(m, n, nb, ws != nullptr, n_fast);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  rt_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k,
          n_fast, epi);
  return (int)cudaGetLastError();
}

template <typename T>
int rt_dispatch(const void* a, long long a_sb, long long a_sr,
                long long a_sc, const void* b, long long b_sb,
                long long b_sr, long long b_sc, void* out, void* ws, int nb,
                int m, int n, int k, int n_fast, Epi epi, cudaStream_t st) {
  View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
  View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
  if (m <= TileS::BM)
    return rt_launch_t<T, TileS>(A, B, out, ws, nb, m, n, k, n_fast, epi, st);
  return rt_launch_t<T, TileL>(A, B, out, ws, nb, m, n, k, n_fast, epi, st);
}

// CTAs along m for the operand-stationary grid: enough CTAs in all to
// cover the card's 132 SMs a few times over, each with a whole number of
// BM row tiles.
template <typename C>
int ws_rows_per_cta(int m, int n, int nb, bool row_mode) {
  const int target = 4 * 132;
  const int col_ctas = (row_mode ? 1 : cdiv(n, C::BN)) * nb;
  const int m_tiles = cdiv(m, C::BM);
  int splits = cdiv(target, col_ctas);
  splits = splits < 1 ? 1 : (splits > m_tiles ? m_tiles : splits);
  return cdiv(m_tiles, splits) * C::BM;
}

template <typename T, typename C>
int ws_launch_t(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                int n, int k, int row_mode, Epi epi, cudaStream_t st) {
  const int rows = ws_rows_per_cta<C>(m, n, nb, row_mode != 0);
  const dim3 g(row_mode ? 1 : cdiv(n, C::BN), cdiv(m, rows), nb);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  ws_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN, C::KC>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k, rows,
          row_mode, epi);
  return (int)cudaGetLastError();
}

template <typename T>
int ws_dispatch(const void* a, long long a_sb, long long a_sr,
                long long a_sc, const void* b, long long b_sb,
                long long b_sr, long long b_sc, void* out, void* ws, int nb,
                int m, int n, int k, int row_mode, Epi epi,
                cudaStream_t st) {
  View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
  View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
  if (n <= StripN::BN)
    return ws_launch_t<T, StripN>(A, B, out, ws, nb, m, n, k, row_mode, epi,
                                  st);
  return ws_launch_t<T, StripL>(A, B, out, ws, nb, m, n, k, row_mode, epi,
                                st);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements.  Each entry point returns a cudaError_t code.
// ---------------------------------------------------------------------------

extern "C" int stt_os_launch(int dtype, const void* a, long long a_sb,
                             long long a_sr, long long a_sc, const void* b,
                             long long b_sb, long long b_sr, long long b_sc,
                             void* out, void* ws, int nb, int m, int n, int k,
                             int kstep, int inplace, int n_fast, int n_ops,
                             const int* codes, const float* params,
                             const void* bias, void* stream) {
  const Epi epi = make_epi(n_ops, codes, params, bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return os_dispatch<float>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out,
                              ws, nb, m, n, k, kstep, inplace, n_fast, epi,
                              st);
  if (dtype == 1)
    return os_dispatch<__nv_bfloat16>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr,
                                      b_sc, out, ws, nb, m, n, k, kstep,
                                      inplace, n_fast, epi, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int stt_rt_launch(int dtype, const void* a, long long a_sb,
                             long long a_sr, long long a_sc, const void* b,
                             long long b_sb, long long b_sr, long long b_sc,
                             void* out, void* ws, int nb, int m, int n, int k,
                             int n_fast, int n_ops, const int* codes,
                             const float* params, const void* bias,
                             void* stream) {
  const Epi epi = make_epi(n_ops, codes, params, bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rt_dispatch<float>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out,
                              ws, nb, m, n, k, n_fast, epi, st);
  if (dtype == 1)
    return rt_dispatch<__nv_bfloat16>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr,
                                      b_sc, out, ws, nb, m, n, k, n_fast,
                                      epi, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int stt_ws_launch(int dtype, const void* a, long long a_sb,
                             long long a_sr, long long a_sc, const void* b,
                             long long b_sb, long long b_sr, long long b_sc,
                             void* out, void* ws, int nb, int m, int n, int k,
                             int row_mode, int n_ops, const int* codes,
                             const float* params, const void* bias,
                             void* stream) {
  const Epi epi = make_epi(n_ops, codes, params, bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ws_dispatch<float>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out,
                              ws, nb, m, n, k, row_mode, epi, st);
  if (dtype == 1)
    return ws_dispatch<__nv_bfloat16>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr,
                                      b_sc, out, ws, nb, m, n, k, row_mode,
                                      epi, st);
  return (int)cudaErrorInvalidValue;
}
