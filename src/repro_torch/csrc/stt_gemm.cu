// STT GEMM templates for Hopper (sm_90a): the three residency structures
// that the reference realizes as Pallas kernels in kernels/stt_gemm.py.
//
//   C[b] = epilogue(A[b|.] @ B[b|.]),  A (m, k), B (k, n), C (m, n)
//
// Each operand is read through a strided view (batch, row and column
// strides in elements), so the wrappers pass transposed views -- gemm's
// B.T, the input-stationary transposition -- without a copy, and an
// operand broadcast over the batch has batch stride 0.  Inputs are fp32
// or bf16; products and sums are fp32 on the CUDA cores (TF32 is off so
// fp32 results match the reference); the output has the input dtype.
//
// The plan's blocks (bm, bn, bk) come from the 16x16 PE-array tile
// chooser and define semantics (residency, the in-place rounding step,
// the softmax row), not the CTA tile: a CTA works on its own tile and
// masks the ragged edge.
//
// What bounds these kernels on the H100: fp32 without TF32 is bound by
// CUDA-core FLOPs (67 TFLOP/s) at the main path's shapes, except the
// skinny batched forms (batched_gemv, depthwise_conv: m <= SKINNY_M a
// batch slice), which are bound by bytes (3.35 TB/s).  The
// operand-stationary strip adds its own term: the fp32 (m, bn) strip is
// read-modify-written once per k-chunk.  The kernels:
// - stt_tile_kernel (output stationary and reduction tree, m > SKINNY_M)
//   and ws_tile_kernel (operand stationary, n > 8) run the SIMT tile
//   mainloop of simt_tile.cuh: float4 register fragments, operands staged
//   in SLAB_K-deep slabs double-buffered through registers, one barrier a
//   slab;
// - os_stream_kernel and rt_tree_kernel (m <= SKINNY_M) stream B along
//   its unit-stride axis with 16-byte loads, several in flight a thread,
//   and hold A's few rows in shared memory;
// - os_inplace_kernel (accum="inplace") and ws_kernel (operand
//   stationary, n <= 8) keep the first version's element-by-element
//   staging through common.cuh.
// wgmma, TMA and warp specialisation are later work.
//
// Launch contract: every kernel runs on the stream it is given, allocates
// nothing (outputs and the fp32 workspace come from the caller), and each
// host entry point returns cudaGetLastError() right after its launch.

#include "simt_tile.cuh"

namespace {

// m a batch slice at or under which the output-stationary and
// reduction-tree templates take their streaming kernels (the grid-folded
// batched forms have m = 1); the in-place path's skinny tile is as tall
constexpr int SKINNY_M = 8;
static_assert(TileS::BM == SKINNY_M, "one skinny threshold");

// Output-stationary template; replaces the reference's
// kernels/stt_gemm.py:matmul_output_stationary (_os_kernel_scratch,
// _os_kernel_inplace).  The C tile is the resident accumulator: it stays
// in registers for the whole k loop while A and B stream through.  On the
// TPU the k-outer grid orders ("kmn", "knm") revisit the output block
// between k-steps; here CTAs do not run in order, so those orders compute
// exactly the k-inner in-place sums and only pick the raster order
// (n_fast).  Which kernel runs each mode:
// - accum="scratch", m > SKINNY_M: stt_tile_kernel (below), fp32 sums
//   cast once at the flush; with a softmax epilogue (a workspace) each
//   CTA covers BM whole rows and ends with the row phase;
// - accum="scratch", m <= SKINNY_M: os_stream_kernel (below);
// - accum="inplace": os_inplace_kernel, the first version's tile over
//   common.cuh's tile_product, which rounds the running sum to the output
//   dtype after every plan k-step of bk (kstep).  It is off the main path
//   (ops.stt_matmul resolves "auto" to scratch).
// Every scratch output keeps one fp32 accumulator that adds its products
// in ascending k from 0, one fmaf each, as the BSR kernel's fma_quads
// walk over a block-row's nonzero blocks does (bsr_gemm.cu): at density
// 1.0 the two are bit-identical.  So there is no split-K for this
// template.
//
// Shared body of os_inplace_kernel.  Without a workspace each CTA owns one
// output tile (n_fast: consecutive CTAs walk along n) and flushes it
// straight from registers.  With a workspace (softmax epilogues) each CTA
// owns BM full rows: it writes the raw sums of every n tile to the fp32
// workspace, then runs the row phase.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void inplace_body(View<T> A, View<T> B, T* out,
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
    tile_product<T, BM, BN, BK, TM, TN, true>(
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
    tile_product<T, BM, BN, BK, TM, TN, true>(
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    os_inplace_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n,
                      int k, int kstep, int n_fast, Epi epi) {
  inplace_body<T, BM, BN, BK, TM, TN>(A, B, out, ws, m, n, k, kstep, n_fast,
                                      epi);
}

// The tile kernel of the output-stationary (scratch) and reduction-tree
// templates for m > SKINNY_M.  Bound on the H100: fp32 FLOPs (gemm
// 4096^3: 2.05 ms at 67 TFLOP/s).  The design:
// - a BM x BN CTA tile, 128 x 128 where that gives at least one wave of
//   the card's 132 SMs, else 64 x 64 (the operand-stationary rule); 256
//   threads in warps of 4 x 8, each owning a TM x TN register tile read
//   from shared memory as float4 quadrants (fma_quads): 64 FMAs for 4
//   shared loads at 128 x 128;
// - A and B both arrive in SLAB_K-deep slabs, double-buffered through
//   registers (Slab; B as its transposed view): the next slab's global
//   loads are issued before this slab's FMAs and stored to the other
//   buffer after them, one barrier a slab (2,048 FMAs a thread at 128 x
//   128).  Loads are 16 bytes along each operand's unit-stride axis (A
//   row-major and gemm's B.T view: k; an n-contiguous B: n), scalar for
//   other views; the host picks each operand's mode (stage_mode);
// - both slabs are stored swizzled (swz), so that the k-major stores of
//   a k-contiguous operand hit 32 banks a warp: with the operand-
//   stationary kernel's padded rows they took 4 passes, twice a slab;
// - the shared memory (2 x SLAB_K x (BM + BN) fp32, 64 KB at 128) is
//   dynamic, opted in once per instantiation;
// - the flush applies the epilogue and the cast straight from registers,
//   with 16-byte stores where n % 4 == 0.
// Each output sums in ascending k from 0, one fmaf a product (see the
// output-stationary note); bf16 operands convert to fp32 at staging.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    stt_tile_kernel(View<T> A, View<T> Bt, T* out, float* ws, int m, int n,
                    int k, int n_fast, int a_mode, int b_mode, Epi epi) {
  constexpr int TM = BM / 16, TN = BN / 16, QM = TM / 4, QN = TN / 4;
  constexpr int LDA = Slab<T, BM, true>::LD, LDB = Slab<T, BN, true>::LD;
  extern __shared__ __align__(16) float tsm[];
  float* As = tsm;                    // 2 x SLAB_K x LDA
  float* Bs = As + 2 * SLAB_K * LDA;  // 2 x SLAB_K x LDB
  const int b = blockIdx.z;
  const int tx = quad_tx(), ty = quad_ty();
  const long long aoff = (long long)b * A.sb, boff = (long long)b * Bt.sb;
  const long long cbase = (long long)b * m * n;
  const bool row_mode = ws != nullptr;
  const bool vec = n % 4 == 0;  // output rows hold whole float4s
  const int tm = row_mode || !n_fast ? blockIdx.x : blockIdx.y;
  const int tn_begin = row_mode ? 0 : (n_fast ? blockIdx.x : blockIdx.y);
  const int tn_end = row_mode ? cdiv(n, BN) : tn_begin + 1;
  const int m0 = tm * BM;
  const int nsl = cdiv(k, SLAB_K);
  Slab<T, BM, true> na;
  Slab<T, BN, true> nb;
  float acc[TM][TN];
  for (int tn = tn_begin; tn < tn_end; ++tn) {
    const int n0 = tn * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    na.load(A, aoff, m0, 0, m, k, a_mode);
    nb.load(Bt, boff, n0, 0, n, k, b_mode);
    na.store(As, a_mode);
    nb.store(Bs, b_mode);
    __syncthreads();
    for (int s = 0; s < nsl; ++s) {
      const bool more = s + 1 < nsl;
      if (more) {
        na.load(A, aoff, m0, (s + 1) * SLAB_K, m, k, a_mode);
        nb.load(Bt, boff, n0, (s + 1) * SLAB_K, n, k, b_mode);
      }
      fma_quads<BM, BN, TM, TN, LDB, true>(
          acc, As + (s & 1) * SLAB_K * LDA, Bs + (s & 1) * SLAB_K * LDB, ty,
          tx);
      if (more) {
        na.store(As + ((s + 1) & 1) * SLAB_K * LDA, a_mode);
        nb.store(Bs + ((s + 1) & 1) * SLAB_K * LDB, b_mode);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + (i / 4) * (BM / QM) + 4 * ty + i % 4;
      if (r >= m) continue;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int c = n0 + q * (BN / QN) + 4 * tx;
        if (c >= n) continue;
        const long long idx = cbase + (long long)r * n + c;
        const float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                     acc[i][4 * q + 2], acc[i][4 * q + 3]);
        if (row_mode)
          store4(ws, idx, v, c, n, vec);
        else
          flush4<T>(out, idx, v, c, n, vec, epi);
      }
    }
  }
  if (row_mode) {
    __syncthreads();
    flush_rows<T>(ws + cbase, out + cbase, m0, min(m, m0 + BM), n, epi);
  }
}

// ---- the streaming kernels (m <= SKINNY_M) ----
//
// A warp owns STREAM_COLS columns of one batch slice, 4 a lane, and a k
// range.  Each lane loads its B elements itself, STREAM_UK k at a time
// (STREAM_UK 16-byte loads: one per k where B is n-contiguous, one per
// column and 4 k where it is k-contiguous, elements one by one for other
// views), and issues the next group's loads before this group's FMAs, so
// 8 to 16 loads a lane are in flight.  A's rows (at most SKINNY_M) are
// staged per warp in shared memory, STREAM_AK k at a time, as Aw[k][r];
// a warp touches no barrier of its CTA on the way.  Sums run in ascending
// k, one fmaf a product, from 0.
constexpr int STREAM_COLS = 128;
constexpr int STREAM_UK = 8;
constexpr int STREAM_AK = 128;
static_assert(STREAM_AK % STREAM_UK == 0, "whole groups in an A chunk");

// B elements (k, c + j) for k in [kg, kg + STREAM_UK), as STREAM_UK
// float4s: x[u] holds k = kg + u (MODE STAGE_MN or STAGE_SCALAR) or, in
// STAGE_K, x[4 q + j] holds column c + j at k = kg + 4 q .. +3.
template <typename T, int MODE>
__device__ __forceinline__ void stream_load(float4 (&x)[STREAM_UK],
                                            const View<T>& B, long long boff,
                                            int kg, int c, int ke, int n) {
  const bool full = kg + STREAM_UK <= ke && c + 4 <= n;
  if (MODE == STAGE_MN && full) {
    const T* p = B.p + boff + (long long)kg * B.sr + c;
#pragma unroll
    for (int u = 0; u < STREAM_UK; ++u) x[u] = load4(p + (long long)u * B.sr);
  } else if (MODE == STAGE_K && full) {
    const T* p = B.p + boff + kg + (long long)c * B.sc;
#pragma unroll
    for (int q = 0; q < STREAM_UK / 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * q + j] = load4(p + 4 * q + (long long)j * B.sc);
  } else if (MODE == STAGE_K) {
#pragma unroll
    for (int q = 0; q < STREAM_UK / 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * q + j] = fetch4(B, boff, kg + 4 * q, c + j, 1, 0, ke, n, true);
  } else {
#pragma unroll
    for (int u = 0; u < STREAM_UK; ++u)
      x[u] = fetch4(B, boff, kg + u, c, 0, 1, ke, n, MODE == STAGE_MN);
  }
}

// acc[r][j] += Aw[u][r] * B(kg + u, c + j) for u ascending
template <int MR, int MODE>
__device__ __forceinline__ void stream_fma(float (&acc)[MR][4],
                                           const float4 (&x)[STREAM_UK],
                                           const float* Aw) {
#pragma unroll
  for (int u = 0; u < STREAM_UK; ++u) {
    float a[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) a[r] = Aw[u * MR + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = MODE == STAGE_K ? at(x[4 * (u / 4) + j], u % 4)
                                       : at(x[u], j);
#pragma unroll
      for (int r = 0; r < MR; ++r) acc[r][j] = fmaf(a[r], bv, acc[r][j]);
    }
  }
}

// One warp's sums over k in [kb, ke) for rows [0, MR) (zero past m) and
// columns c .. c + 3 of its lane (zero past n); Aw is the warp's own
// STREAM_AK x MR staging area.
template <typename T, int MR, int MODE>
__device__ __forceinline__ void stream_warp(float (&acc)[MR][4],
                                            const View<T>& A,
                                            const View<T>& B, long long aoff,
                                            long long boff, float* Aw, int m,
                                            int n, int c, int kb, int ke) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  if (kb >= ke) return;
  float4 cur[STREAM_UK], nxt[STREAM_UK];
  stream_load<T, MODE>(cur, B, boff, kb, c, ke, n);
#pragma unroll 1
  for (int kg = kb; kg < ke; kg += STREAM_UK) {
    const bool more = kg + STREAM_UK < ke;
    if (more) stream_load<T, MODE>(nxt, B, boff, kg + STREAM_UK, c, ke, n);
    const int off = (kg - kb) % STREAM_AK;
    if (off == 0) {  // the next A chunk, while both groups' loads fly
      __syncwarp();
      for (int e = lane; e < STREAM_AK * MR; e += 32) {
        const int kk = kg + e / MR, r = e % MR;
        Aw[e] = r < m && kk < ke
                    ? to_f(A.p[aoff + (long long)r * A.sr +
                               (long long)kk * A.sc])
                    : 0.0f;
      }
      __syncwarp();
    }
    stream_fma<MR, MODE>(acc, cur, Aw + off * MR);
    if (more) {
#pragma unroll
      for (int u = 0; u < STREAM_UK; ++u) cur[u] = nxt[u];
    }
  }
}

template <typename T, int MR>
__device__ __forceinline__ void stream_warp_any(
    float (&acc)[MR][4], const View<T>& A, const View<T>& B, long long aoff,
    long long boff, float* Aw, int m, int n, int c, int kb, int ke,
    int b_mode) {
  if (b_mode == STAGE_MN)
    stream_warp<T, MR, STAGE_MN>(acc, A, B, aoff, boff, Aw, m, n, c, kb, ke);
  else if (b_mode == STAGE_K)
    stream_warp<T, MR, STAGE_K>(acc, A, B, aoff, boff, Aw, m, n, c, kb, ke);
  else
    stream_warp<T, MR, STAGE_SCALAR>(acc, A, B, aoff, boff, Aw, m, n, c, kb,
                                     ke);
}

// Rows r < m of a lane's 4 columns: flushed to out, or (row mode) the raw
// sums stored to the workspace.
template <typename T, int MR>
__device__ __forceinline__ void stream_flush(const float (&acc)[MR][4],
                                             T* out, float* ws,
                                             long long cbase, int m, int n,
                                             int c, const Epi& epi) {
  if (c >= n) return;
  const bool vec = n % 4 == 0;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= m) break;
    const long long idx = cbase + (long long)r * n + c;
    const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (ws != nullptr)
      store4(ws, idx, v, c, n, vec);
    else
      flush4<T>(out, idx, v, c, n, vec, epi);
  }
}

// Output stationary for m <= SKINNY_M: bound by bytes (batched_gemv's
// 64 x (1 x 4096 @ 4096 x 4096) moves 4.3 GB, 1.28 ms at 3.35 TB/s).  One
// CTA per (batch slice, STREAM_WARPS x STREAM_COLS columns), each warp its
// own columns over the whole k, so every output's sum stays temporal:
// one accumulator, ascending k.  With a workspace (softmax) one CTA walks
// every column of its slice and ends with the row phase.  At m = 1 the
// registers are capped so that 4 CTAs fit an SM: batched_gemv's 512 CTAs
// then run as one wave on the 132 SMs.
constexpr int STREAM_WARPS = 4;

template <typename T, int MR>
__global__ void __launch_bounds__(STREAM_WARPS * 32, MR == 1 ? 4 : 2)
    os_stream_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n,
                     int k, int b_mode, Epi epi) {
  __shared__ float Aws[STREAM_WARPS][STREAM_AK * MR];
  constexpr int SPAN = STREAM_WARPS * STREAM_COLS;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const long long aoff = (long long)b * A.sb, boff = (long long)b * B.sb;
  const long long cbase = (long long)b * m * n;
  const int c_begin = ws != nullptr ? 0 : blockIdx.x * SPAN;
  const int c_end = ws != nullptr ? n : min(n, c_begin + SPAN);
  for (int c0 = c_begin + w * STREAM_COLS; c0 < c_end; c0 += SPAN) {
    float acc[MR][4];
    const int c = c0 + 4 * lane;
    stream_warp_any<T, MR>(acc, A, B, aoff, boff, Aws[w], m, n, c, 0, k,
                           b_mode);
    stream_flush<T, MR>(acc, out, ws, cbase, m, n, c, epi);
  }
  if (ws != nullptr) {
    __syncthreads();
    flush_rows<T>(ws + cbase, out + cbase, 0, m, n, epi);
  }
}

// Reduction-tree template (also "streaming"); replaces the reference's
// kernels/stt_gemm.py:matmul_reduction_tree (_rt_kernel): one full-K
// reduction per output block with nothing resident between blocks.
// - m > SKINNY_M: stt_tile_kernel, one pass over the full K (FLOPs-bound
//   on large shapes, as the output-stationary template);
// - m <= SKINNY_M (the main path's streaming batched_gemv and
//   depthwise_conv): rt_tree_kernel, bound by bytes (the same 4.3 GB at
//   batched_gemv as above).  k is made spatial, as the paper's adder tree
//   does: one CTA per (batch slice, STREAM_COLS columns), whose
//   TREE_WARPS warps split k into contiguous ranges (a multiple of
//   STREAM_UK each), each warp streaming its range in ascending k; the
//   warps' partial sums then meet in shared memory in a fixed binary tree
//   (warp w adds warp w + s for s = TREE_WARPS / 2, ..., 1).  The order
//   depends on the tile constants only, never on scheduling, and there
//   are no atomics; with batched_gemv's 2,048 CTAs the grid fills the
//   card many times over, so there is no split across CTAs.  With a
//   workspace (softmax) one CTA walks every column block of its slice
//   and ends with the row phase.
constexpr int TREE_WARPS = 8;
// the tree's partial sums reuse the A staging area
static_assert(STREAM_AK >= 32 * 4, "tree sums fit the A staging area");

template <typename T, int MR>
__global__ void __launch_bounds__(TREE_WARPS * 32)
    rt_tree_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n,
                   int k, int b_mode, Epi epi) {
  __shared__ __align__(16) float tree[TREE_WARPS * STREAM_AK * MR];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const long long aoff = (long long)b * A.sb, boff = (long long)b * B.sb;
  const long long cbase = (long long)b * m * n;
  const int len = cdiv(cdiv(k, TREE_WARPS), STREAM_UK) * STREAM_UK;
  const int kb = min(k, w * len), ke = min(k, kb + len);
  const int c_begin = ws != nullptr ? 0 : blockIdx.x * STREAM_COLS;
  const int c_end = ws != nullptr ? n : c_begin + 1;
  float4* part = reinterpret_cast<float4*>(tree);  // [warp][row][lane]
  for (int c0 = c_begin; c0 < c_end; c0 += STREAM_COLS) {
    float acc[MR][4];
    const int c = c0 + 4 * lane;
    stream_warp_any<T, MR>(acc, A, B, aoff, boff,
                           tree + w * STREAM_AK * MR, m, n, c, kb, ke,
                           b_mode);
    __syncthreads();  // every warp is done with its A chunks
#pragma unroll
    for (int r = 0; r < MR; ++r)
      part[(w * MR + r) * 32 + lane] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
#pragma unroll
    for (int s = TREE_WARPS / 2; s > 0; s /= 2) {
      if (w < s) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const float4 o = part[((w + s) * MR + r) * 32 + lane];
          acc[r][0] += o.x; acc[r][1] += o.y; acc[r][2] += o.z;
          acc[r][3] += o.w;
          if (s > 1)
            part[(w * MR + r) * 32 + lane] =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
      __syncthreads();
    }
    if (w == 0) stream_flush<T, MR>(acc, out, ws, cbase, m, n, c, epi);
  }
  if (ws != nullptr) {
    __syncthreads();
    flush_rows<T>(ws + cbase, out + cbase, 0, m, n, epi);
  }
}

// k depth of the operand-stationary kernels' pinned B chunk
// (kernels/stt_gemm.py:WS_CHUNK_K), a whole number of slabs
constexpr int WS_KC = 256;
static_assert(WS_KC % SLAB_K == 0, "the pinned chunk holds whole slabs");

// Operand-stationary template (stationary="B"); replaces the reference's
// kernels/stt_gemm.py:matmul_operand_stationary (_ws_kernel).  Per batch
// slice and n tile, each WS_KC-deep chunk of B is loaded into shared
// memory once and stays pinned while the CTA sweeps its whole range of m
// rows; the (m, BN) strip of partial sums accumulates in the caller's fp32
// global workspace.  CTAs along y split m so that the card has enough
// CTAs; each row range still sees one B chunk per k-chunk.  With
// `row_mode` (softmax) a CTA covers every n tile and ends with the row
// phase.
//
// What bounds it on the H100: fp32 FLOPs on the CUDA cores (67 TFLOP/s;
// gemm 4096^3: 2.05 ms), plus the strip's own term.  The design:
// - ws_tile_kernel, for n > 8: the SIMT tile of simt_tile.cuh (128 x 128,
//   or 64 x 64 where 128-wide tiles would not fill one wave of the card;
//   float4 quadrant fragments in warps of 4 x 8 threads), with the
//   stationary operand in place of a streamed B slab;
// - the pinned chunk is WS_KC x BN fp32 in dynamic shared memory (128 KB
//   at 128 wide), loaded with 8 vector loads in flight a thread; A streams
//   through it in SLAB_K-deep slabs (Slab), double buffered with one
//   barrier a slab (2048 FMAs a thread);
// - both operands of the timed gemm arrive k-contiguous (A row-major, B
//   as gemm's B.T view); cp.async cannot transpose, so staging goes
//   through registers and stores k-major.  A view with no unit stride or
//   a misaligned one takes scalar staging; the host picks the mode of
//   each operand per launch (stage_mode);
// - the strip is read-modify-written once per (m tile, chunk): its fp32
//   values are copied into shared memory by cp.async while the m tile is
//   multiplied, and written back as float4 where n allows; the last chunk
//   flushes (epilogue + cast) straight from registers, so (2 * ceil(k /
//   WS_KC) - 2) passes over the fp32 (m, n) strip remain (1.9 GB at
//   4096^3, 0.57 ms at full memory rate, under the FLOPs).  Two waves of
//   CTAs (at most 512 rows each) keep the strip of the CTAs in flight, 34
//   MB at 4096^3, inside L2.
// Sums run in a fixed order, with no atomics: within a chunk in ascending
// k (one fmaf at a time), then chunks in ascending order.  bf16 operands
// run the same fp32 loop, converted at staging.
//
// ws_kernel keeps the first version's shape for n <= 8 (StripN, the
// input-stationary transposition of matvec-like forms).
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

// The pinned chunk Bs[k][c] = B[kc + k][n0 + c] for k < WS_KC, c < BN;
// zero past kend and n.
template <typename T, int BN>
__device__ __forceinline__ void load_chunk(float* Bs, const View<T>& B,
                                           long long boff, int kc, int n0,
                                           int kend, int n, int mode) {
  if (mode == STAGE_MN) {  // 4 columns at one k
    for (int f = threadIdx.x; f < WS_KC * BN / 4; f += TILE_THREADS) {
      const int c = 4 * (f % (BN / 4)), kq = f / (BN / 4);
      *reinterpret_cast<float4*>(Bs + kq * BN + c) =
          fetch4(B, boff, kc + kq, n0 + c, 0, 1, kend, n, true);
    }
  } else if (mode == STAGE_K && kc + WS_KC <= kend && n0 + BN <= n) {
    // the whole chunk in range: 4 k at one column, a warp spanning
    // columns, 8 loads in flight before their stores
    constexpr int PER = WS_KC * BN / 4 / TILE_THREADS, U = 8;
    static_assert(PER % U == 0, "whole rounds of loads");
    const T* base = B.p + boff + (long long)kc * B.sr + (long long)n0 * B.sc;
#pragma unroll 1
    for (int u0 = 0; u0 < PER; u0 += U) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = threadIdx.x + (u0 + u) * TILE_THREADS;
        x[u] = load4(base + (long long)(f % BN) * B.sc + 4 * (f / BN));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = threadIdx.x + (u0 + u) * TILE_THREADS;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Bs[(4 * (f / BN) + j) * BN + f % BN] = at(x[u], j);
      }
    }
  } else if (mode == STAGE_K) {  // 4 k at one column; a warp spans columns
#pragma unroll 4
    for (int f = threadIdx.x; f < WS_KC * BN / 4; f += TILE_THREADS) {
      const int c = f % BN, kq = 4 * (f / BN);
      const float4 x = fetch4(B, boff, kc + kq, n0 + c, 1, 0, kend, n, true);
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[(kq + j) * BN + c] = at(x, j);
    }
  } else {
    for (int f = threadIdx.x; f < WS_KC * BN; f += TILE_THREADS) {
      const int c = f % BN, kk = f / BN;
      Bs[kk * BN + c] =
          kc + kk < kend && n0 + c < n
              ? to_f(B.p[boff + (long long)(kc + kk) * B.sr +
                         (long long)(n0 + c) * B.sc])
              : 0.0f;
    }
  }
}

// Start copying this thread's entries of the fp32 strip of an m tile into
// shared memory (Ss: float4 j of thread t at 4 (j * TILE_THREADS + t)),
// where strip_update reads them back; whole float4s only (vec).
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void strip_prefetch(float* Ss, const float* wsb,
                                               int m0, int n0, int r_end,
                                               int n, int ty, int tx) {
  constexpr int QM = TM / 4, QN = TN / 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i / 4) * (BM / QM) + 4 * ty + i % 4;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int c = n0 + q * (BN / QN) + 4 * tx;
      const bool in = r < r_end && c < n;
      cp_async16(Ss + 4 * ((i * QN + q) * TILE_THREADS + threadIdx.x),
                 in ? wsb + (long long)r * n + c : wsb, in ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One m tile's partial sums of this chunk into the strip: strip + part
// (part alone at the first chunk); at the last chunk outside row mode the
// sum is flushed to `out` instead of stored.
template <typename T, int BM, int BN, int TM, int TN>
__device__ __forceinline__ void strip_update(
    float (&acc)[TM][TN], float* wsb, const float* Ss, T* outb, int m0,
    int n0, int r_end, int n, bool first, bool flush, bool vec, int ty,
    int tx, const Epi& epi) {
  constexpr int QM = TM / 4, QN = TN / 4;
  if (!first && vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i / 4) * (BM / QM) + 4 * ty + i % 4;
    if (r >= r_end) continue;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int c = n0 + q * (BN / QN) + 4 * tx;
      if (c >= n) continue;
      const long long idx = (long long)r * n + c;
      float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                             acc[i][4 * q + 2], acc[i][4 * q + 3]);
      if (!first) {
        if (vec) {
          const float4 w = *reinterpret_cast<const float4*>(
              Ss + 4 * ((i * QN + q) * TILE_THREADS + threadIdx.x));
          v.x = w.x + v.x; v.y = w.y + v.y; v.z = w.z + v.z;
          v.w = w.w + v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < n) at(v, j) = wsb[idx + j] + at(v, j);
        }
      }
      if (flush)
        flush4<T>(outb, idx, v, c, n, vec, epi);
      else
        store4(wsb, idx, v, c, n, vec);
    }
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    ws_tile_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n,
                   int k, int rows_per_cta, int row_mode, int a_mode,
                   int b_mode, Epi epi) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = Slab<T, BM, false>::LD;
  extern __shared__ __align__(16) float wsm[];
  float* Bs = wsm;                    // WS_KC x BN, the pinned chunk
  float* As = Bs + WS_KC * BN;        // 2 x SLAB_K x LDA, the A slabs
  float* Ss = As + 2 * SLAB_K * LDA;  // BM x BN, an m tile's strip
  const int b = blockIdx.z;
  const int tx = quad_tx(), ty = quad_ty();
  const long long aoff = (long long)b * A.sb, boff = (long long)b * B.sb;
  const long long cbase = (long long)b * m * n;
  float* wsb = ws + cbase;
  T* outb = out + cbase;
  const bool vec = n % 4 == 0;  // strip and output rows hold whole float4s
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(m, r_begin + rows_per_cta);
  const int n_mt = (r_end - r_begin + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int tn_begin = row_mode ? 0 : blockIdx.x;
  const int tn_end = row_mode ? tiles_n : blockIdx.x + 1;
  Slab<T, BM, false> next;
  float acc[TM][TN];
  for (int tn = tn_begin; tn < tn_end; ++tn) {
    const int n0 = tn * BN;
    for (int kc = 0; kc < k; kc += WS_KC) {
      const int kend = min(k, kc + WS_KC);
      const int nsl = (kend - kc + SLAB_K - 1) / SLAB_K;  // slabs a tile
      const int total = n_mt * nsl;
      __syncthreads();  // the previous chunk's readers are done
      load_chunk<T, BN>(Bs, B, boff, kc, n0, kend, n, b_mode);
      next.load(A, aoff, r_begin, kc, m, kend, a_mode);
      next.store(As, a_mode);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      // one stream of slabs over every m tile of the chunk: slab s of m
      // tile mt, then slab s2 of m tile mt2
      for (int it = 0, mt = 0, s = 0; it < total; ++it) {
        const bool more = it + 1 < total;
        const int s2 = s + 1 < nsl ? s + 1 : 0, mt2 = s2 ? mt : mt + 1;
        // the strip this m tile adds to flies in while it is multiplied
        if (s == 0 && kc > 0 && vec)
          strip_prefetch<BM, BN, TM, TN>(Ss, wsb, r_begin + mt * BM, n0,
                                         r_end, n, ty, tx);
        if (more)
          next.load(A, aoff, r_begin + mt2 * BM, kc + s2 * SLAB_K, m, kend,
                    a_mode);
        fma_quads<BM, BN, TM, TN, BN, false>(
            acc, As + (it & 1) * SLAB_K * LDA, Bs + s * SLAB_K * BN, ty, tx);
        if (s == nsl - 1) {
          strip_update<T, BM, BN, TM, TN>(
              acc, wsb, Ss, outb, r_begin + mt * BM, n0, r_end, n, kc == 0,
              kend == k && !row_mode, vec, ty, tx, epi);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
        }
        if (more) next.store(As + ((it + 1) & 1) * SLAB_K * LDA, a_mode);
        __syncthreads();
        s = s2;
        mt = mt2;
      }
    }
  }
  if (row_mode) {
    __syncthreads();
    flush_rows<T>(wsb, outb, r_begin, r_end, n, epi);
  }
}

// Square tile configurations of the SIMT tile kernels, and a narrow-n one
// for the operand-stationary transposition of matvec-like forms (n of 1).
template <int BM_, int BN_>
struct SimtTile { static constexpr int BM = BM_, BN = BN_; };
using TileWide = SimtTile<128, 128>;
using TileNarrow = SimtTile<64, 64>;
struct StripN { static constexpr int BM = 128, BN = 8, BK = 8, TM = 4, TN = 1, KC = WS_KC; };

// 128-wide tiles where they fill one wave of the card's 132 SMs
bool wide_tile(int m, int n, int nb, bool row_mode) {
  const long long ctas = (long long)(row_mode ? 1 : cdiv(n, TileWide::BN)) *
                         cdiv(m, TileWide::BM) * nb;
  return ctas >= 132;
}

template <typename C>
dim3 tile_grid(int m, int n, int nb, bool row_mode, int n_fast) {
  const int tm = cdiv(m, C::BM), tn = cdiv(n, C::BN);
  if (row_mode) return dim3(tm, 1, nb);
  return n_fast ? dim3(tn, tm, nb) : dim3(tm, tn, nb);
}

// Opt a kernel into `smem` bytes of dynamic shared memory, once.
template <typename K>
cudaError_t opt_in_smem(K kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = e == cudaSuccess;
  return e;
}

template <typename T, typename C>
int os_inplace_launch(View<T> A, View<T> B, void* out, void* ws, int nb,
                      int m, int n, int k, int kstep, int n_fast, Epi epi,
                      cudaStream_t st) {
  const dim3 g = tile_grid<C>(m, n, nb, ws != nullptr, n_fast);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  os_inplace_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k,
          kstep, n_fast, epi);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int tile_launch(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                int n, int k, int n_fast, int a_mode, int b_mode, Epi epi,
                cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr int smem = 2 * SLAB_K *
                       (Slab<T, C::BM, true>::LD + Slab<T, C::BN, true>::LD) *
                       (int)sizeof(float);
  const cudaError_t e =
      opt_in_smem(stt_tile_kernel<T, C::BM, C::BN>, smem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 g = tile_grid<C>(m, n, nb, ws != nullptr, n_fast);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  stt_tile_kernel<T, C::BM, C::BN><<<g, TILE_THREADS, smem, st>>>(
      A, transposed(B), static_cast<T*>(out),
      static_cast<float*>(ws), m, n, k, n_fast, a_mode, b_mode, epi);
  return (int)cudaGetLastError();
}

// The tile kernel of both templates (m > SKINNY_M), on the tile that
// fills the card.
template <typename T>
int tile_dispatch(const void* a, long long a_sb, long long a_sr,
                  long long a_sc, const void* b, long long b_sb,
                  long long b_sr, long long b_sc, void* out, void* ws,
                  int nb, int m, int n, int k, int n_fast, Epi epi,
                  cudaStream_t st) {
  View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
  View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
  const int a_mode = stage_mode<T>(a, a_sb, a_sc, a_sr);
  const int b_mode = stage_mode<T>(b, b_sb, b_sr, b_sc);
  if (wide_tile(m, n, nb, ws != nullptr))
    return tile_launch<T, TileWide>(A, B, out, ws, nb, m, n, k, n_fast,
                                    a_mode, b_mode, epi, st);
  return tile_launch<T, TileNarrow>(A, B, out, ws, nb, m, n, k, n_fast,
                                    a_mode, b_mode, epi, st);
}

// The streaming kernels (m <= SKINNY_M): a row count of 1 (the batched
// forms' m) or up to SKINNY_M.
template <typename T, int MR>
int skinny_launch_mr(View<T> A, View<T> B, void* out, void* ws, int nb,
                     int m, int n, int k, int b_mode, bool tree, Epi epi,
                     cudaStream_t st) {
  const int span = tree ? STREAM_COLS : STREAM_WARPS * STREAM_COLS;
  const dim3 g(ws != nullptr ? 1 : cdiv(n, span), 1, nb);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  if (tree)
    rt_tree_kernel<T, MR><<<g, TREE_WARPS * 32, 0, st>>>(
        A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k,
        b_mode, epi);
  else
    os_stream_kernel<T, MR><<<g, STREAM_WARPS * 32, 0, st>>>(
        A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k,
        b_mode, epi);
  return (int)cudaGetLastError();
}

template <typename T>
int skinny_dispatch(const void* a, long long a_sb, long long a_sr,
                    long long a_sc, const void* b, long long b_sb,
                    long long b_sr, long long b_sc, void* out, void* ws,
                    int nb, int m, int n, int k, bool tree, Epi epi,
                    cudaStream_t st) {
  View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
  View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
  const int b_mode = stage_mode<T>(b, b_sb, b_sr, b_sc);
  if (m == 1)
    return skinny_launch_mr<T, 1>(A, B, out, ws, nb, m, n, k, b_mode, tree,
                                  epi, st);
  return skinny_launch_mr<T, SKINNY_M>(A, B, out, ws, nb, m, n, k, b_mode,
                                       tree, epi, st);
}

template <typename T>
int os_dispatch(const void* a, long long a_sb, long long a_sr,
                long long a_sc, const void* b, long long b_sb,
                long long b_sr, long long b_sc, void* out, void* ws, int nb,
                int m, int n, int k, int kstep, int inplace, int n_fast,
                Epi epi, cudaStream_t st) {
  if (inplace) {
    View<T> A = make_view<T>(a, a_sb, a_sr, a_sc);
    View<T> B = make_view<T>(b, b_sb, b_sr, b_sc);
    return m <= SKINNY_M
               ? os_inplace_launch<T, TileS>(A, B, out, ws, nb, m, n, k,
                                             kstep, n_fast, epi, st)
               : os_inplace_launch<T, TileL>(A, B, out, ws, nb, m, n, k,
                                             kstep, n_fast, epi, st);
  }
  if (m <= SKINNY_M)
    return skinny_dispatch<T>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out,
                              ws, nb, m, n, k, false, epi, st);
  return tile_dispatch<T>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out, ws,
                          nb, m, n, k, n_fast, epi, st);
}

template <typename T>
int rt_dispatch(const void* a, long long a_sb, long long a_sr,
                long long a_sc, const void* b, long long b_sb,
                long long b_sr, long long b_sc, void* out, void* ws, int nb,
                int m, int n, int k, int n_fast, Epi epi, cudaStream_t st) {
  if (m <= SKINNY_M)
    return skinny_dispatch<T>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out,
                              ws, nb, m, n, k, true, epi, st);
  return tile_dispatch<T>(a, a_sb, a_sr, a_sc, b, b_sb, b_sr, b_sc, out, ws,
                          nb, m, n, k, n_fast, epi, st);
}

// CTAs along m for the operand-stationary grid: enough CTAs in all to
// cover the card's 132 SMs `waves` times over, each with a whole number
// of BM row tiles.  Fewer, longer CTAs load the pinned chunk fewer times;
// the tile kernel takes two waves (one or two CTAs an SM), which keeps the
// strip of the CTAs in flight (at most 512 rows x 128 x 4 bytes each) in
// L2.
template <typename C>
int ws_rows_per_cta(int m, int n, int nb, bool row_mode, int waves) {
  const int target = waves * 132;
  const int col_ctas = (row_mode ? 1 : cdiv(n, C::BN)) * nb;
  const int m_tiles = cdiv(m, C::BM);
  int splits = cdiv(target, col_ctas);
  splits = splits < 1 ? 1 : (splits > m_tiles ? m_tiles : splits);
  return cdiv(m_tiles, splits) * C::BM;
}

template <typename T>
int ws_strip_launch(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                    int n, int k, int row_mode, Epi epi, cudaStream_t st) {
  using C = StripN;
  const int rows = ws_rows_per_cta<C>(m, n, nb, row_mode != 0, 4);
  const dim3 g(row_mode ? 1 : cdiv(n, C::BN), cdiv(m, rows), nb);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  ws_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN, C::KC>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k, rows,
          row_mode, epi);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int ws_tile_launch(View<T> A, View<T> B, void* out, void* ws, int nb, int m,
                   int n, int k, int row_mode, int a_mode, int b_mode,
                   Epi epi, cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr int smem =
      (WS_KC * C::BN + 2 * SLAB_K * Slab<T, C::BM, false>::LD +
       C::BM * C::BN) *
      (int)sizeof(float);
  const cudaError_t e =
      opt_in_smem(ws_tile_kernel<T, C::BM, C::BN>, smem, attr_set);
  if (e != cudaSuccess) return (int)e;
  const int rows = ws_rows_per_cta<C>(m, n, nb, row_mode != 0, 2);
  const dim3 g(row_mode ? 1 : cdiv(n, C::BN), cdiv(m, rows), nb);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  ws_tile_kernel<T, C::BM, C::BN><<<g, TILE_THREADS, smem, st>>>(
      A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k, rows,
      row_mode, a_mode, b_mode, epi);
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
    return ws_strip_launch<T>(A, B, out, ws, nb, m, n, k, row_mode, epi, st);
  const int a_mode = stage_mode<T>(a, a_sb, a_sc, a_sr);
  const int b_mode = stage_mode<T>(b, b_sb, b_sr, b_sc);
  if (wide_tile(m, n, nb, row_mode != 0))
    return ws_tile_launch<T, TileWide>(A, B, out, ws, nb, m, n, k, row_mode,
                                       a_mode, b_mode, epi, st);
  return ws_tile_launch<T, TileNarrow>(A, B, out, ws, nb, m, n, k, row_mode,
                                       a_mode, b_mode, epi, st);
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
