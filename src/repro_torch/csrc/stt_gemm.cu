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
// strip is read-modify-written once per k-chunk.  All are SIMT tiles
// (register micro-tiles fed from shared memory).  The operand-stationary
// tile kernel has its own mainloop (float4 fragments, double-buffered A
// slabs, one barrier a slab; see ws_tile_kernel), written as device
// functions of its own so that the output-stationary template can adopt
// it; the others still stage element by element through common.cuh.
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

// k depth of the operand-stationary kernels' pinned B chunk
// (kernels/stt_gemm.py:WS_CHUNK_K), of a streamed A slab, and the tile
// kernel's threads (16 x 16)
constexpr int WS_KC = 256;
constexpr int WS_BK = 32;
constexpr int WS_THREADS = 256;

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
// - ws_tile_kernel, for n > 8: a BM x BN CTA tile (128 x 128, or 64 x 64
//   where 128-wide tiles would not fill one wave of the card), 256
//   threads, each owning a TM x TN register tile laid out as 4-wide
//   quadrants (rows 4 ty + i and BM/2 + 4 ty + i at 128), so that every k
//   step reads A and B fragments from shared memory as float4: 64 FMAs for
//   4 shared loads at 128 x 128.  A warp covers 4 x 8 threads of the 16 x
//   16 grid, so its fragment loads touch 4 (A) and 8 (B) distinct float4s,
//   one shared-memory wavefront each;
// - the pinned chunk is WS_KC x BN fp32 in dynamic shared memory (128 KB
//   at 128 wide), loaded with 8 vector loads in flight a thread; A streams
//   through it in WS_BK-deep slabs, double buffered: the next slab's
//   global loads (16 bytes, or 8 for bf16, wherever the view's unit
//   stride and alignment allow) are issued before this slab's FMAs and
//   stored to the other buffer after them, so one barrier a slab (2048
//   FMAs a thread) remains;
// - both operands of the timed gemm arrive k-contiguous (A row-major, B
//   as gemm's B.T view); cp.async cannot transpose, so staging goes
//   through registers and stores k-major.  A view with no unit stride or
//   a misaligned one takes scalar staging; the host picks the mode of
//   each operand per launch (Stage);
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

// How an operand's tile is staged: 4 elements a load along k, 4 along its
// other axis (m for A, n for B), or one at a time (any view).
enum Stage { STAGE_SCALAR = 0, STAGE_K = 1, STAGE_MN = 2 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// element j of a float4 (j a constant after unrolling)
__device__ __forceinline__ float& at(float4& v, int j) {
  return (&v.x)[j];
}
__device__ __forceinline__ float at(const float4& v, int j) {
  return (&v.x)[j];
}

// Elements (r + j * dr, c + j * dc), j = 0..3, one of dr and dc 1 and the
// other 0, of one batch slice of a view as fp32: one vector load when
// `vec` and all four lie inside [0, rmax) x [0, cmax), else element by
// element with zeros outside.
template <typename T>
__device__ __forceinline__ float4 fetch4(const View<T>& v, long long boff,
                                         int r, int c, int dr, int dc,
                                         int rmax, int cmax, bool vec) {
  if (vec && r + 3 * dr < rmax && c + 3 * dc < cmax)
    return load4(v.p + boff + (long long)r * v.sr + (long long)c * v.sc);
  float4 x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = r + j * dr, cc = c + j * dc;
    at(x, j) = rr < rmax && cc < cmax
                   ? to_f(v.p[boff + (long long)rr * v.sr +
                              (long long)cc * v.sc])
                   : 0.0f;
  }
  return x;
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// The next A slab (rows [m0, m0 + BM) x k [kk, kk + WS_BK)), held in
// registers between its global loads and its k-major store As[k][r].
template <typename T, int BM>
struct ASlab {
  static constexpr int LDA = BM + 4;  // float4 rows, offset banks
  static constexpr int N4 = BM * WS_BK / 4 / WS_THREADS;
  float4 v[N4];

  __device__ __forceinline__ void load(const View<T>& A, long long aoff,
                                       int m0, int kk, int m, int kend,
                                       int mode) {
    if (mode != STAGE_SCALAR && m0 + BM <= m && kk + WS_BK <= kend) {
      // the whole slab in range: vector loads, no element checks
      const T* base = A.p + aoff + (long long)m0 * A.sr + (long long)kk * A.sc;
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        const int idx = threadIdx.x + i * WS_THREADS;
        if (mode == STAGE_MN)
          v[i] = load4(base + 4 * (idx % (BM / 4)) +
                       (long long)(idx / (BM / 4)) * A.sc);
        else
          v[i] = load4(base + (long long)(idx / (WS_BK / 4)) * A.sr +
                       4 * (idx % (WS_BK / 4)));
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const int idx = threadIdx.x + i * WS_THREADS;
      if (mode == STAGE_MN) {  // 4 rows at one k
        const int r = 4 * (idx % (BM / 4)), kq = idx / (BM / 4);
        v[i] = fetch4(A, aoff, m0 + r, kk + kq, 1, 0, m, kend, true);
      } else {                 // 4 k at one row
        const int r = idx / (WS_BK / 4), kq = 4 * (idx % (WS_BK / 4));
        v[i] = fetch4(A, aoff, m0 + r, kk + kq, 0, 1, m, kend,
                      mode == STAGE_K);
      }
    }
  }
  __device__ __forceinline__ void store(float* As, int mode) const {
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const int idx = threadIdx.x + i * WS_THREADS;
      if (mode == STAGE_MN) {
        const int r = 4 * (idx % (BM / 4)), kq = idx / (BM / 4);
        *reinterpret_cast<float4*>(As + kq * LDA + r) = v[i];
      } else {
        const int r = idx / (WS_BK / 4), kq = 4 * (idx % (WS_BK / 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) As[(kq + j) * LDA + r] = at(v[i], j);
      }
    }
  }
};

// The pinned chunk Bs[k][c] = B[kc + k][n0 + c] for k < WS_KC, c < BN;
// zero past kend and n.
template <typename T, int BN>
__device__ __forceinline__ void load_chunk(float* Bs, const View<T>& B,
                                           long long boff, int kc, int n0,
                                           int kend, int n, int mode) {
  if (mode == STAGE_MN) {  // 4 columns at one k
    for (int f = threadIdx.x; f < WS_KC * BN / 4; f += WS_THREADS) {
      const int c = 4 * (f % (BN / 4)), kq = f / (BN / 4);
      *reinterpret_cast<float4*>(Bs + kq * BN + c) =
          fetch4(B, boff, kc + kq, n0 + c, 0, 1, kend, n, true);
    }
  } else if (mode == STAGE_K && kc + WS_KC <= kend && n0 + BN <= n) {
    // the whole chunk in range: 4 k at one column, a warp spanning
    // columns, 8 loads in flight before their stores
    constexpr int PER = WS_KC * BN / 4 / WS_THREADS, U = 8;
    static_assert(PER % U == 0, "whole rounds of loads");
    const T* base = B.p + boff + (long long)kc * B.sr + (long long)n0 * B.sc;
#pragma unroll 1
    for (int u0 = 0; u0 < PER; u0 += U) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = threadIdx.x + (u0 + u) * WS_THREADS;
        x[u] = load4(base + (long long)(f % BN) * B.sc + 4 * (f / BN));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = threadIdx.x + (u0 + u) * WS_THREADS;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Bs[(4 * (f / BN) + j) * BN + f % BN] = at(x[u], j);
      }
    }
  } else if (mode == STAGE_K) {  // 4 k at one column; a warp spans columns
#pragma unroll 4
    for (int f = threadIdx.x; f < WS_KC * BN / 4; f += WS_THREADS) {
      const int c = f % BN, kq = 4 * (f / BN);
      const float4 x = fetch4(B, boff, kc + kq, n0 + c, 1, 0, kend, n, true);
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[(kq + j) * BN + c] = at(x, j);
    }
  } else {
    for (int f = threadIdx.x; f < WS_KC * BN; f += WS_THREADS) {
      const int c = f % BN, kk = f / BN;
      Bs[kk * BN + c] =
          kc + kk < kend && n0 + c < n
              ? to_f(B.p[boff + (long long)(kc + kk) * B.sr +
                         (long long)(n0 + c) * B.sc])
              : 0.0f;
    }
  }
}

// acc += As(:, slab) x Bs(slab, :) over WS_BK k, ascending.  Thread (ty,
// tx) owns rows q * (BM / QM) + 4 ty + i and columns q * (BN / QN) + 4 tx
// + j of the tile.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void fma_quads(float (&acc)[TM][TN],
                                          const float* As, const float* Bs,
                                          int ty, int tx) {
  constexpr int QM = TM / 4, QN = TN / 4, LDA = BM + 4;
#pragma unroll
  for (int kq = 0; kq < WS_BK; ++kq) {
    float a[TM], bv[TN];
#pragma unroll
    for (int q = 0; q < QM; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(
          As + kq * LDA + q * (BM / QM) + 4 * ty);
      a[4 * q] = x.x; a[4 * q + 1] = x.y; a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(
          Bs + kq * BN + q * (BN / QN) + 4 * tx);
      bv[4 * q] = x.x; bv[4 * q + 1] = x.y; bv[4 * q + 2] = x.z;
      bv[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// 4 flushed values (epilogue + cast) at out[idx + j], columns c + j < n.
template <typename T>
__device__ __forceinline__ void flush4(T* out, long long idx, float4 v,
                                       int c, int n, bool vec,
                                       const Epi& epi) {
  if (vec && epi.n_ops == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out + idx) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(out + idx) = u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) flush_store<T>(out, idx + j, at(v, j), c + j, epi);
}

// One m tile's partial sums of this chunk into the strip: strip + part
// (part alone at the first chunk); at the last chunk outside row mode the
// sum is flushed to `out` instead of stored.
// Thread (ty, tx) of the 16 x 16 grid: warp w covers ty 4 (w / 2) ..
// +3 and tx 8 (w % 2) .. +7, so that a warp's float4 fragment loads hit 4
// (A) and 8 (B) distinct addresses, one shared-memory wavefront each.
__device__ __forceinline__ int ws_ty() {
  return 4 * (threadIdx.x / 64) + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int ws_tx() {
  return 8 * ((threadIdx.x / 32) % 2) + threadIdx.x % 8;
}

// Start copying this thread's entries of the fp32 strip of an m tile into
// shared memory (Ss: float4 j of thread t at 4 (j * WS_THREADS + t)),
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
      cp_async16(Ss + 4 * ((i * QN + q) * WS_THREADS + threadIdx.x),
                 in ? wsb + (long long)r * n + c : wsb, in ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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
              Ss + 4 * ((i * QN + q) * WS_THREADS + threadIdx.x));
          v.x = w.x + v.x; v.y = w.y + v.y; v.z = w.z + v.z;
          v.w = w.w + v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < n) at(v, j) = wsb[idx + j] + at(v, j);
        }
      }
      if (flush) {
        flush4<T>(outb, idx, v, c, n, vec, epi);
      } else if (vec) {
        *reinterpret_cast<float4*>(wsb + idx) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) wsb[idx + j] = at(v, j);
      }
    }
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(WS_THREADS, 1)
    ws_tile_kernel(View<T> A, View<T> B, T* out, float* ws, int m, int n,
                   int k, int rows_per_cta, int row_mode, int a_mode,
                   int b_mode, Epi epi) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = ASlab<T, BM>::LDA;
  extern __shared__ __align__(16) float wsm[];
  float* Bs = wsm;                    // WS_KC x BN, the pinned chunk
  float* As = Bs + WS_KC * BN;        // 2 x WS_BK x LDA, the A slabs
  float* Ss = As + 2 * WS_BK * LDA;   // BM x BN, an m tile's strip
  const int b = blockIdx.z;
  const int tx = ws_tx(), ty = ws_ty();
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
  ASlab<T, BM> next;
  float acc[TM][TN];
  for (int tn = tn_begin; tn < tn_end; ++tn) {
    const int n0 = tn * BN;
    for (int kc = 0; kc < k; kc += WS_KC) {
      const int kend = min(k, kc + WS_KC);
      const int nsl = (kend - kc + WS_BK - 1) / WS_BK;  // slabs a tile
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
          next.load(A, aoff, r_begin + mt2 * BM, kc + s2 * WS_BK, m, kend,
                    a_mode);
        fma_quads<BM, BN, TM, TN>(acc, As + (it & 1) * WS_BK * LDA,
                                  Bs + s * WS_BK * BN, ty, tx);
        if (s == nsl - 1) {
          strip_update<T, BM, BN, TM, TN>(
              acc, wsb, Ss, outb, r_begin + mt * BM, n0, r_end, n, kc == 0,
              kend == k && !row_mode, vec, ty, tx, epi);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
        }
        if (more) next.store(As + ((it + 1) & 1) * WS_BK * LDA, a_mode);
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

// Operand-stationary configurations: the tile kernel's square tiles, and
// a narrow-n one for the input-stationary transposition of matvec-like
// forms (n of 1).
template <int BM_, int BN_>
struct WsTile { static constexpr int BM = BM_, BN = BN_; };
using WsL = WsTile<128, 128>;
using WsM = WsTile<64, 64>;
struct StripN { static constexpr int BM = 128, BN = 8, BK = 8, TM = 4, TN = 1, KC = WS_KC; };

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
      (WS_KC * C::BN + 2 * WS_BK * (C::BM + 4) + C::BM * C::BN) *
      (int)sizeof(float);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ws_tile_kernel<T, C::BM, C::BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = ws_rows_per_cta<C>(m, n, nb, row_mode != 0, 2);
  const dim3 g(row_mode ? 1 : cdiv(n, C::BN), cdiv(m, rows), nb);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  ws_tile_kernel<T, C::BM, C::BN><<<g, WS_THREADS, smem, st>>>(
      A, B, static_cast<T*>(out), static_cast<float*>(ws), m, n, k, rows,
      row_mode, a_mode, b_mode, epi);
  return (int)cudaGetLastError();
}

// The staging mode of one operand: s_k is its stride along k, s_o along
// its other axis.  Vector loads need that axis's unit stride, the other
// strides and the base pointer in whole 4-element steps.
template <typename T>
int stage_mode(const void* p, long long sb, long long s_k, long long s_o) {
  const bool aligned =
      reinterpret_cast<unsigned long long>(p) % (4 * sizeof(T)) == 0 &&
      sb % 4 == 0;
  if (aligned && s_k == 1 && s_o % 4 == 0) return STAGE_K;
  if (aligned && s_o == 1 && s_k % 4 == 0) return STAGE_MN;
  return STAGE_SCALAR;
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
  // 128-wide tiles where they fill one wave of the card, else 64-wide
  const long long ctas =
      (long long)(row_mode ? 1 : cdiv(n, WsL::BN)) * cdiv(m, WsL::BM) * nb;
  if (ctas >= 132)
    return ws_tile_launch<T, WsL>(A, B, out, ws, nb, m, n, k, row_mode,
                                  a_mode, b_mode, epi, st);
  return ws_tile_launch<T, WsM>(A, B, out, ws, nb, m, n, k, row_mode, a_mode,
                                b_mode, epi, st);
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
