// Device helpers shared by the port's CUDA kernels (stt_gemm.cu,
// bsr_gemm.cu, fused_chain.cu): operand views, the epilogue flush and its
// softmax row phase, and the first version's element-by-element tile
// staging and FMA micro-tile (load_tile, fma_slab, tile_product), which
// only stt_gemm.cu's in-place and narrow operand-stationary kernels use.
//
// Every kernel that adds products with fma_slab, or with simt_tile.cuh's
// fma_quads, adds each output's products in ascending k, one fmaf at a
// time into one fp32 register, so two kernels that walk k the same way
// give bit-identical sums (the BSR kernel's fma_quads walk over its
// block-rows at density 1.0 against the output-stationary tile kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_OPS = 8;
// Epilogue opcodes; the Python side's epilogue.OPCODES mirrors this list.
enum Op {
  OP_SCALE = 0, OP_BIAS = 1, OP_RELU = 2, OP_GELU = 3,
  OP_SILU = 4, OP_TANH = 5, OP_EXP = 6, OP_SOFTMAX = 7
};

struct Epi {
  int n_ops;
  int code[MAX_OPS];
  float param[MAX_OPS];
  const float* bias;  // (n,) fp32, or nullptr
};

// element (b, r, c) lives at p[b * sb + r * sr + c * sc]
template <typename T>
struct View {
  const T* p;
  long long sb, sr, sc;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One elementwise epilogue op on an fp32 value in output column `col`.
__device__ __forceinline__ float apply_op(float v, int code, float param,
                                          const float* bias, int col) {
  switch (code) {
    case OP_SCALE: return v * param;
    case OP_BIAS: return v + bias[col];
    case OP_RELU: return fmaxf(v, 0.0f);
    case OP_GELU: {  // tanh approximation, as the reference's gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case OP_SILU: return v / (1.0f + expf(-v));
    case OP_TANH: return tanhf(v);
    case OP_EXP: return expf(v);
    default: return v;
  }
}

// The shared flush (the reference's _flush_block): the epilogue on the
// fp32 value, then the cast.  Used by all three templates when the
// epilogue has no softmax.
template <typename T>
__device__ __forceinline__ void flush_store(T* out, long long idx, float v,
                                            int col, const Epi& epi) {
  for (int i = 0; i < epi.n_ops; ++i)
    v = apply_op(v, epi.code[i], epi.param[i], epi.bias, col);
  out[idx] = from_f<T>(v);
}

// The epilogue on one fp32 row `w` of length n, in place, by one warp:
// every op in order, a softmax taking its max and sum over the *full* row.
// Each lane owns the same columns in every pass.
__device__ __forceinline__ void row_epilogue(float* w, int n, const Epi& epi,
                                             int lane) {
  for (int i = 0; i < epi.n_ops; ++i) {
    if (epi.code[i] == OP_SOFTMAX) {
      float mx = -INFINITY;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, w[c]);
      mx = warp_max(mx);
      float s = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float e = expf(w[c] - mx);
        w[c] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int c = lane; c < n; c += 32) w[c] = w[c] / s;
    } else {
      for (int c = lane; c < n; c += 32)
        w[c] = apply_op(w[c], epi.code[i], epi.param[i], epi.bias, c);
    }
  }
}

// The flush's row phase, used by all three templates when the epilogue
// has a softmax: rows [row0, row1) of the fp32 pre-epilogue workspace
// `ws` (row length n) go through row_epilogue and are cast into `out`.
// One warp per row.
template <typename T>
__device__ void flush_rows(float* ws, T* out, int row0, int row1, int n,
                           const Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = row0 + warp; r < row1; r += n_warps) {
    float* w = ws + (long long)r * n;
    row_epilogue(w, n, epi, lane);
    for (int c = lane; c < n; c += 32)
      out[(long long)r * n + c] = from_f<T>(w[c]);
  }
}

// Stage rows [r0, r0+R) x cols [c0, c0+C) of one batch slice into shared
// memory as fp32, zero outside [0, rmax) x [0, cmax).  K_MAJOR stores the
// tile transposed (dst[c * R + r], for A tiles whose columns are k);
// otherwise dst[r * C + c].
template <typename T, int R, int C, bool K_MAJOR, int NT>
__device__ __forceinline__ void load_tile(float* dst, const View<T>& v,
                                          long long boff, int r0, int c0,
                                          int rmax, int cmax) {
  const bool c_fast = v.sc == 1 || v.sr != 1;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    int r, c;
    if (c_fast) {
      r = i / C;
      c = i % C;
    } else {
      c = i / R;
      r = i % R;
    }
    const int gr = r0 + r, gc = c0 + c;
    float x = 0.0f;
    if (gr < rmax && gc < cmax)
      x = to_f(v.p[boff + (long long)gr * v.sr + (long long)gc * v.sc]);
    if (K_MAJOR)
      dst[c * R + r] = x;
    else
      dst[r * C + c] = x;
  }
}

// dst += As(:, q-slab) x Bs(q-slab, :) for one BK-deep slab.  Thread
// (ty, tx) owns rows ty + i * (BM / TM) and columns tx + j * (BN / TN),
// so neighbouring threads read neighbouring shared-memory words.
template <int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void fma_slab(float (&dst)[TM][TN],
                                         const float* As, const float* Bs,
                                         int ty, int tx) {
#pragma unroll
  for (int q = 0; q < BK; ++q) {
    float af[TM], bf[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) af[i] = As[q * BM + ty + i * (BM / TM)];
#pragma unroll
    for (int j = 0; j < TN; ++j) bf[j] = Bs[q * BN + tx + j * (BN / TN)];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dst[i][j] = fmaf(af[i], bf[j], dst[i][j]);
  }
}

// The output tile at (m0, n0) of batch slice b, summed over k in steps of
// `kstep` with the sum kept in registers across the whole k loop.
// INPLACE rounds the running sum to the output dtype at the end of every
// step (the reference's o += dot(...).astype(out_dtype)); otherwise the
// caller passes kstep = k and the sum stays fp32 until the flush.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool INPLACE>
__device__ __forceinline__ void tile_product(
    const View<T>& A, const View<T>& B, int b, int m, int n, int k,
    int m0, int n0, int kstep, float (&acc)[TM][TN], float* As, float* Bs) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const long long aoff = (long long)b * A.sb, boff = (long long)b * B.sb;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < k; s += kstep) {
    const int send = min(k, s + kstep);
    float part[INPLACE ? TM : 1][INPLACE ? TN : 1];
    if constexpr (INPLACE) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
    }
    for (int kk = s; kk < send; kk += BK) {
      load_tile<T, BM, BK, true, NT>(As, A, aoff, m0, kk, m, send);
      load_tile<T, BK, BN, false, NT>(Bs, B, boff, kk, n0, send, n);
      __syncthreads();
      if constexpr (INPLACE)
        fma_slab<BM, BN, BK, TM, TN>(part, As, Bs, ty, tx);
      else
        fma_slab<BM, BN, BK, TM, TN>(acc, As, Bs, ty, tx);
      __syncthreads();
    }
    if constexpr (INPLACE) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = round_to<T>(acc[i][j] + round_to<T>(part[i][j]));
    }
  }
}


// ---- host helpers ----

Epi make_epi(int n_ops, const int* codes, const float* params,
             const void* bias) {
  Epi e;
  e.n_ops = n_ops;
  for (int i = 0; i < MAX_OPS; ++i) {
    e.code[i] = i < n_ops ? codes[i] : 0;
    e.param[i] = i < n_ops ? params[i] : 0.0f;
  }
  e.bias = static_cast<const float*>(bias);
  return e;
}

template <typename T>
View<T> make_view(const void* p, long long sb, long long sr, long long sc) {
  return View<T>{static_cast<const T*>(p), sb, sr, sc};
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

bool grid_ok(dim3 g) { return g.y <= 65535 && g.z <= 65535 && g.x >= 1; }

// Output-stationary / reduction-tree tile configurations: a square tile
// for general shapes and a skinny one for the grid-folded batched forms,
// whose m is 1 per batch slice.
struct TileL { static constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8; };
struct TileS { static constexpr int BM = 8, BN = 128, BK = 16, TM = 1, TN = 4; };

}  // namespace
