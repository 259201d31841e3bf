// Blockwise online-softmax attention for Hopper (sm_90a); replaces the
// reference's kernels/flash_attention.py:flash_attention (_attn_kernel).
//
//   out[b, h, i, :] = softmax_j(mask(q[b, h, i] . k[b, h/group, j] * scale))
//                     @ v[b, h/group, :, :]
//
// q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) and out (B, Hq, Lq, D) are
// strided views whose last dimension is contiguous; Hq = group * Hkv
// (GQA: q head h reads kv head h / group).  The mask is causal (i >= j)
// and/or a sliding window (i - j < window) on absolute row and column
// positions, or none (cross-attention).
//
// The TPU kernel runs the kv blocks as the sequential innermost grid axis
// with the running max m, denominator l and accumulator in VMEM scratch.
// CTAs have no order here, so one CTA owns one (b, q head, 64-row q
// block) and loops over the 64-column kv blocks itself, staging q, k, v
// and the probabilities in shared memory (fp32) and keeping m, l and the
// accumulator in registers (fp32).  128 threads: thread (tr, tc) owns
// rows 4*tr .. 4*tr+3 of the block, score columns tc + 8*j and output
// columns tc + 8*j, so a row's statistics live in the 8 lanes that share
// tr and reduce by warp shuffles.  Rows of shared tiles are padded by one
// float, so the k reads of the score loop hit 8 distinct banks.
//
// Semantics kept from the TPU kernel: scores are (q . k) * scale in fp32;
// masked scores are NEG_INF = -1e30; p = 0 wherever s <= NEG_INF / 2, so
// a fully masked row keeps l = 0 and is written as 0; out = acc / l in
// q's dtype.  kv blocks that the causal or window mask hides from every
// row of the q block are skipped: for them the TPU kernel's update is an
// exact no-op (alpha = 1, p = 0), so skipping changes no bit.
//
// What bounds it on the H100: at the serve path's prefill shapes
// (h2o-danube-1.8b, 32 q heads over 8 kv heads, D = 80, causal, L up to
// 1536) the operations: 4 * D flops for every unmasked (row, column) pair
// and head, against bytes of q, k, v and out read or written once; at
// short prompts the bytes.  The design does nothing about the bound yet
// beyond skipping masked blocks and keeping the L x L scores out of
// device memory: it multiplies on the CUDA cores in fp32 (wgmma, TMA and
// bf16 tensor cores are later work).  D is a template parameter (16, 32,
// 64, 80, 96, 128): every multiple of 8 up to 128 that the configs use.
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr int ROWS = 4;  // q rows per thread
constexpr int COLS = 8;  // threads sharing a row
constexpr float NEG_INF = -1e30f;

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

// element (b, h, r, d) lives at p[b * sb + h * sh + r * sr + d]
template <typename T>
struct Heads {
  const T* p;
  long long sb, sh, sr;
};

// rows [r0, r0 + n) of one head -> smem (n x (D + 1)) fp32; rows at or
// past `len` are zero, so no garbage reaches a product
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sr,
                                      int r0, int n, int len) {
  for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] =
        r0 + r < len ? to_f(src[(long long)(r0 + r) * sr + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(Heads<T> q, Heads<T> k, Heads<T> v, T* out, long long o_sb,
                 long long o_sh, long long o_sr, int lq, int lkv, int group,
                 float scale, int causal, int window) {
  constexpr int DC = D / COLS;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ  x (D + 1)
  float* Ks = Qs + BQ * (D + 1);      // BKV x (D + 1)
  float* Vs = Ks + BKV * (D + 1);     // BKV x (D + 1)
  float* Ps = Vs + BKV * (D + 1);     // BQ  x (BKV + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tr = threadIdx.x / COLS, tc = threadIdx.x % COLS;
  const T* qh = q.p + b * q.sb + h * q.sh;
  const T* kh = k.p + b * k.sb + hk * k.sh;
  const T* vh = v.p + b * v.sb + hk * v.sh;

  stage<T, D>(Qs, qh, q.sr, q0, BQ, lq);

  // kv blocks some row of this q block can see
  const int q_last = min(q0 + BQ, lq) - 1;
  int kb_lo = 0, kb_hi = (lkv + BKV - 1) / BKV;
  if (causal) kb_hi = min(kb_hi, q_last / BKV + 1);
  if (window > 0 && q0 - window + 1 > 0) kb_lo = (q0 - window + 1) / BKV;

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();  // the previous block's Ks/Vs/Ps reads are done
    stage<T, D>(Ks, kh, k.sr, k0, BKV, lkv);
    stage<T, D>(Vs, vh, v.sr, k0, BKV, lkv);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(tr * ROWS + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = Ks[(tc + COLS * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + tr * ROWS + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = k0 + tc + COLS * j;
        bool ok = col < lkv;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < COLS; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = s[i][j] > NEG_INF / 2 ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(tr * ROWS + i) * (BKV + 1) + tc + COLS * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 1; o < COLS; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * (D + 1) + tc + COLS * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Ps[(tr * ROWS + i) * (BKV + 1) + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + tr * ROWS + i;
    if (row >= lq) continue;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(long long)row * o_sr + tc + COLS * j] =
          from_f<T>(l[i] == 0.0f ? 0.0f : acc[i][j] * inv);
  }
}

template <int D>
constexpr int smem_bytes() {
  return ((BQ + 2 * BKV) * (D + 1) + BQ * (BKV + 1)) * (int)sizeof(float);
}

template <typename T, int D>
int launch_t(const void* q, const long long* qs, const void* k,
             const long long* ks, const void* v, const long long* vs,
             void* out, const long long* os, int b, int hq, int lq, int lkv,
             int group, float scale, int causal, int window,
             cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr int smem = smem_bytes<D>();
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((lq + BQ - 1) / BQ, hq, b);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  flash_kernel<T, D><<<grid, THREADS, smem, st>>>(
      Heads<T>{static_cast<const T*>(q), qs[0], qs[1], qs[2]},
      Heads<T>{static_cast<const T*>(k), ks[0], ks[1], ks[2]},
      Heads<T>{static_cast<const T*>(v), vs[0], vs[1], vs[2]},
      static_cast<T*>(out), os[0], os[1], os[2], lq, lkv, group, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               void* out, const long long* os, int b, int hq, int lq,
               int lkv, int group, float scale, int causal, int window,
               cudaStream_t st) {
#define FLASH_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch_t<T, DD>(q, qs, k, ks, v, vs, out, os, b, hq, lq, lkv,   \
                           group, scale, causal, window, st);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// qs/ks/vs/os: (batch, head, row) strides in elements, 3 int64 each, in
// host memory; the last dimension is contiguous.  window <= 0: no window.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const long long* qs, const void* k,
    const long long* ks, const void* v, const long long* vs, void* out,
    const long long* os, int b, int hq, int lq, int lkv, int d, int group,
    float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0 || lq == 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(d, q, qs, k, ks, v, vs, out, os, b, hq, lq, lkv,
                             group, scale, causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, qs, k, ks, v, vs, out, os, b, hq,
                                     lq, lkv, group, scale, causal, window,
                                     st);
  return (int)cudaErrorInvalidValue;
}
