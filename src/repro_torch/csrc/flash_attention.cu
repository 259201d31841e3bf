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
// block) and loops over the 64-column kv blocks itself, with m, l and the
// accumulator in registers (fp32).
//
// What bounds it on the H100: at the serve path's prefill shapes
// (h2o-danube-1.8b, 32 q heads over 8 kv heads, D = 80, causal, L up to
// 1536) the operations, 4 * D flops for every unmasked (row, column) pair
// and head; at short prompts the bytes of q, k, v and out.
//
// bf16 (the models' prefill) runs on the tensor cores, flash_mma_kernel:
// - 4 warps, each owning a 16-row q stripe; the stripe's Q fragments are
//   loaded once (ldmatrix) and stay in registers;
// - 64-row K and V blocks stream through a 2-stage cp.async ring in
//   shared memory, the next block's copy in flight while this one is
//   multiplied; rows are padded by 16 bytes, so the 8 row addresses of
//   every ldmatrix fall in distinct banks for every head dim;
// - S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulate), then
//   * scale; the online softmax (m, l, alpha) runs on the accumulator
//   fragments, a row's statistics reduced over its 4-lane quad.  Scores
//   are kept in log2 units (s * log2 e), so each exponential is one
//   exp2f; the mask is two column bounds a row, and a kv block that every
//   row of a warp's stripe sees whole skips it;
// - P is rounded to bf16 in registers, where it becomes the A fragment of
//   O += P V (V read by ldmatrix.trans).  This is the one departure from
//   the reference, which multiplies P V in fp32: a relative error of at
//   most 2^-9 on each probability, inside the bf16 tolerance (2e-2 x
//   max|out|); l sums the fp32 probabilities, as there.  The kernel is
//   held to the plain version that rounds P the same way
//   (flash_attention_plain(round_p=True)) within BF16_ROW_TOL of each
//   row's norm;
// - heads vary fastest in the grid and q blocks run longest first (the
//   causal mask makes later q blocks longer), so the last wave is short;
// - K, V and Q rows are copied in 16-byte pieces by a fixed thread map
//   (no run-time division).
// Every head dim the configs use (16, 32, 64, 80, 96, 128) is a multiple
// of 16, the mma's k depth: no padding of D.
//
// fp32 (TF32 stays off, so fp32 results compare with the reference) keeps
// the SIMT kernel, flash_kernel: q, k, v and the probabilities staged in
// shared memory as fp32, products as FMAs on the CUDA cores; 128 threads,
// thread (tr, tc) owns rows 4*tr .. 4*tr+3 of the block and score and
// output columns tc + 8*j, a row's statistics reduced over the 8 lanes
// that share tr.
//
// Semantics kept from the TPU kernel by both: scores are (q . k) * scale
// in fp32; masked scores are NEG_INF = -1e30; p = 0 wherever s <=
// NEG_INF / 2, so a fully masked row keeps l = 0 and is written as 0; out
// = acc / l in q's dtype.  kv blocks that the causal or window mask hides
// from every row of the q block are skipped: for them the TPU kernel's
// update is an exact no-op (alpha = 1, p = 0), so skipping changes no bit,
// and a row's output does not depend on how far Lkv is padded past it.
// Each output element is summed in a fixed order with no atomics: two
// calls give the same bits.
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.  The
// bf16 path needs every base pointer and every batch, head and row stride
// 16-byte aligned (the wrapper checks; head views of (B, L, H, D) storage
// are).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
static_assert(BQ == BKV, "stage_async copies 64-row tiles of q, k and v");
constexpr int ROWS = 4;  // SIMT kernel: q rows per thread
constexpr int COLS = 8;  // SIMT kernel: threads sharing a row
constexpr float NEG_INF = -1e30f;

// element (b, h, r, d) lives at p[b * sb + h * sh + r * sr + d]
template <typename T>
struct Heads {
  const T* p;
  long long sb, sh, sr;
};

// kv blocks [lo, hi) that some row of the q block [q0, q0 + BQ) can see
__device__ __forceinline__ void kv_range(int q0, int lq, int lkv, int causal,
                                         int window, int& lo, int& hi) {
  const int q_last = min(q0 + BQ, lq) - 1;
  lo = 0;
  hi = (lkv + BKV - 1) / BKV;
  if (causal) hi = min(hi, q_last / BKV + 1);
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BKV;
}

__device__ __forceinline__ bool visible(int row, int col, int lkv,
                                        int causal, int window) {
  bool ok = col < lkv;
  if (causal) ok = ok && row >= col;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel
// ---------------------------------------------------------------------------

// rows [r0, r0 + n) of one head -> smem (n x (D + 1)) fp32; rows at or
// past `len` are zero, so no garbage reaches a product
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long sr, int r0, int n, int len) {
  for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] =
        r0 + r < len ? src[(long long)(r0 + r) * sr + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(Heads<float> q, Heads<float> k, Heads<float> v, float* out,
                 long long o_sb, long long o_sh, long long o_sr, int lq,
                 int lkv, int group, float scale, int causal, int window) {
  constexpr int DC = D / COLS;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ  x (D + 1)
  float* Ks = Qs + BQ * (D + 1);      // BKV x (D + 1)
  float* Vs = Ks + BKV * (D + 1);     // BKV x (D + 1)
  float* Ps = Vs + BKV * (D + 1);     // BQ  x (BKV + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tr = threadIdx.x / COLS, tc = threadIdx.x % COLS;
  const float* qh = q.p + b * q.sb + h * q.sh;
  const float* kh = k.p + b * k.sb + hk * k.sh;
  const float* vh = v.p + b * v.sb + hk * v.sh;

  stage<D>(Qs, qh, q.sr, q0, BQ, lq);
  int kb_lo, kb_hi;
  kv_range(q0, lq, lkv, causal, window, kb_lo, kb_hi);

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
    stage<D>(Ks, kh, k.sr, k0, BKV, lkv);
    stage<D>(Vs, vh, v.sr, k0, BKV, lkv);
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
        s[i][j] = visible(row, col, lkv, causal, window) ? s[i][j] * scale
                                                         : NEG_INF;
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

  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + tr * ROWS + i;
    if (row >= lq) continue;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(long long)row * o_sr + tc + COLS * j] =
          l[i] == 0.0f ? 0.0f : acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + 64) of one head (D bf16 each) -> smem rows of LD
// elements, 16 bytes a copy; rows at or past `len` are zero-filled.
// Thread t copies chunk t % 16 of rows t / 16 + 8 j (chunks past D / 8
// idle), so no index is divided at run time.
template <int D, int LD>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long sr, int r0, int len) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  const int c = threadIdx.x % 16, r = threadIdx.x / 16;
  if (c >= CH) return;
  const __nv_bfloat16* g = src + (long long)(r0 + r) * sr + 8 * c;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const bool in = r0 + r + 8 * j < len;
    cp_async16(dst + (r + 8 * j) * LD + 8 * c, in ? g + 8 * j * sr : src,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_mma_kernel(Heads<__nv_bfloat16> q, Heads<__nv_bfloat16> k,
                     Heads<__nv_bfloat16> v, __nv_bfloat16* out,
                     long long o_sb, long long o_sh, long long o_sr, int lq,
                     int lkv, int group, float scale, int causal,
                     int window) {
  constexpr int LD = D + 8;     // smem row: D bf16 + 16 bytes of padding
  constexpr int KS = D / 16;    // k steps of S = Q K^T
  constexpr int NT = BKV / 8;   // 8-column tiles of S
  constexpr int DT = D / 8;     // 8-column tiles of O
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm;                    // BQ x LD
  __nv_bfloat16* Ks = Qs + BQ * LD;          // 2 stages x BKV x LD
  __nv_bfloat16* Vs = Ks + 2 * BKV * LD;     // 2 stages x BKV x LD

  // heads vary fastest and q blocks run longest first, so the causal
  // mask's long blocks start in the first wave
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qh = q.p + b * q.sb + h * q.sh;
  const __nv_bfloat16* kh = k.p + b * k.sb + hk * k.sh;
  const __nv_bfloat16* vh = v.p + b * v.sb + hk * v.sh;

  int kb_lo, kb_hi;
  kv_range(q0, lq, lkv, causal, window, kb_lo, kb_hi);

  stage_async<D, LD>(Qs, qh, q.sr, q0, lq);
  if (kb_lo < kb_hi) {
    stage_async<D, LD>(Ks, kh, k.sr, kb_lo * BKV, lkv);
    stage_async<D, LD>(Vs, vh, v.sr, kb_lo * BKV, lkv);
  }
  cp_async_commit();

  // this lane's ldmatrix row: matrix lane / 8, row lane % 8 of it
  const int mi = lane / 8, mr = lane % 8;
  // this lane's accumulator rows and first column; each row sees the
  // columns [lo, hi) of the mask
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int hi0 = causal ? min(lkv, row0 + 1) : lkv;
  const int hi1 = causal ? min(lkv, row1 + 1) : lkv;
  const int lo0 = window > 0 ? row0 - window + 1 : 0;
  const int lo1 = window > 0 ? row1 - window + 1 : 0;
  // scores are kept in log2 units, s * scale * log2(e), so that every
  // exponential is one exp2f
  const float sl2 = scale * 1.4426950408889634f;

  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int st = (kb - kb_lo) & 1;
    if (kb + 1 < kb_hi) {
      // the next block's copy flies while this one is multiplied; the
      // other stage was last read before the previous iteration's barrier
      stage_async<D, LD>(Ks + (st ^ 1) * BKV * LD, kh, k.sr, (kb + 1) * BKV,
                         lkv);
      stage_async<D, LD>(Vs + (st ^ 1) * BKV * LD, vh, v.sr, (kb + 1) * BKV,
                         lkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == kb_lo) {
      // matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15): a0..a3
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (mi % 2) * 8 + mr) * LD +
                            ks * 16 + (mi / 2) * 8);
    }
    const __nv_bfloat16* Kb = Ks + st * BKV * LD;
    const __nv_bfloat16* Vb = Vs + st * BKV * LD;

    // S = Q K^T: K rows are the columns of S; matrices (n 0-7, k 0-7),
    // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, Kb + (np * 16 + (mi / 2) * 8 + mr) * LD + ks * 16 +
                        (mi % 2) * 8);
        mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }

    // online softmax on the fragments: s[t][0..1] in row0, s[t][2..3] in
    // row1, columns k0 + 8 t + c2 + {0, 1}.  A block that every row of
    // the stripe sees whole skips the mask.
    const int k0 = kb * BKV, rs = q0 + warp * 16;
    const bool whole = k0 + BKV <= lkv && (!causal || k0 + BKV - 1 <= rs) &&
                       (window <= 0 || rs + 15 - k0 < window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (whole) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= sl2;
    } else {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * t + c2 + (e & 1);
          const bool ok = e < 2 ? col >= lo0 && col < hi0
                                : col >= lo1 && col < hi1;
          s[t][e] = ok ? s[t][e] * sl2 : NEG_INF;
        }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        const float p =
            whole || s[t][e] > NEG_INF / 2 ? exp2f(s[t][e] - mn) : 0.0f;
        s[t][e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= al0;
      o[t][1] *= al0;
      o[t][2] *= al1;
      o[t][3] *= al1;
    }

    // O += P V: S tiles 2j, 2j+1 are the A fragment of kv step j (P in
    // bf16); V rows are the k of the product, read transposed: matrices
    // (kv 0-7, d 0-7), (kv 8-15, d 0-7), (kv 0-7, d 8-15), (kv 8-15, d 8-15)
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, Vb + (j * 16 + (mi % 2) * 8 + mr) * LD + dp * 16 +
                          (mi / 2) * 8);
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no copy outlives the CTA (kb_lo == kb_hi)

  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
  const float inv0 = l0 == 0.0f ? 0.0f : 1.0f / l0;
  const float inv1 = l1 == 0.0f ? 0.0f : 1.0f / l1;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = 8 * t + c2;
    if (row0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * o_sr + col) =
          __floats2bfloat162_rn(l0 == 0.0f ? 0.0f : o[t][0] * inv0,
                                l0 == 0.0f ? 0.0f : o[t][1] * inv0);
    if (row1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * o_sr + col) =
          __floats2bfloat162_rn(l1 == 0.0f ? 0.0f : o[t][2] * inv1,
                                l1 == 0.0f ? 0.0f : o[t][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_t(const void* q, const long long* qs, const void* k,
             const long long* ks, const void* v, const long long* vs,
             void* out, const long long* os, int b, int hq, int lq, int lkv,
             int group, float scale, int causal, int window,
             cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int smem =
      tc ? (BQ + 4 * BKV) * (D + 8) * (int)sizeof(__nv_bfloat16)
         : ((BQ + 2 * BKV) * (D + 1) + BQ * (BKV + 1)) * (int)sizeof(float);
  void (*kernel)(Heads<T>, Heads<T>, Heads<T>, T*, long long, long long,
                 long long, int, int, int, float, int, int);
  if constexpr (tc)
    kernel = flash_mma_kernel<D>;
  else
    kernel = flash_kernel<D>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid = tc ? dim3(hq, (lq + BQ - 1) / BQ, b)
                      : dim3((lq + BQ - 1) / BQ, hq, b);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, THREADS, smem, st>>>(
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

// C interface (loaded with ctypes).  dtype: 0 = float32 (the SIMT kernel),
// 1 = bfloat16 (the tensor-core kernel).  qs/ks/vs/os: (batch, head, row)
// strides in elements, 3 int64 each, in host memory; the last dimension
// is contiguous.  window <= 0: no window.
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
