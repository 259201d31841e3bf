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
// positions, or none (cross-attention).  The forward takes q_offset, the
// absolute position of q row 0 (a block of query rows cut from a longer
// sequence, as a model-mesh rank's query rows are): row i sits at
// q_offset + i.  The backward takes the same q_offset.
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

// kv blocks [lo, hi) that some row of the q block [q0, q0 + BQ) can see;
// the masks place q row r at position qoff + r (q_offset: a block of
// query rows cut from a longer sequence)
__device__ __forceinline__ void kv_range(int q0, int lq, int lkv, int causal,
                                         int window, int qoff, int& lo,
                                         int& hi) {
  const int q_last = qoff + min(q0 + BQ, lq) - 1;
  lo = 0;
  hi = (lkv + BKV - 1) / BKV;
  if (causal) hi = min(hi, q_last / BKV + 1);
  if (window > 0 && qoff + q0 - window + 1 > 0)
    lo = (qoff + q0 - window + 1) / BKV;
}

__device__ __forceinline__ bool visible(int row, int col, int lkv,
                                        int causal, int window) {
  bool ok = col < lkv;
  if (causal) ok = ok && row >= col;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

constexpr float LN2 = 0.6931471805599453f, LOG2E = 1.4426950408889634f;

// a row's log-sum-exp m + log l (natural units), which the backward reads
// to recompute P = exp(s - lse); a row that sees no column (l = 0) gets
// +inf, so every probability recomputed from it is 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.0f ? INFINITY : m + logf(l);
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
                 int lkv, int group, float scale, int causal, int window,
                 int qoff, float* lse) {
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
  kv_range(q0, lq, lkv, causal, window, qoff, kb_lo, kb_hi);

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
        s[i][j] = visible(qoff + row, col, lkv, causal, window)
                      ? s[i][j] * scale
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
    if (lse != nullptr && tc == 0)
      lse[((long long)b * gridDim.y + h) * lq + row] = row_lse(m[i], l[i]);
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
                     int window, int qoff, float* lse) {
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
  kv_range(q0, lq, lkv, causal, window, qoff, kb_lo, kb_hi);

  stage_async<D, LD>(Qs, qh, q.sr, q0, lq);
  if (kb_lo < kb_hi) {
    stage_async<D, LD>(Ks, kh, k.sr, kb_lo * BKV, lkv);
    stage_async<D, LD>(Vs, vh, v.sr, kb_lo * BKV, lkv);
  }
  cp_async_commit();

  // this lane's ldmatrix row: matrix lane / 8, row lane % 8 of it
  const int mi = lane / 8, mr = lane % 8;
  // this lane's accumulator rows and first column; each row sees the
  // columns [lo, hi) of the mask, which places row r at position qoff + r
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int pos0 = qoff + row0, pos1 = qoff + row1;
  const int hi0 = causal ? min(lkv, pos0 + 1) : lkv;
  const int hi1 = causal ? min(lkv, pos1 + 1) : lkv;
  const int lo0 = window > 0 ? pos0 - window + 1 : 0;
  const int lo1 = window > 0 ? pos1 - window + 1 : 0;
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
    const int k0 = kb * BKV, rs = qoff + q0 + warp * 16;
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
  if (lse != nullptr && lane % 4 == 0) {
    // m is in log2 units: the natural log-sum-exp is m ln 2 + log l
    float* lh = lse + ((long long)b * gridDim.x + h) * lq;
    if (row0 < lq) lh[row0] = row_lse(m0 * LN2, l0);
    if (row1 < lq) lh[row1] = row_lse(m1 * LN2, l1);
  }
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
             int group, float scale, int causal, int window, int qoff,
             float* lse, cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int smem =
      tc ? (BQ + 4 * BKV) * (D + 8) * (int)sizeof(__nv_bfloat16)
         : ((BQ + 2 * BKV) * (D + 1) + BQ * (BKV + 1)) * (int)sizeof(float);
  void (*kernel)(Heads<T>, Heads<T>, Heads<T>, T*, long long, long long,
                 long long, int, int, int, float, int, int, int, float*);
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
      causal, window, qoff, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               void* out, const long long* os, int b, int hq, int lq,
               int lkv, int group, float scale, int causal, int window,
               int qoff, float* lse, cudaStream_t st) {
#define FLASH_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch_t<T, DD>(q, qs, k, ks, v, vs, out, os, b, hq, lq, lkv,   \
                           group, scale, causal, window, qoff, lse, st);
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

// ---------------------------------------------------------------------------
// the backward (no TPU counterpart: the reference differentiates its XLA
// attention, and the port's forward on the card is this kernel)
// ---------------------------------------------------------------------------
//
// FA2's backward, recomputing P from q, k and the forward's log-sum-exp
// instead of storing it:
//   P = exp(s - lse) on visible pairs (0 elsewhere), s = (q . k) * scale
//   delta_i = sum_d dO[i, d] O[i, d]                 (flash_bwd_prep_kernel)
//   dV = P^T dO,  dS = P o (dO V^T - delta),  dK = dS^T Q * scale
//                                                     (flash_bwd_dkdv_kernel)
//   dQ = dS K * scale                                 (flash_bwd_dq_kernel)
// with the forward's masks (visible, kv_range).  The two main kernels each
// own their outputs: a dK/dV CTA owns one (b, kv head, 64-row kv block)
// and loops over the q heads of its GQA group and the q blocks that see
// the block, so the group's sum needs no atomics; a dQ CTA owns one (b, q
// head, 64-row q block) and loops over kv_range.  Every output is summed in
// a fixed order: two calls give the same bits.  S and dS are recomputed
// by both (seven 64 x 64 x D products a visible block pair against the
// forward's two).
//
// What bounds it on the H100: the operations (2.5 x the forward's, counted
// as 10 D flops a visible pair and q head).  bf16 runs on the tensor cores
// (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel, below), rounding P
// and dS to bf16 as the A operands of their products, as the forward
// rounds P.  fp32 (TF32 off) runs SIMT (flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel): 256 threads, thread (tr, tc) owns rows 4 tr .. 4
// tr + 3 of its block and the columns tc + 16 j, tiles in shared memory as
// fp32 rows padded by one word (the 16 column addresses of a load fall in
// distinct banks), every product 2 FMAs a shared-memory load.

constexpr int BWD_THREADS = 256;
constexpr int BR = 4;   // rows a thread
constexpr int BC = 16;  // threads sharing a row; columns tc + BC * j
constexpr int BJ = BQ / BC;
static_assert(BQ == BKV && BQ == BR * (BWD_THREADS / BC),
              "the backward's thread map covers 64 x 64 tiles");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q blocks [lo, hi) holding a row that sees some column of the kv block
// [k0, k0 + BKV), q row r at position qoff + r: the mirror of kv_range
__device__ __forceinline__ void q_range(int k0, int lq, int causal,
                                        int window, int qoff, int& lo,
                                        int& hi) {
  lo = causal ? max(0, k0 - qoff) / BQ : 0;
  hi = (lq + BQ - 1) / BQ;
  if (window > 0) {
    // the last row that can see the block's last column
    const int last = k0 + BKV + window - 2 - qoff;
    hi = last < 0 ? 0 : min(hi, last / BQ + 1);
  }
}

// rows [r0, r0 + 64) of one head -> smem (64 x (D + 1)); rows at or past
// `len` are zero
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long sr, int r0, int len) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += BWD_THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        r0 + r < len ? src[(long long)(r0 + r) * sr + c] : 0.0f;
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] O[b, h, i, d], one thread a row
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_prep_kernel(Heads<T> o, Heads<T> g, float* delta, int hq,
                          int lq, int d, long long rows) {
  const long long row = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int i = (int)(row % lq);
  const long long bh = row / lq;
  const int h = (int)(bh % hq), b = (int)(bh / hq);
  const T* op = o.p + b * o.sb + h * o.sh + i * o.sr;
  const T* gp = g.p + b * g.sb + h * g.sh + i * g.sr;
  float s = 0.0f;
  for (int c = 0; c < d; ++c) s = fmaf(widen(gp[c]), widen(op[c]), s);
  delta[row] = s;
}

// fp32: dK, dV, SIMT
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv_kernel(Heads<float> q, Heads<float> k, Heads<float> v,
                          Heads<float> g, const float* lse,
                          const float* delta, float* dk, float* dv, int hq,
                          int lq, int lkv, int group, float scale,
                          int causal, int window, int qoff) {
  constexpr int LD = D + 1, LP = BQ + 1, DC = D / BC;
  extern __shared__ float smem[];
  float* Ks = smem;             // BKV x LD
  float* Vs = Ks + BKV * LD;    // BKV x LD
  float* Qs = Vs + BKV * LD;    // BQ x LD
  float* Gs = Qs + BQ * LD;     // BQ x LD: dO
  float* Ps = Gs + BQ * LD;     // BKV x LP: P^T (kv row, q column)
  float* Ss = Ps + BKV * LP;    // BKV x LP: dS^T
  float* Ls = Ss + BKV * LP;    // BQ: the q block's lse
  float* Ds = Ls + BQ;          // BQ: its delta

  // kv blocks in ascending order: under the causal mask the first ones
  // are seen by the most q blocks, so the long CTAs start first
  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BKV;
  const int tr = threadIdx.x / BC, tc = threadIdx.x % BC;
  stage_rows<D>(Ks, k.p + b * k.sb + hk * k.sh, k.sr, k0, lkv);
  stage_rows<D>(Vs, v.p + b * v.sb + hk * v.sh, v.sr, k0, lkv);

  float ak[BR][DC], av[BR][DC];
#pragma unroll
  for (int i = 0; i < BR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) ak[i][j] = av[i][j] = 0.0f;

  int qb_lo, qb_hi;
  q_range(k0, lq, causal, window, qoff, qb_lo, qb_hi);
  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const float* qh = q.p + b * q.sb + h * q.sh;
    const float* gh = g.p + b * g.sb + h * g.sh;
    const float* lh = lse + ((long long)b * hq + h) * lq;
    const float* dh = delta + ((long long)b * hq + h) * lq;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous block's reads of Qs..Ds are done
      stage_rows<D>(Qs, qh, q.sr, q0, lq);
      stage_rows<D>(Gs, gh, g.sr, q0, lq);
      for (int i = threadIdx.x; i < BQ; i += BWD_THREADS) {
        const bool in = q0 + i < lq;
        Ls[i] = in ? lh[q0 + i] : 0.0f;
        Ds[i] = in ? dh[q0 + i] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: kv rows tr * BR + i, q columns
      // tc + BC * j
      float s[BR][BJ], dp[BR][BJ];
#pragma unroll
      for (int i = 0; i < BR; ++i)
#pragma unroll
        for (int j = 0; j < BJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kr[BR], vr[BR], qc[BJ], gc[BJ];
#pragma unroll
        for (int i = 0; i < BR; ++i) {
          kr[i] = Ks[(tr * BR + i) * LD + c];
          vr[i] = Vs[(tr * BR + i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < BJ; ++j) {
          qc[j] = Qs[(tc + BC * j) * LD + c];
          gc[j] = Gs[(tc + BC * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < BR; ++i)
#pragma unroll
          for (int j = 0; j < BJ; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < BR; ++i)
#pragma unroll
        for (int j = 0; j < BJ; ++j) {
          const int qi = tc + BC * j, row = q0 + qi;
          const int col = k0 + tr * BR + i;
          const float p =
              row < lq && visible(qoff + row, col, lkv, causal, window)
                  ? expf(s[i][j] * scale - Ls[qi])
                  : 0.0f;
          Ps[(tr * BR + i) * LP + qi] = p;
          Ss[(tr * BR + i) * LP + qi] = p * (dp[i][j] - Ds[qi]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: kv rows tr * BR + i, columns tc + BC j
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pr[BR], sr[BR];
#pragma unroll
        for (int i = 0; i < BR; ++i) {
          pr[i] = Ps[(tr * BR + i) * LP + c];
          sr[i] = Ss[(tr * BR + i) * LP + c];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float gv = Gs[c * LD + tc + BC * j];
          const float qv = Qs[c * LD + tc + BC * j];
#pragma unroll
          for (int i = 0; i < BR; ++i) {
            av[i][j] = fmaf(pr[i], gv, av[i][j]);
            ak[i][j] = fmaf(sr[i], qv, ak[i][j]);
          }
        }
      }
    }
  }

  const long long base = ((long long)b * gridDim.y + hk) * lkv;
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int r = k0 + tr * BR + i;
    if (r >= lkv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[(base + r) * D + tc + BC * j] = ak[i][j] * scale;
      dv[(base + r) * D + tc + BC * j] = av[i][j];
    }
  }
}

// fp32: dQ, SIMT
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(Heads<float> q, Heads<float> k, Heads<float> v,
                        Heads<float> g, const float* lse, const float* delta,
                        float* dq, int lq, int lkv, int group, float scale,
                        int causal, int window, int qoff) {
  constexpr int LD = D + 1, LP = BKV + 1, DC = D / BC;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* Gs = Qs + BQ * LD;     // BQ x LD: dO
  float* Ks = Gs + BQ * LD;     // BKV x LD
  float* Vs = Ks + BKV * LD;    // BKV x LD
  float* Ss = Vs + BKV * LD;    // BQ x LP: dS
  float* Ls = Ss + BQ * LP;     // BQ
  float* Ds = Ls + BQ;          // BQ

  // q blocks longest first, as in the forward
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tr = threadIdx.x / BC, tc = threadIdx.x % BC;
  const long long bh = (long long)b * gridDim.y + h;
  stage_rows<D>(Qs, q.p + b * q.sb + h * q.sh, q.sr, q0, lq);
  stage_rows<D>(Gs, g.p + b * g.sb + h * g.sh, g.sr, q0, lq);
  for (int i = threadIdx.x; i < BQ; i += BWD_THREADS) {
    const bool in = q0 + i < lq;
    Ls[i] = in ? lse[bh * lq + q0 + i] : 0.0f;
    Ds[i] = in ? delta[bh * lq + q0 + i] : 0.0f;
  }
  const float* kh = k.p + b * k.sb + hk * k.sh;
  const float* vh = v.p + b * v.sb + hk * v.sh;

  float aq[BR][DC];
#pragma unroll
  for (int i = 0; i < BR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) aq[i][j] = 0.0f;

  int kb_lo, kb_hi;
  kv_range(q0, lq, lkv, causal, window, qoff, kb_lo, kb_hi);
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();  // the previous block's reads of Ks, Vs, Ss are done
    stage_rows<D>(Ks, kh, k.sr, k0, lkv);
    stage_rows<D>(Vs, vh, v.sr, k0, lkv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: q rows tr * BR + i, kv columns tc + BC j
    float s[BR][BJ], dp[BR][BJ];
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int j = 0; j < BJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qr[BR], gr[BR], kc[BJ], vc[BJ];
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        qr[i] = Qs[(tr * BR + i) * LD + c];
        gr[i] = Gs[(tr * BR + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        kc[j] = Ks[(tc + BC * j) * LD + c];
        vc[j] = Vs[(tc + BC * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < BR; ++i)
#pragma unroll
        for (int j = 0; j < BJ; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        const int qi = tr * BR + i, row = q0 + qi;
        const int col = k0 + tc + BC * j;
        const float p =
            row < lq && visible(qoff + row, col, lkv, causal, window)
                ? expf(s[i][j] * scale - Ls[qi])
                : 0.0f;
        Ss[qi * LP + tc + BC * j] = p * (dp[i][j] - Ds[qi]);
      }
    __syncthreads();

    // dQ += dS K: q rows tr * BR + i, columns tc + BC * j
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float sr[BR];
#pragma unroll
      for (int i = 0; i < BR; ++i) sr[i] = Ss[(tr * BR + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Ks[c * LD + tc + BC * j];
#pragma unroll
        for (int i = 0; i < BR; ++i) aq[i][j] = fmaf(sr[i], kv, aq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int row = q0 + tr * BR + i;
    if (row >= lq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[(bh * lq + row) * D + tc + BC * j] = aq[i][j] * scale;
  }
}

// bf16: the backward on the tensor cores.  The layout of the forward's
// flash_mma_kernel (4 warps of 16 rows, mma.sync m16n8k16 with fp32
// sums, operands read from shared memory by ldmatrix, tiles streamed by
// cp.async into a 2-stage ring); a warp's S (or S^T) and dP tiles are
// taken 32 columns at a time, so that P and dS go straight from the
// accumulator fragments into the A operand of the next product, rounded
// to bf16 there (as the forward rounds P; fp32 sums throughout).  Scores
// and the log-sum-exp are in log2 units, every exponential one exp2f.

// dK, dV: a CTA per (kv head, 64-row kv block, b); warp w owns kv rows
// 16 w .. 16 w + 15 and sums over the group's q heads and the q blocks
// that see its block, Q and dO blocks streamed, K and V resident
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_mma_kernel(Heads<__nv_bfloat16> q, Heads<__nv_bfloat16> k,
                              Heads<__nv_bfloat16> v, Heads<__nv_bfloat16> g,
                              const float* lse, const float* delta,
                              __nv_bfloat16* dk, __nv_bfloat16* dv, int hq,
                              int lq, int lkv, int group, float scale,
                              int causal, int window, int qoff) {
  constexpr int LD = D + 8, KS = D / 16, DT = D / 8;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Ks = sm;                   // BKV x LD
  __nv_bfloat16* Vs = Ks + BKV * LD;        // BKV x LD
  __nv_bfloat16* Qs = Vs + BKV * LD;        // 2 stages x BQ x LD
  __nv_bfloat16* Gs = Qs + 2 * BQ * LD;     // 2 stages x BQ x LD: dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // 2 x BQ: lse
  float* Ds = Ls + 2 * BQ;                  // 2 x BQ: delta

  const int hk = blockIdx.x, kb = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8, gq = lane / 4, c2 = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  stage_async<D, LD>(Ks, k.p + b * k.sb + hk * k.sh, k.sr, k0, lkv);
  stage_async<D, LD>(Vs, v.p + b * v.sb + hk * v.sh, v.sr, k0, lkv);

  int qb_lo, qb_hi;
  q_range(k0, lq, causal, window, qoff, qb_lo, qb_hi);
  const int nq = max(0, qb_hi - qb_lo), n_it = group * nq;
  // iteration it: q head hk * group + it / nq, q block qb_lo + it % nq
  auto load = [&](int it, int st) {
    const int h = hk * group + it / nq, q0 = (qb_lo + it % nq) * BQ;
    stage_async<D, LD>(Qs + st * BQ * LD, q.p + b * q.sb + h * q.sh, q.sr,
                       q0, lq);
    stage_async<D, LD>(Gs + st * BQ * LD, g.p + b * g.sb + h * g.sh, g.sr,
                       q0, lq);
    const long long row = ((long long)b * hq + h) * lq + q0;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < lq;
      Ls[st * BQ + i] = in ? lse[row + i] * LOG2E : 0.0f;
      Ds[st * BQ + i] = in ? delta[row + i] : 0.0f;
    }
  };
  if (n_it > 0) load(0, 0);
  cp_async_commit();

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[t][e] = adv[t][e] = 0.0f;
  const int kw = k0 + warp * 16;              // the warp's first kv row
  const int kr0 = kw + gq, kr1 = kr0 + 8;     // this lane's kv rows

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qb_lo + it % nq) * BQ;
    const __nv_bfloat16* Qb = Qs + st * BQ * LD;
    const __nv_bfloat16* Gb = Gs + st * BQ * LD;
    const float* Lb = Ls + st * BQ;
    const float* Db = Ds + st * BQ;
    // every (q, kv) pair of the warp's tile visible: no mask (q rows at
    // positions qoff + q0 ..)
    const int qp = qoff + q0;
    const bool whole = q0 + BQ <= lq && kw + 16 <= lkv &&
                       (!causal || qp >= kw + 15) &&
                       (window <= 0 || qp + BQ - 1 - kw < window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S^T = K Q^T and dP^T = V dO^T over q columns half * 32 + [0, 32)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, Ks + (warp * 16 + (mi % 2) * 8 + mr) * LD + ks * 16 +
                        (mi / 2) * 8);
        ldsm_x4(va, Vs + (warp * 16 + (mi % 2) * 8 + mr) * LD + ks * 16 +
                        (mi / 2) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int qr = half * 32 + np * 16;
          uint32_t bq[4], bg[4];
          ldsm_x4(bq, Qb + (qr + (mi / 2) * 8 + mr) * LD + ks * 16 +
                          (mi % 2) * 8);
          ldsm_x4(bg, Gb + (qr + (mi / 2) * 8 + mr) * LD + ks * 16 +
                          (mi % 2) * 8);
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * np], va, bg[0], bg[1]);
          mma_bf16(dp[2 * np + 1], va, bg[2], bg[3]);
        }
      }
      // P^T and dS^T = P^T o (dP^T - delta) on the fragments: element e
      // of tile t is kv row e < 2 ? kr0 : kr1, q column 8 t + c2 + (e & 1)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = half * 32 + 8 * t + c2 + (e & 1);
          const bool ok =
              whole || (q0 + qi < lq && visible(qp + qi, e < 2 ? kr0 : kr1,
                                                lkv, causal, window));
          const float p = ok ? exp2f(s[t][e] * sl2 - Lb[qi]) : 0.0f;
          s[t][e] = p;
          dp[t][e] = p * (dp[t][e] - Db[qi]);
        }
      // dV += P^T dO and dK += dS^T Q over these 32 q rows: S^T tiles
      // 2j, 2j+1 are the A fragment of k step j (as P in the forward);
      // dO and Q rows are the k of the product, read transposed
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint32_t sa[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                                pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                                pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                                pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
        const int qr = half * 32 + j * 16;
#pragma unroll
        for (int dq2 = 0; dq2 < DT / 2; ++dq2) {
          uint32_t bg[4], bq[4];
          ldsm_x4_t(bg, Gb + (qr + (mi % 2) * 8 + mr) * LD + dq2 * 16 +
                            (mi / 2) * 8);
          ldsm_x4_t(bq, Qb + (qr + (mi % 2) * 8 + mr) * LD + dq2 * 16 +
                            (mi / 2) * 8);
          mma_bf16(adv[2 * dq2], pa, bg[0], bg[1]);
          mma_bf16(adv[2 * dq2 + 1], pa, bg[2], bg[3]);
          mma_bf16(adk[2 * dq2], sa, bq[0], bq[1]);
          mma_bf16(adk[2 * dq2 + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no copy outlives the CTA (n_it == 0)

  const long long base = ((long long)b * gridDim.x + hk) * lkv;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = 8 * t + c2;
    if (kr0 < lkv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + kr0) * D + col) =
          __floats2bfloat162_rn(adk[t][0] * scale, adk[t][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + kr0) * D + col) =
          __floats2bfloat162_rn(adv[t][0], adv[t][1]);
    }
    if (kr1 < lkv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + kr1) * D + col) =
          __floats2bfloat162_rn(adk[t][2] * scale, adk[t][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + kr1) * D + col) =
          __floats2bfloat162_rn(adv[t][2], adv[t][3]);
    }
  }
}

// dQ: a CTA per (q head, 64-row q block, b), q blocks longest first;
// warp w owns q rows 16 w .. 16 w + 15 (Q and dO fragments resident), K
// and V blocks of kv_range streamed
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_mma_kernel(Heads<__nv_bfloat16> q, Heads<__nv_bfloat16> k,
                            Heads<__nv_bfloat16> v, Heads<__nv_bfloat16> g,
                            const float* lse, const float* delta,
                            __nv_bfloat16* dq, int lq, int lkv, int group,
                            float scale, int causal, int window, int qoff) {
  constexpr int LD = D + 8, KS = D / 16, DT = D / 8;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm;                   // BQ x LD
  __nv_bfloat16* Gs = Qs + BQ * LD;         // BQ x LD: dO
  __nv_bfloat16* Ks = Gs + BQ * LD;         // 2 stages x BKV x LD
  __nv_bfloat16* Vs = Ks + 2 * BKV * LD;    // 2 stages x BKV x LD

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8, gq = lane / 4, c2 = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  const __nv_bfloat16* kh = k.p + b * k.sb + hk * k.sh;
  const __nv_bfloat16* vh = v.p + b * v.sb + hk * v.sh;

  int kb_lo, kb_hi;
  kv_range(q0, lq, lkv, causal, window, qoff, kb_lo, kb_hi);
  stage_async<D, LD>(Qs, q.p + b * q.sb + h * q.sh, q.sr, q0, lq);
  stage_async<D, LD>(Gs, g.p + b * g.sb + h * g.sh, g.sr, q0, lq);
  if (kb_lo < kb_hi) {
    stage_async<D, LD>(Ks, kh, k.sr, kb_lo * BKV, lkv);
    stage_async<D, LD>(Vs, vh, v.sr, kb_lo * BKV, lkv);
  }
  cp_async_commit();

  const int rw = q0 + warp * 16;               // the warp's first q row
  const int row0 = rw + gq, row1 = row0 + 8;   // this lane's q rows
  const long long bh = (long long)b * gridDim.x + h;
  const float l0 = row0 < lq ? lse[bh * lq + row0] * LOG2E : 0.0f;
  const float l1 = row1 < lq ? lse[bh * lq + row1] * LOG2E : 0.0f;
  const float d0 = row0 < lq ? delta[bh * lq + row0] : 0.0f;
  const float d1 = row1 < lq ? delta[bh * lq + row1] : 0.0f;

  uint32_t qa[KS][4], ga[KS][4];
  float aq[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[t][e] = 0.0f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int st = (kb - kb_lo) & 1;
    if (kb + 1 < kb_hi) {
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
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldsm_x4(qa[ks], Qs + (warp * 16 + (mi % 2) * 8 + mr) * LD + ks * 16 +
                            (mi / 2) * 8);
        ldsm_x4(ga[ks], Gs + (warp * 16 + (mi % 2) * 8 + mr) * LD + ks * 16 +
                            (mi / 2) * 8);
      }
    }
    const __nv_bfloat16* Kb = Ks + st * BKV * LD;
    const __nv_bfloat16* Vb = Vs + st * BKV * LD;
    const int k0 = kb * BKV;
    const bool whole = k0 + BKV <= lkv && rw + 16 <= lq &&
                       (!causal || k0 + BKV - 1 <= qoff + rw) &&
                       (window <= 0 || qoff + rw + 15 - k0 < window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S = Q K^T and dP = dO V^T over kv columns half * 32 + [0, 32)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int kr = half * 32 + np * 16;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, Kb + (kr + (mi / 2) * 8 + mr) * LD + ks * 16 +
                          (mi % 2) * 8);
          ldsm_x4(bv, Vb + (kr + (mi / 2) * 8 + mr) * LD + ks * 16 +
                          (mi % 2) * 8);
          mma_bf16(s[2 * np], qa[ks], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa[ks], bk[2], bk[3]);
          mma_bf16(dp[2 * np], ga[ks], bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], ga[ks], bv[2], bv[3]);
        }
      // dS = P o (dP - delta): element e of tile t is q row e < 2 ? row0 :
      // row1, kv column k0 + half * 32 + 8 t + c2 + (e & 1)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + half * 32 + 8 * t + c2 + (e & 1);
          const bool ok = whole || (row < lq && visible(qoff + row, col,
                                                        lkv, causal, window));
          const float p =
              ok ? exp2f(s[t][e] * sl2 - (e < 2 ? l0 : l1)) : 0.0f;
          s[t][e] = p * (dp[t][e] - (e < 2 ? d0 : d1));
        }
      // dQ += dS K over these 32 kv rows: K rows are the k of the
      // product, read transposed
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t sa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const int kr = half * 32 + j * 16;
#pragma unroll
        for (int dq2 = 0; dq2 < DT / 2; ++dq2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, Kb + (kr + (mi % 2) * 8 + mr) * LD + dq2 * 16 +
                            (mi / 2) * 8);
          mma_bf16(aq[2 * dq2], sa, bk[0], bk[1]);
          mma_bf16(aq[2 * dq2 + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no copy outlives the CTA (kb_lo == kb_hi)

#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = 8 * t + c2;
    if (row0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(dq + (bh * lq + row0) * D + col) =
          __floats2bfloat162_rn(aq[t][0] * scale, aq[t][1] * scale);
    if (row1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(dq + (bh * lq + row1) * D + col) =
          __floats2bfloat162_rn(aq[t][2] * scale, aq[t][3] * scale);
  }
}

template <typename T, int D>
int backward_t(const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               const void* out, const long long* os, const void* dout,
               const long long* gs, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int hq, int lq, int lkv, int group,
               float scale, int causal, int window, int qoff,
               cudaStream_t st) {
  static bool attr_set = false;  // one opt-in per instantiation
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = D + 1, LP = BQ + 1, LDH = D + 8;
  constexpr int smem_kv =
      tc ? 6 * BQ * LDH * (int)sizeof(__nv_bfloat16) +
               4 * BQ * (int)sizeof(float)
         : (4 * BQ * LD + 2 * BKV * LP + 2 * BQ) * (int)sizeof(float);
  constexpr int smem_q =
      tc ? 6 * BQ * LDH * (int)sizeof(__nv_bfloat16)
         : (4 * BQ * LD + BQ * LP + 2 * BQ) * (int)sizeof(float);
  void (*kv_kernel)(Heads<T>, Heads<T>, Heads<T>, Heads<T>, const float*,
                    const float*, T*, T*, int, int, int, int, float, int,
                    int, int);
  void (*q_kernel)(Heads<T>, Heads<T>, Heads<T>, Heads<T>, const float*,
                   const float*, T*, int, int, int, float, int, int, int);
  if constexpr (tc) {
    kv_kernel = flash_bwd_dkdv_mma_kernel<D>;
    q_kernel = flash_bwd_dq_mma_kernel<D>;
  } else {
    kv_kernel = flash_bwd_dkdv_kernel<D>;
    q_kernel = flash_bwd_dq_kernel<D>;
  }
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int hkv = hq / group;
  const int nkb = (lkv + BKV - 1) / BKV, nqb = (lq + BQ - 1) / BQ;
  if (hq > 65535 || b > 65535 || nkb > 65535 || nqb > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const Heads<T> qh{static_cast<const T*>(q), qs[0], qs[1], qs[2]};
  const Heads<T> kh{static_cast<const T*>(k), ks[0], ks[1], ks[2]};
  const Heads<T> vh{static_cast<const T*>(v), vs[0], vs[1], vs[2]};
  const Heads<T> oh{static_cast<const T*>(out), os[0], os[1], os[2]};
  const Heads<T> gh{static_cast<const T*>(dout), gs[0], gs[1], gs[2]};
  const long long rows = (long long)b * hq * lq;
  if (rows > 0) {
    flash_bwd_prep_kernel<T>
        <<<(unsigned)((rows + BWD_THREADS - 1) / BWD_THREADS), BWD_THREADS,
           0, st>>>(oh, gh, delta, hq, lq, D, rows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // the tensor-core kernels put heads fastest in the grid, as the
  // forward does; the SIMT ones blocks
  if (lkv > 0) {
    const dim3 grid = tc ? dim3(hkv, nkb, b) : dim3(nkb, hkv, b);
    kv_kernel<<<grid, tc ? THREADS : BWD_THREADS, smem_kv, st>>>(
        qh, kh, vh, gh, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        hq, lq, lkv, group, scale, causal, window, qoff);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (lq > 0) {
    const dim3 grid = tc ? dim3(hq, nqb, b) : dim3(nqb, hq, b);
    q_kernel<<<grid, tc ? THREADS : BWD_THREADS, smem_q, st>>>(
        qh, kh, vh, gh, lse, delta, static_cast<T*>(dq), lq, lkv, group,
        scale, causal, window, qoff);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int backward_d(int d, const void* q, const long long* qs, const void* k,
               const long long* ks, const void* v, const long long* vs,
               const void* out, const long long* os, const void* dout,
               const long long* gs, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int hq, int lq, int lkv, int group,
               float scale, int causal, int window, int qoff,
               cudaStream_t st) {
#define FLASH_BWD_CASE(DD)                                                  \
  case DD:                                                                  \
    return backward_t<T, DD>(q, qs, k, ks, v, vs, out, os, dout, gs, lse,   \
                             delta, dq, dk, dv, b, hq, lq, lkv, group, scale, \
                             causal, window, qoff, st);
  switch (d) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32 (the SIMT kernel),
// 1 = bfloat16 (the tensor-core kernel).  qs/ks/vs/os: (batch, head, row)
// strides in elements, 3 int64 each, in host memory; the last dimension
// is contiguous.  window <= 0: no window.  q_offset >= 0: the absolute
// position of q row 0 in the masks.  lse: nullptr, or (B, Hq, Lq)
// fp32, contiguous, for each row's log-sum-exp (training saves it for the
// backward).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const long long* qs, const void* k,
    const long long* ks, const void* v, const long long* vs, void* out,
    const long long* os, int b, int hq, int lq, int lkv, int d, int group,
    float scale, int causal, int window, int q_offset, void* lse,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b == 0 || hq == 0 || lq == 0) return 0;
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(d, q, qs, k, ks, v, vs, out, os, b, hq, lq, lkv,
                             group, scale, causal, window, q_offset, l, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, qs, k, ks, v, vs, out, os, b, hq,
                                     lq, lkv, group, scale, causal, window,
                                     q_offset, l, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dtype as above; q, k, v, out and dout strided as above
// (dout's strides in gs); lse (B, Hq, Lq) fp32 from the forward; delta
// (B, Hq, Lq) fp32 scratch; dq (B, Hq, Lq, D), dk and dv (B, Hkv, Lkv, D),
// contiguous, in q's dtype; q_offset >= 0 as the forward's.
extern "C" int flash_attention_backward_launch(
    int dtype, const void* q, const long long* qs, const void* k,
    const long long* ks, const void* v, const long long* vs, const void* out,
    const long long* os, const void* dout, const long long* gs,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int hq,
    int lq, int lkv, int d, int group, float scale, int causal, int window,
    int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || hq == 0 || (lq == 0 && lkv == 0)) return 0;
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return backward_d<float>(d, q, qs, k, ks, v, vs, out, os, dout, gs, l, dl,
                             dq, dk, dv, b, hq, lq, lkv, group, scale, causal,
                             window, q_offset, st);
  if (dtype == 1)
    return backward_d<__nv_bfloat16>(d, q, qs, k, ks, v, vs, out, os, dout,
                                     gs, l, dl, dq, dk, dv, b, hq, lq, lkv,
                                     group, scale, causal, window, q_offset,
                                     st);
  return (int)cudaErrorInvalidValue;
}
