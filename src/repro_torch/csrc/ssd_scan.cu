// Mamba-2 chunked SSD scan for Hopper (sm_90a); replaces the reference's
// kernels/ssd_scan.py:ssd_scan (_ssd_kernel).
//
// For each (batch, head) sequence, chunk by chunk of Q steps, with the
// inclusive cumulative log decay lc of the chunk:
//
//   y[i]  = sum_{j<=i} e^{lc_i - lc_j} (C_i . B_j) xdt[j]       (intra)
//         + e^{lc_i} C_i . h                                     (inter)
//   h    <- e^{lc_{Q-1}} h + sum_j e^{lc_{Q-1} - lc_j} B_j xdt[j]^T
//
// xdt (B, L, H, P), da (B, L, H), b/c (B, L, G, N) and y (B, L, H, P) are
// contiguous fp32; the final state h goes out as (B, H, N, P) fp32.  Head
// h reads B and C at its group h / (H / G) in the address: the repeat
// from groups to heads that the TPU wrapper materialises is never made.
//
// The TPU kernel runs the chunks as the sequential "arbitrary" grid axis
// and carries the (N, P) state in VMEM scratch, dropping it at the end.
// CTAs have no order here, so one CTA owns one (batch, head, 16-column
// slice of P) and loops over the chunks itself.  The state's P columns
// are independent (y[:, p] depends on xdt[:, p] and h[:, p] only), so the
// split over P is exact; it gives 4 CTAs a head at P = 64, enough to fill
// the 132 SMs at batch-1 prefill (64 heads for zamba2-1.2b, 32 for
// mamba2-370m).  The (N, 16) state slice stays in shared memory for the
// whole loop and reaches global memory once, at the end, as the second
// output the models' prefill needs for the decode cache.
//
// Per chunk, 256 threads as a 16 x 16 grid (ty, tx):
//   1. stage B, C (Q x N, rows padded to N + 1 floats so column reads of
//      16 rows hit distinct banks) and the 16 xdt columns (Q x 16); warp
//      0 scans the Q log decays by shuffles into lc, e^{lc} and the end
//      weights e^{lc_{Q-1} - lc};
//   2. G = mask(C B^T) * e^{lc_i - lc_j}, a 4 x 4 register tile of rows
//      ty + 16a and columns tx + 16b per thread; tiles wholly above the
//      diagonal (b > a) are never computed, and the exponential is taken
//      only where j <= i (masked before the exp: above the diagonal
//      lc_i - lc_j is positive and would overflow);
//   3. y = G xdt + e^{lc} (C h): rows ty + 16a, column tx;
//   4. h <- e^{lc_{Q-1}} h + B^T (w * xdt): rows n = ty + 16a, column tx.
// Rows past a ragged chunk (Q < 64) are staged as zeros and never stored.
//
// What bounds it on the H100: the operations.  A chunk needs C B^T's
// lower triangle once per group, Q(Q+1)/2 N multiply-adds, and per head
// Q(Q+1)/2 P for its masked product with xdt and 2 Q N P for the
// inter-chunk term and the state update: 2.0 GFLOP over zamba2-1.2b's
// longest serve prefill (L = 1536, 64 heads, one group,
// Q = N = P = 64), 0.030 ms at 67 TFLOP/s fp32, against 53 MB of inputs
// and outputs (0.016 ms at 3.35 TB/s).  The design keeps every
// intermediate and the state on chip and skips the upper triangle; it
// multiplies on the CUDA cores in fp32 (the models feed fp32), does not
// overlap the next chunk's loads with this chunk's products, and
// recomputes C B^T in every CTA: once per head and P slice, 256 times a
// chunk at zamba2-1.2b (64 heads x 4 slices) where the bound counts it
// once.  Later work.
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;      // thread grid: THREADS = 16 x 16
constexpr int QMAX = 64;    // longest chunk
constexpr int NMAX = 128;   // widest state
constexpr int PC = 16;      // state columns per CTA (= TX)
constexpr int GS = QMAX + 1;  // row stride of the G tile

__host__ __device__ constexpr int smem_floats(int n) {
  return 2 * QMAX * (n + 1) + QMAX * GS + QMAX * PC + n * PC + 3 * QMAX;
}

__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ da,
               const float* __restrict__ bm, const float* __restrict__ cm,
               float* __restrict__ y, float* __restrict__ state, int L,
               int H, int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  const int NS = N + 1;               // padded row stride of B and C
  float* Bs = smem;                   // QMAX x NS
  float* Cs = Bs + QMAX * NS;         // QMAX x NS
  float* Gs = Cs + QMAX * NS;         // QMAX x GS
  float* Xs = Gs + QMAX * GS;         // QMAX x PC
  float* Ss = Xs + QMAX * PC;         // N x PC, the state slice
  float* lc = Ss + N * PC;            // QMAX: inclusive log decay
  float* el = lc + QMAX;              // QMAX: e^{lc_i}
  float* wl = el + QMAX;              // QMAX: e^{lc_{Q-1} - lc_j}

  const int p0 = blockIdx.x * PC, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int pc = min(PC, P - p0);     // live columns of this slice

  const long long xrow = (long long)H * P;   // step stride of xdt and y
  const long long brow = (long long)G * N;   // step stride of b and c
  const float* xb = xdt + (long long)b * L * xrow + (long long)h * P + p0;
  float* yb = y + (long long)b * L * xrow + (long long)h * P + p0;
  const float* bb = bm + (long long)b * L * brow + (long long)g * N;
  const float* cb = cm + (long long)b * L * brow + (long long)g * N;
  const float* db = da + (long long)b * L * H + h;

  for (int i = tid; i < N * PC; i += THREADS) Ss[i] = 0.0f;

  const int nc = L / Q;
  for (int ci = 0; ci < nc; ++ci) {
    const long long t0 = (long long)ci * Q;

    // -- 1. stage the chunk ---------------------------------------------
    for (int idx = tid; idx < QMAX * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const bool ok = r < Q;
      const long long at = (t0 + r) * brow + n;
      Bs[r * NS + n] = ok ? bb[at] : 0.0f;
      Cs[r * NS + n] = ok ? cb[at] : 0.0f;
    }
    for (int idx = tid; idx < QMAX * PC; idx += THREADS) {
      const int r = idx / PC, p = idx % PC;
      Xs[idx] = (r < Q && p < pc) ? xb[(t0 + r) * xrow + p] : 0.0f;
    }
    if (tid < 32) {
      // lane l holds steps 2l and 2l + 1; steps past Q add nothing
      const int r0 = 2 * tid, r1 = r0 + 1;
      const float d0 = r0 < Q ? db[(t0 + r0) * H] : 0.0f;
      const float d1 = r1 < Q ? db[(t0 + r1) * H] : 0.0f;
      float incl = d0 + d1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      const float l0 = excl + d0, l1 = incl;
      const float last =
          __shfl_sync(0xffffffffu, ((Q - 1) & 1) ? l1 : l0, (Q - 1) >> 1);
      lc[r0] = l0;
      lc[r1] = l1;
      el[r0] = expf(l0);
      el[r1] = expf(l1);
      wl[r0] = r0 < Q ? expf(last - l0) : 0.0f;
      wl[r1] = r1 < Q ? expf(last - l1) : 0.0f;
    }
    __syncthreads();

    // -- 2. G = mask(C B^T) * e^{lc_i - lc_j} -----------------------------
    {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c <= a; ++c) s[a][c] = fmaf(cv[a], bv[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          float gv = 0.0f;
          if (c <= a && j <= i && i < Q) gv = s[a][c] * expf(lc[i] - lc[j]);
          Gs[i * GS + j] = gv;
        }
    }
    __syncthreads();

    // -- 3. y = G xdt + e^{lc} (C h) --------------------------------------
    {
      float intra[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float inter[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int jmax = min(Q, ty + 16 * 3 + 1);   // row i sees j <= i
      for (int j = 0; j < jmax; ++j) {
        const float xv = Xs[j * PC + tx];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          intra[a] = fmaf(Gs[(ty + 16 * a) * GS + j], xv, intra[a]);
      }
      for (int n = 0; n < N; ++n) {
        const float sv = Ss[n * PC + tx];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          inter[a] = fmaf(Cs[(ty + 16 * a) * NS + n], sv, inter[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i < Q && tx < pc)
          yb[(t0 + i) * xrow + tx] = intra[a] + el[i] * inter[a];
      }
    }
    __syncthreads();  // every read of the state for this chunk is done

    // -- 4. h <- e^{lc_{Q-1}} h + B^T (w * xdt) ---------------------------
    {
      float acc[NMAX / 16];
#pragma unroll
      for (int a = 0; a < NMAX / 16; ++a) acc[a] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float xw = Xs[j * PC + tx] * wl[j];
#pragma unroll
        for (int a = 0; a < NMAX / 16; ++a) {
          const int n = ty + 16 * a;
          if (n < N) acc[a] = fmaf(Bs[j * NS + n], xw, acc[a]);
        }
      }
      const float dec = el[Q - 1];
#pragma unroll
      for (int a = 0; a < NMAX / 16; ++a) {
        const int n = ty + 16 * a;
        if (n < N) Ss[n * PC + tx] = dec * Ss[n * PC + tx] + acc[a];
      }
    }
    __syncthreads();  // the next chunk overwrites B, C, xdt
  }
  __syncthreads();  // L == 0: the zeroed state is complete

  float* sb = state + ((long long)b * H + h) * N * P + p0;
  for (int idx = tid; idx < N * PC; idx += THREADS) {
    const int n = idx / PC, p = idx % PC;
    if (p < pc) sb[(long long)n * P + p] = Ss[idx];
  }
}

}  // namespace

// C interface (loaded with ctypes).  xdt (batch, L, H, P), da (batch, L,
// H), b/c (batch, L, G, N), y (batch, L, H, P) and state (batch, H, N, P),
// all contiguous fp32.  Takes 1 <= Q <= 64 with L % Q == 0, 1 <= N <= 128
// and H % G == 0; anything else returns cudaErrorInvalidValue unlaunched.
// Nothing is launched for an empty batch or head set.
extern "C" int ssd_scan_launch(const void* xdt, const void* da,
                               const void* b, const void* c, void* y,
                               void* state, int batch, int L, int H, int G,
                               int N, int P, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || H == 0 || P == 0) return 0;
  if (Q < 1 || Q > QMAX || L % Q || N < 1 || N > NMAX || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  static bool attr_set = false;  // one opt-in, at the widest state
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(NMAX) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((P + PC - 1) / PC, H, batch);
  ssd_kernel<<<grid, THREADS, smem_floats(N) * sizeof(float), st>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(da),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(state), L, H, G, N, P, Q);
  return (int)cudaGetLastError();
}
