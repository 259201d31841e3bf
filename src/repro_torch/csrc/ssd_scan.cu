// Mamba-2 chunked SSD scan for Hopper (sm_90a); replaces the reference's
// kernels/ssd_scan.py:ssd_scan (_ssd_kernel;
// src/repro/kernels/ssd_scan.py:61).
//
// For each (batch, head) sequence, cut into chunks of Q steps, with the
// log decays da_j = dt_j a and their inclusive sum lc within the chunk:
//
//   y[i]  = sum_{j<=i} e^{lc_i - lc_j} (C_i . B_j) dt_j x[j]      (intra)
//         + e^{lc_i} C_i . h_in                                  (inter)
//   h_out = e^{lc_{Q-1}} h_in + sum_j e^{lc_{Q-1} - lc_j} dt_j B_j x[j]^T
//
// The TPU kernel runs the chunks as its sequential grid axis and carries
// the (N, P) state from one to the next in VMEM scratch.  Here only the
// carry is sequential, so one call is three launches of the chunk-parallel
// form (the decomposition ref.ssd_chunked_ref writes in PyTorch):
//
//   1. ssd_chunk_state_kernel, one CTA a (chunk, head, batch):
//      chunk_state = sum_j B_j (w_j x[j])^T with w_j = dt_j e^{lc_{Q-1} -
//      lc_j}, and the chunk's decay e^{lc_{Q-1}}, to scratch;
//   2. ssd_state_pass_kernel, 4 state elements a thread of a (batch,
//      head): walks the chunks in order, h_in[c] = h, h = decay_c h +
//      chunk_state[c], writing h_in over chunk_state in place, and the
//      final h as the second output.  The sum order is fixed, so the
//      result is deterministic;
//   3. ssd_chunk_scan_kernel, one CTA a (chunk, group, batch, block of
//      heads): the lower triangle of C B^T once, kept in registers, then
//      per head G = mask * e^{lc_i - lc_j} * CB * dt_j (masked before the
//      exponential: above the diagonal lc_i - lc_j is positive and
//      overflows) and y = G x + e^{lc} (C h_in), in x's layout.
//
// x (B, L, H, P), dt (B, L, H) and b/c (B, L, G, N) are fp32 read where
// they lie, through element strides (the innermost stride of x, b and c
// is 1; b and c share theirs), a is (H,).  Head h reads B and C at its
// group h / (H / G): the repeat from groups to heads is never made.  y is
// contiguous (B, L, H, P), the final state (B, H, N, P), and the scratch
// holds the chunk states (B, nc, H, N, P) and then the decays (B, nc, H).
//
// What bounds it on the H100: the operations.  Per chunk, C B^T's lower
// triangle once per group, Q(Q+1)/2 N multiply-adds, and per head
// Q(Q+1)/2 P for its masked product with x and 2 Q N P for the
// inter-chunk term and the chunk state: 2.0 GFLOP at zamba2-1.2b's
// longest serve prefill (L = 1536, 64 heads, one group, Q = N = P = 64),
// 0.030 ms at 67 TFLOP/s fp32, against 53 MB of inputs and outputs
// (0.016 ms at 3.35 TB/s).  The design: every product runs from register
// tiles of 4 x 4 per thread fed by 16-byte shared-memory reads (8 FMAs a
// read); C B^T is formed once per (batch, chunk, group, block of heads)
// and reused for the up to 4 heads of the block; the chunk
// scan loads the next head's x, h_in and dt into registers behind the
// current head's products; the state pass keeps 8 chunks' loads in flight
// and its 25 MB of scratch stays within L2.  The arithmetic stays fp32 on
// the CUDA cores (the tolerance, 1e-4 of max|.|, rules out TF32).
//
// The backward (ssd_scan_backward_launch) replaces no TPU kernel: the
// reference differentiates its XLA ssd_chunked_ref with jax.grad.  The
// port's forward on the card is the kernels above, so its gradient is a
// kernel too.  Per (batch, head) and chunk, with xd_j = dt_j x[j], the
// forward's entering state H = h_in (its scratch keeps it), the gradient
// D = dL/dh_out leaving the chunk, W_ij = [j <= i] e^{lc_i - lc_j} C_i.B_j
// and e^{L} = e^{lc_{Q-1}}, the chunk form differentiates to
//
//   S_c      = sum_i e^{lc_i} C_i dy_i^T                  (N x P)
//   D_{c-1}  = e^{L_c} D_c + S_c,  D_{nc-1} = dh_final or 0   (reverse carry)
//   dxd_j    = sum_{i>=j} W_ij dy_i + e^{L - lc_j} D^T B_j
//   dW_ij    = dy_i . xd_j,  dCB_ij = [j <= i] e^{lc_i - lc_j} dW_ij
//   dC_i     = e^{lc_i} H dy_i + sum_j dCB_ij B_j
//   dB_j     = e^{L - lc_j} D xd_j + sum_i dCB_ij C_i
//   dlc_i    = sum_j T_ij - sum_k T_ki + C_i . (e^{lc_i} H dy_i)
//              - u_i  (+ e^{L} <H, D> + sum_j u_j at i = Q-1)
//              with T = dW o W and u_j = B_j . (e^{L - lc_j} D xd_j)
//   dda_k    = sum_{i>=k} dlc_i    (lc is the inclusive sum of da = dt a)
//   dx_j = dt_j dxd_j,  ddt_j = x_j . dxd_j + a dda_j,  da = sum dt_j dda_j
//
// B and C belong to the group, so dB and dC of a group are sums over its
// heads, and the dCB terms sum before their product:  dC = sum_h e^{lc}
// H dy + (sum_h dCB) B, dB = sum_h e^{L - lc} D xd + (sum_h dCB)^T C.  And
// u_j = e^{L - lc_j} dt_j x_j . (B D)_j reads the product dxd needs.
//
// What bounds the backward: the operations.  Per chunk and head two
// Q x Q triangles with P (dW, W^T dy), Q(Q+1)/2 2P multiply-adds, and
// four Q N P products (S_c, H dy, D xd, B D); per chunk and group three
// triangles with N (C B^T, dCB B, dCB^T C): 19.6 GFLOP at mamba2-370m's
// training shape (x (4, 2048, 32, 64), B/C (4, 2048, 1, 128)), 0.292 ms
// at 67 TFLOP/s fp32, and 21.7 GFLOP at zamba2-1.2b's (x (4, 2048, 64,
// 64), N = 64), 0.324 ms; the bytes (inputs, h_in, outputs) take
// 0.11-0.16 ms at 3.35 TB/s.  The design:
//   * one CTA a (chunk, group x block of up to 4 heads, batch) for both
//     chunk kernels: ssd_bwd_dstate_kernel stages C once and scales each
//     head's dy by e^{lc} (loading the next head's dy behind the current
//     product); ssd_bwd_chunk_kernel forms C B^T's lower triangle once, in
//     registers, for the block's heads;
//   * the chunk kernel walks the block's heads three times, each pass
//     staging only what its products read: (A) W, dy and x: dW (summed
//     over the block as dCB, in registers, then parked in shared memory)
//     and W^T dy; (B) B, D and x: B D (to dx, x . dxd and u) and the
//     block's sum of e^{L - lc} D xd, then + dCB^T C: the block's dB; (C)
//     C, h_in and dy: the head's H dy (for dlc), the block's sum of e^{lc}
//     H dy, then + dCB B: the block's dC.  dB and dC are summed over the
//     block's heads on chip and written once a block: straight to db/dc
//     where one block holds a group's heads, else as (B, L, G x blocks,
//     N) partials that ssd_bwd_sum_kernel adds in order;
//   * every product runs from 4 x 4 register tiles fed by 16-byte
//     shared-memory reads (8 FMAs a read; 5 in the triangles with P): the
//     chunk rows in the forward's slot order (row i at (i % 16) * 4 + i /
//     16, so a thread's rows ty + 16 r are one float4), or, where a
//     product sums over the state's rows (B D), 16-byte reads along the
//     sum of both operands; row strides of 68 and 64 NR + 4 floats keep
//     the reads free of bank conflicts;
//   * the triangles skip their zero blocks of 16 rows: 10 of 16 of a
//     square's multiply-adds;
//   * 256 threads, 128 registers (no spill) and 110 KB of shared memory a
//     CTA at N = 128 (76 KB at N = 64): two CTAs, 16 warps, an SM; one
//     CTA's loads run behind the other's products;
//   * fp32 on the CUDA cores as the forward (the tolerance rules out
//     TF32); no atomics: every sum runs in a fixed order, so two calls
//     give the same bits.
// The kernels read the inputs more than once (dy and x in two passes
// each, D in two, pass A's dx again in pass B): their loads, not their
// products, take most of the chunk kernel's time (PERF.md).
// Four launches: 4. ssd_bwd_dstate_kernel, S_c into the backward's
// scratch; 5. ssd_bwd_state_pass_kernel, the reverse carry (the
// forward's pass run from the last chunk), writing each chunk's D over
// its S_c; 6. ssd_bwd_chunk_kernel: dx, ddt, each head's chunk term of da
// and the block's dB and dC; 7. ssd_bwd_sum_kernel: dB and dC over a
// group's blocks and da over batch and chunks.
//
// Launch contract: runs on the given stream, allocates nothing (the
// wrapper allocates the scratch), sets its shared-memory opt-in once, and
// the entry point returns the first launch error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // chunk kernels: 16 x 16 threads
constexpr int TX = 16;
constexpr int QMAX = 64;            // longest chunk
constexpr int NMAX = 128;           // widest state
constexpr int PT = 64;              // state columns a tile: 16 x float4
constexpr int QS = QMAX + 4;        // row stride of the chunk-slot tiles
constexpr int PASS_THREADS = 128;   // state pass
constexpr int PASS_DEPTH = 8;       // chunks in flight in the state pass

struct SsdArgs {
  const float *x, *dt, *a, *b, *c;
  float *y, *state, *cs, *decay;
  long long xb, xt, xh;      // x strides: batch, step, head
  long long db, dtt, dh;     // dt strides
  long long bb, bt, bg;      // b and c strides: batch, step, group
  int L, H, G, N, P, Q, nc, hblk;
  bool xvec, bvec;           // 16-byte loads of x / of b and c
  // the backward: dy (B, L, H, P) and dh_final (B, H, N, P, or null)
  // contiguous; cs holds the forward's h_in, ds the chunks' S_c and then
  // their D; dbp/dcp (B, L, G x blocks, N) the blocks' dB and dC and dap
  // (B, nc, H) the chunks' da terms
  const float *dy, *dhf;
  float *ds, *dx, *ddt, *da, *db_, *dc_, *dbp, *dcp, *dap;
  bool yvec;                 // 16-byte loads of dy
};

// Shared floats of each kernel, by the state's 64-row groups NR.
__host__ __device__ constexpr int state_smem(int nr) {
  return QMAX * 64 * nr + QMAX * PT + 3 * QMAX;
}
__host__ __device__ constexpr int scan_smem(int nr) {
  return 64 * nr * QS + QMAX * QS + QMAX * PT + 64 * nr * PT + 3 * QMAX;
}

// Chunk row i (i < 64) lives at slot (i % 16) * 4 + i / 16, so the rows
// ty, ty + 16, ty + 32, ty + 48 of thread row ty are one float4.
__device__ __forceinline__ int slot(int i) { return (i % 16) * 4 + i / 16; }

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// row[k .. k+3], columns at or past lim read as 0; one 16-byte load where
// the row allows it (vec: the base and the strides are 16-byte aligned,
// k is a multiple of 4).
__device__ __forceinline__ float4 ld4(const float* row, int k, int lim,
                                      bool vec) {
  if (vec && k + 4 <= lim)
    return __ldg(reinterpret_cast<const float4*>(row + k));
  float4 v = zero4();
  if (k < lim) v.x = row[k];
  if (k + 1 < lim) v.y = row[k + 1];
  if (k + 2 < lim) v.z = row[k + 2];
  if (k + 3 < lim) v.w = row[k + 3];
  return v;
}

// row[k .. k+3] = v, columns at or past lim dropped.
__device__ __forceinline__ void st4(float* row, int k, int lim, bool vec,
                                    const float (&v)[4]) {
  if (vec && k + 4 <= lim) {
    *reinterpret_cast<float4*>(row + k) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (k + u < lim) row[k + u] = v[u];
}

// acc[r][k] += a[r] * b[k]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a,
                                       const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
}

// The dt of steps 2l and 2l + 1 of the chunk for lane l of a warp (0 past
// q).
__device__ __forceinline__ void load_dt(const float* dtp, long long stride,
                                        int q, float& d0, float& d1) {
  const int r0 = 2 * (threadIdx.x & 31), r1 = r0 + 1;
  d0 = r0 < q ? dtp[r0 * stride] : 0.0f;
  d1 = r1 < q ? dtp[r1 * stride] : 0.0f;
}

// Warp-wide inclusive scan of the log decays da = dt a: lane l holds
// steps 2l and 2l + 1 (l0, l1).  Returns lc_{q-1}.
__device__ __forceinline__ float scan_decay(float d0, float d1, float a,
                                            int q, float& l0, float& l1) {
  const int lane = threadIdx.x & 31;
  const float e0 = d0 * a, e1 = d1 * a;
  float incl = e0 + e1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  l0 = excl + e0;
  l1 = incl;
  return __shfl_sync(0xffffffffu, ((q - 1) & 1) ? l1 : l0, (q - 1) >> 1);
}

// -- 1. chunk states ------------------------------------------------------
// Thread (ty, tx) owns state rows 64 g + 4 ty + r (g < NR) and columns
// 4 tx + k of each 64-column tile: per step j, NR + 1 float4 reads for
// 16 NR FMAs.
template <int NR>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_state_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int NS = 64 * NR;            // padded row width of Bs
  constexpr int XV = QMAX * PT / 4 / THREADS;
  float* Bs = reinterpret_cast<float*>(smem4);   // QMAX x NS: B_j rows
  float* Xs = Bs + QMAX * NS;                    // QMAX x PT: w_j x[j]
  float* w = Xs + QMAX * PT;                     // QMAX: dt_j e^{...}
  const float4* Bs4 = reinterpret_cast<const float4*>(Bs);
  float4* Xs4 = reinterpret_cast<float4*>(Xs);

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (s.H / s.G);
  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const long long t0 = (long long)ci * Q;
  const float* xb = s.x + b * s.xb + t0 * s.xt + h * s.xh;
  const float* bb = s.b + b * s.bb + t0 * s.bt + g * s.bg;
  float* csb = s.cs + (((long long)b * s.nc + ci) * s.H + h) * N * P;
  const bool cvec = P % 4 == 0;

  if (tid < 32) {
    float d0, d1, l0, l1;
    load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, d0, d1);
    const float last = scan_decay(d0, d1, s.a[h], Q, l0, l1);
    w[2 * tid] = d0 * expf(last - l0);       // 0 past Q: d is 0
    w[2 * tid + 1] = d1 * expf(last - l1);
    if (tid == 0)
      s.decay[((long long)b * s.nc + ci) * s.H + h] = expf(last);
  }
  for (int idx = tid; idx < QMAX * NS / 4; idx += THREADS) {
    const int r = idx / (NS / 4), k = idx % (NS / 4) * 4;
    reinterpret_cast<float4*>(Bs)[idx] =
        r < Q ? ld4(bb + r * s.bt, k, N, s.bvec) : zero4();
  }

  for (int pt = 0; pt < P; pt += PT) {
    float4 xr[XV];
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int idx = tid + k * THREADS, r = idx / (PT / 4);
      xr[k] = r < Q ? ld4(xb + r * s.xt, pt + idx % (PT / 4) * 4, P, s.xvec)
                    : zero4();
    }
    __syncthreads();  // w and Bs staged; the last tile's reads of Xs done
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int idx = tid + k * THREADS;
      const float wv = w[idx / (PT / 4)];
      Xs4[idx] = make_float4(xr[k].x * wv, xr[k].y * wv, xr[k].z * wv,
                             xr[k].w * wv);
    }
    __syncthreads();

    float acc[NR][4][4];
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[q][r][k] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float4 xv = Xs4[j * (PT / 4) + tx];
#pragma unroll
      for (int q = 0; q < NR; ++q)
        outer4(acc[q], Bs4[(j * NS + 64 * q) / 4 + ty], xv);
    }
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 64 * q + 4 * ty + r;
        if (n < N)
          st4(csb + (long long)n * P, pt + 4 * tx, P, cvec, acc[q][r]);
      }
  }
}

// -- 2. the carry over chunks ---------------------------------------------
__device__ __forceinline__ void ld_run(const float* p, int live, bool vec,
                                       float (&v)[4]) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < live ? p[u] : 0.0f;
}

__global__ void __launch_bounds__(PASS_THREADS)
    ssd_state_pass_kernel(const SsdArgs s) {
  const long long np = (long long)s.N * s.P;
  const long long e =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  if (e >= np) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int live = (int)(np - e < 4 ? np - e : 4);
  const bool vec = np % 4 == 0;          // every run of 4 is one float4
  const long long step = (long long)s.H * np;     // chunk stride
  float* cs = s.cs + ((long long)b * s.nc * s.H + h) * np + e;
  const float* dec = s.decay + (long long)b * s.nc * s.H + h;
  float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < s.nc; c0 += PASS_DEPTH) {
    float v[PASS_DEPTH][4], d[PASS_DEPTH];
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 + k < s.nc) {
        ld_run(cs + (c0 + k) * step, live, vec, v[k]);
        d[k] = dec[(long long)(c0 + k) * s.H];
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 + k < s.nc) {
        st4(cs + (c0 + k) * step, 0, live, vec, hv);   // h_in of the chunk
#pragma unroll
        for (int u = 0; u < 4; ++u) hv[u] = fmaf(d[k], hv[u], v[k][u]);
      }
  }
  st4(s.state + ((long long)b * s.H + h) * np + e, 0, live, vec, hv);
}

// -- 3. the chunk outputs -------------------------------------------------
// One (head, 64-column tile) of the CTA's block: its x rows, its h_in
// rows and its dt, loaded into registers ahead of use.
template <int NR>
struct Item {
  float4 x[QMAX * PT / 4 / THREADS];
  float4 h[64 * NR * PT / 4 / THREADS];
  float d0, d1, a;
};

// Thread (ty, tx) owns output rows ty + 16 r and columns 4 tx + k; the C B^T
// tile it keeps holds rows ty + 16 r and columns tx + 16 u, u <= r (the
// tiles with u > r lie wholly above the diagonal).
template <int NR>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunk_scan_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int XV = QMAX * PT / 4 / THREADS;
  constexpr int HV = 64 * NR * PT / 4 / THREADS;
  float* Ct = reinterpret_cast<float*>(smem4);   // 64 NR x QS: C^T by slot
  float* Bt = Ct + 64 * NR * QS;                 // 64 NR x QS, until CB
  float* Gt = Bt;                                // QMAX x QS: G^T by slot
  float* Xs = Gt + QMAX * QS;                    // QMAX x PT: x rows
  float* Hs = Xs + QMAX * PT;                    // 64 NR x PT: h_in rows
  float* lc = Hs + 64 * NR * PT;                 // QMAX each
  float* el = lc + QMAX;
  float* dts = el + QMAX;
  const float4* Ct4 = reinterpret_cast<const float4*>(Ct);
  const float4* Bt4 = reinterpret_cast<const float4*>(Bt);
  float4* Gt4 = reinterpret_cast<float4*>(Gt);
  float4* Xs4 = reinterpret_cast<float4*>(Xs);
  float4* Hs4 = reinterpret_cast<float4*>(Hs);

  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int R = s.H / s.G, nhb = (R + s.hblk - 1) / s.hblk;
  const int ci = blockIdx.x, g = blockIdx.y;
  const int b = blockIdx.z / nhb, hb = blockIdx.z % nhb;
  const int h0 = g * R + hb * s.hblk, nh = min(s.hblk, R - hb * s.hblk);
  const int npt = (P + PT - 1) / PT, items = nh * npt;
  const long long t0 = (long long)ci * Q;
  const bool cvec = P % 4 == 0;

  auto load_item = [&](int it, Item<NR>& m) {
    const int h = h0 + it / npt, pt = it % npt * PT;
    const float* xb = s.x + b * s.xb + t0 * s.xt + h * s.xh;
    const float* hin =
        s.cs + (((long long)b * s.nc + ci) * s.H + h) * N * P;
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int idx = tid + k * THREADS, r = idx / (PT / 4);
      m.x[k] = r < Q ? ld4(xb + r * s.xt, pt + idx % (PT / 4) * 4, P,
                           s.xvec)
                     : zero4();
    }
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int idx = tid + k * THREADS, n = idx / (PT / 4);
      m.h[k] = n < N ? ld4(hin + (long long)n * P, pt + idx % (PT / 4) * 4,
                           P, cvec)
                     : zero4();
    }
    if (tid < 32) {
      load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, m.d0, m.d1);
      m.a = s.a[h];
    }
  };
  auto put_item = [&](const Item<NR>& m) {
#pragma unroll
    for (int k = 0; k < XV; ++k) Xs4[tid + k * THREADS] = m.x[k];
#pragma unroll
    for (int k = 0; k < HV; ++k) Hs4[tid + k * THREADS] = m.h[k];
    if (tid < 32) {
      float l0, l1;
      scan_decay(m.d0, m.d1, m.a, Q, l0, l1);
      lc[2 * tid] = l0;
      lc[2 * tid + 1] = l1;
      el[2 * tid] = expf(l0);
      el[2 * tid + 1] = expf(l1);
      dts[2 * tid] = m.d0;
      dts[2 * tid + 1] = m.d1;
    }
  };

  // stage C^T and B^T of the group's chunk by slot (rows past Q are 0)
  const float* cb0 = s.c + b * s.bb + t0 * s.bt + g * s.bg;
  const float* bb0 = s.b + b * s.bb + t0 * s.bt + g * s.bg;
  for (int idx = tid; idx < QMAX * ((N + 3) / 4); idx += THREADS) {
    const int i = idx % QMAX, k = idx / QMAX * 4, sl = slot(i);
    const float4 cv = i < Q ? ld4(cb0 + i * s.bt, k, N, s.bvec) : zero4();
    const float4 bv = i < Q ? ld4(bb0 + i * s.bt, k, N, s.bvec) : zero4();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < N) {
        Ct[(k + u) * QS + sl] = lane4(cv, u);
        Bt[(k + u) * QS + sl] = lane4(bv, u);
      }
  }
  Item<NR> m;
  load_item(0, m);
  __syncthreads();

  // C B^T, lower triangle, once for every head of the block
  float cb[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) cb[r][u] = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float4 c4 = Ct4[n * (QS / 4) + ty], b4 = Bt4[n * (QS / 4) + tx];
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u <= r; ++u) cb[r][u] = fmaf(cv[r], bv[u], cb[r][u]);
  }
  __syncthreads();  // Bt's space goes to the heads' tiles
  put_item(m);

  for (int it = 0; it < items; ++it) {
    const int h = h0 + it / npt, pt = it % npt * PT;
    __syncthreads();  // this item's x, h_in and decays are staged
    if (it + 1 < items) load_item(it + 1, m);

    // G^T = (mask * e^{lc_i - lc_j} * CB * dt_j)^T, rows j, columns by slot
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 16 * u;
      float gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        gv[r] = (u <= r && j <= i && i < Q)
                    ? cb[r][u] * expf(lc[i] - lc[j]) * dts[j]
                    : 0.0f;
      }
      Gt4[j * (QS / 4) + ty] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
    for (int n = 0; n < N; ++n)
      outer4(acc, Ct4[n * (QS / 4) + ty], Hs4[n * (PT / 4) + tx]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = el[ty + 16 * r];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] *= e;
    }
    const int jmax = min(Q, ty + 16 * 3 + 1);   // row i sees j <= i
    for (int j = 0; j < jmax; ++j)
      outer4(acc, Gt4[j * (QS / 4) + ty], Xs4[j * (PT / 4) + tx]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i < Q)
        st4(s.y + ((b * (long long)s.L + t0 + i) * s.H + h) * P, pt + 4 * tx,
            P, cvec, acc[r]);
    }
    __syncthreads();  // every read of this item's tiles is done
    if (it + 1 < items) put_item(m);
  }
}

// -- the backward ---------------------------------------------------------
constexpr int TS = QMAX + 4;        // row stride of the 64-wide tiles
constexpr int HBMAX = 4;            // most heads a backward CTA
constexpr int VEC = 8;              // per-head vectors of the chunk kernel
constexpr int WARPS = THREADS / 32;

// Row stride of the N-wide tiles, by the state's 64-row groups NR.
__host__ __device__ constexpr int ns_of(int nr) { return 64 * nr + 4; }
// Floats of the chunk kernel's two wide regions: C^T or B^T by slot (N
// rows of TS), B or C as they lie (QMAX rows of NS), h_in^T or D^T (PT
// rows of NS).
__host__ __device__ constexpr int wide_tile(int nr) {
  return 64 * nr * TS > QMAX * ns_of(nr) ? 64 * nr * TS : QMAX * ns_of(nr);
}
// Shared floats of the backward's chunk kernels.
__host__ __device__ constexpr int dstate_smem(int nr) {
  return QMAX * ns_of(nr) + QMAX * TS + HBMAX * QMAX;
}
__host__ __device__ constexpr int bwd_smem(int nr) {
  return 2 * wide_tile(nr) + 2 * QMAX * TS + HBMAX * (VEC * QMAX + WARPS);
}

__device__ __forceinline__ float4 scale4(const float4& v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__device__ __forceinline__ void st4v(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A chunk tile by slot: t[k * TS + slot(i)] = src[i * rs + c0 + k] for
// rows i < QMAX (0 at i >= q) and columns k < kw (0 at c0 + k >= lim);
// nat, where given, the tile as it lies (nat[i * TS + k]).  Item it moves
// rows m + 16 r, columns k .. k + 3 (m = it % 16, k = it / 16 * 4): four
// loads along the rows (load_slot), then four 16-byte stores of the
// transposed tile (store_slot).  A 64-column tile is one item a thread,
// it = threadIdx.x.
__device__ __forceinline__ void load_slot(float4 (&v)[4], int it,
                                          const float* src, long long rs,
                                          int q, int c0, int lim, bool vec) {
  const int m = it % 16, k = it / 16 * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = m + 16 * r;
    v[r] = i < q ? ld4(src + i * rs, c0 + k, lim, vec) : zero4();
  }
}

__device__ __forceinline__ void store_slot(const float4 (&v)[4], int it,
                                           float* t, float* nat) {
  const int m = it % 16, k = it / 16 * 4;
  if (nat != nullptr)
#pragma unroll
    for (int r = 0; r < 4; ++r) st4v(nat + (m + 16 * r) * TS + k, v[r]);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    st4v(t + (k + u) * TS + 4 * m,
         make_float4(lane4(v[0], u), lane4(v[1], u), lane4(v[2], u),
                     lane4(v[3], u)));
}

// C^T or B^T by slot: N rows, the chunk's QMAX columns.
__device__ __forceinline__ void stage_slot(float* t, const float* src,
                                           long long rs, int q, int N,
                                           int kw, bool vec) {
  for (int it = threadIdx.x; it < 4 * kw; it += THREADS) {
    float4 v[4];
    load_slot(v, it, src, rs, q, 0, N, vec);
    store_slot(v, it, t, nullptr);
  }
}

// B or C rows as they lie: dst[i * NS + n] = src[i * rs + n] for rows
// i < QMAX (0 at i >= q) and n < 64 NR (0 at n >= N).
template <int NR>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long rs, int q, int N,
                                           bool vec) {
  constexpr int NS = ns_of(NR), NB = 16 * NR;
  for (int it = threadIdx.x; it < QMAX * NB; it += THREADS) {
    const int i = it / NB, n = it % NB * 4;
    st4v(dst + i * NS + n, i < q ? ld4(src + i * rs, n, N, vec) : zero4());
  }
}

// A state tile transposed: dst[p * NS + n] = src[n * P + c0 + p] for n <
// 64 NR (0 at n >= N) and p < PT (0 at c0 + p >= P).  Item it = threadIdx.x
// + THREADS e (e < NR) of the 16 NR x 16 moves the 4 x 4 block at n = it %
// (16 NR) * 4, p = it / (16 NR) * 4: four 16-byte loads (load_state),
// four 16-byte stores (store_state).
template <int NR>
__device__ __forceinline__ void load_state(float4 (*v)[4], int e,
                                           const float* src, int N, int P,
                                           int c0, bool vec) {
  const int it = threadIdx.x + THREADS * e;
  const int n = it % (16 * NR) * 4, p = it / (16 * NR) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    (*v)[r] = n + r < N ? ld4(src + (long long)(n + r) * P, c0 + p, P, vec)
                        : zero4();
}

template <int NR>
__device__ __forceinline__ void store_state(const float4 (*v)[4], int e,
                                            float* dst) {
  constexpr int NS = ns_of(NR);
  const int it = threadIdx.x + THREADS * e;
  const int n = it % (16 * NR) * 4, p = it / (16 * NR) * 4;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    st4v(dst + (p + u) * NS + n,
         make_float4(lane4((*v)[0], u), lane4((*v)[1], u), lane4((*v)[2], u),
                     lane4((*v)[3], u)));
}

// The sum of a . b over block e of a tile that store_state wrote to t
// (read back from where it lies there) and the same block b of another.
template <int NR>
__device__ __forceinline__ float dot_state(const float* t, int e,
                                           const float4 (*b)[4]) {
  constexpr int NS = ns_of(NR);
  const int it = threadIdx.x + THREADS * e;
  const int n = it % (16 * NR) * 4, p = it / (16 * NR) * 4;
  float hd = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 a = ld4s(t + (p + u) * NS + n);   // column p + u, rows n..
    hd = fmaf(a.x, lane4((*b)[0], u), hd);
    hd = fmaf(a.y, lane4((*b)[1], u), hd);
    hd = fmaf(a.z, lane4((*b)[2], u), hd);
    hd = fmaf(a.w, lane4((*b)[3], u), hd);
  }
  return hd;
}

// The sum of v over the 16 lanes of a thread row (one tx each).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block of heads a backward CTA works on: blockIdx.y is (group,
// block of the group's heads).
struct HeadBlock {
  int g, blk, nblk, h0, nh;
};

__device__ __forceinline__ HeadBlock head_block(const SsdArgs& s) {
  const int R = s.H / s.G, nblk = (R + s.hblk - 1) / s.hblk;
  HeadBlock hb;
  hb.g = blockIdx.y / nblk;
  hb.blk = blockIdx.y % nblk;
  hb.nblk = nblk;
  hb.h0 = hb.g * R + hb.blk * s.hblk;
  hb.nh = min(s.hblk, R - hb.blk * s.hblk);
  return hb;
}

// -- 4. S_c = sum_i e^{lc_i} C_i dy_i^T -------------------------------------
// One CTA a (chunk, group x block of heads, batch): C once, then per head
// and 64-column tile e^{lc} dy.  Thread (ty, tx) owns state rows 64 q +
// 4 ty + r and columns 4 tx + k: per step i, NR + 1 float4 reads for
// 16 NR FMAs.
template <int NR>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_bwd_dstate_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int NS = ns_of(NR);
  float* Cs = reinterpret_cast<float*>(smem4);   // QMAX x NS: C rows
  float* Ys = Cs + QMAX * NS;                    // QMAX x TS: e^{lc_i} dy_i
  float* els = Ys + QMAX * TS;                   // HBMAX x QMAX: e^{lc_i}
  const float4* Cs4 = reinterpret_cast<const float4*>(Cs);
  const float4* Ys4 = reinterpret_cast<const float4*>(Ys);

  const HeadBlock hb = head_block(s);
  const int ci = blockIdx.x, b = blockIdx.z;
  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, warp = tid / 32;
  const long long t0 = (long long)ci * Q;
  const bool cvec = P % 4 == 0;

  if (warp < hb.nh) {
    const int h = hb.h0 + warp, lane = tid & 31;
    float d0, d1, l0, l1;
    load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, d0, d1);
    scan_decay(d0, d1, s.a[h], Q, l0, l1);
    els[warp * QMAX + 2 * lane] = expf(l0);
    els[warp * QMAX + 2 * lane + 1] = expf(l1);
  }
  stage_rows<NR>(Cs, s.c + b * s.bb + t0 * s.bt + hb.g * s.bg, s.bt, Q, N,
                 s.bvec);
  // items (head, 64-column tile); the next item's dy is loaded into
  // registers behind the current item's product (element e of a thread:
  // row (tid + THREADS e) / 16, columns 4 ((tid + THREADS e) % 16) + ..3)
  const int npt = (P + PT - 1) / PT, items = hb.nh * npt;
  constexpr int YE = QMAX * PT / 4 / THREADS;
  float4 py[YE];
  auto load_dy = [&](int it) {
    const float* yb =
        s.dy + ((b * (long long)s.L + t0) * s.H + hb.h0 + it / npt) * P;
#pragma unroll
    for (int e = 0; e < YE; ++e) {
      const int idx = tid + THREADS * e, i = idx / (PT / 4);
      py[e] = i < Q ? ld4(yb + i * (long long)s.H * P,
                          it % npt * PT + idx % (PT / 4) * 4, P, s.yvec)
                    : zero4();
    }
  };
  load_dy(0);
  for (int it = 0; it < items; ++it) {
    const int hl = it / npt, h = hb.h0 + hl, pt = it % npt * PT;
    float* out = s.ds + (((long long)b * s.nc + ci) * s.H + h) * N * P;
    __syncthreads();  // C and e^{lc} staged; the last item's reads done
#pragma unroll
    for (int e = 0; e < YE; ++e) {
      const int idx = tid + THREADS * e, i = idx / (PT / 4);
      st4v(Ys + i * TS + idx % (PT / 4) * 4,
           scale4(py[e], els[hl * QMAX + i]));
    }
    if (it + 1 < items) load_dy(it + 1);
    __syncthreads();
    float acc[NR][4][4];
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[q][r][k] = 0.0f;
    for (int i = 0; i < Q; ++i) {
      const float4 yv = Ys4[i * (TS / 4) + tx];
#pragma unroll
      for (int q = 0; q < NR; ++q)
        outer4(acc[q], Cs4[(i * NS + 64 * q) / 4 + ty], yv);
    }
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 64 * q + 4 * ty + r;
        if (n < N) st4(out + (long long)n * P, pt + 4 * tx, P, cvec,
                       acc[q][r]);
      }
  }
}

// -- 5. the reverse carry: D_{c-1} = e^{L_c} D_c + S_c ----------------------
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_bwd_state_pass_kernel(const SsdArgs s) {
  const long long np = (long long)s.N * s.P;
  const long long e =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  if (e >= np) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int live = (int)(np - e < 4 ? np - e : 4);
  const bool vec = np % 4 == 0;
  const long long step = (long long)s.H * np;
  float* ds = s.ds + ((long long)b * s.nc * s.H + h) * np + e;
  const float* dec = s.decay + (long long)b * s.nc * s.H + h;
  float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (s.dhf != nullptr)
    ld_run(s.dhf + ((long long)b * s.H + h) * np + e, live,
           vec && ((uintptr_t)s.dhf & 15) == 0, hv);
  for (int k0 = 0; k0 < s.nc; k0 += PASS_DEPTH) {
    float v[PASS_DEPTH][4], d[PASS_DEPTH];
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (k0 + k < s.nc) {
        const int c = s.nc - 1 - k0 - k;
        ld_run(ds + c * step, live, vec, v[k]);
        d[k] = dec[(long long)c * s.H];
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (k0 + k < s.nc) {
        const int c = s.nc - 1 - k0 - k;
        st4(ds + c * step, 0, live, vec, hv);   // D leaving chunk c
#pragma unroll
        for (int u = 0; u < 4; ++u) hv[u] = fmaf(d[k], hv[u], v[k][u]);
      }
  }
}

// -- 6. the chunk's gradients ------------------------------------------------
// One CTA a (chunk, group x block of heads, batch).  Thread (ty, tx) owns
// the chunk rows ty + 16 r of every product; of a Q x Q triangle the
// columns tx + 16 u, u <= r (the blocks with u > r lie wholly above the
// diagonal), of a product with the state's N columns 64 q + 4 tx + k, of
// a product with P columns pt + 4 tx + k (W^T dy) or pt + tx + 16 k
// (B D).  The row's 16 lanes sum its dot products with shuffles.
template <int NR>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_bwd_chunk_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int NS = ns_of(NR), WT = wide_tile(NR);
  // R0, R1: wide; R2, R3: QMAX x TS.  By pass (each region's contents):
  //   C B^T:  R0 C^T by slot, R1 B^T by slot
  //   (A):    R0 x^T by slot, R1 dy as it lies, R2 W, R3 dy^T by slot;
  //           then R3 dW o W
  //   (B):    R0 D^T, R1 B as it lies, R2 x^T, R3 dCB^T (kept to the
  //           end); then R0 C as it lies, R2 dCB
  //   (C):    R0 C as it lies, R1 h_in^T, R2 dy^T; then R1 B as it lies
  float* R0 = reinterpret_cast<float*>(smem4);
  float* R1 = R0 + WT;
  float* R2 = R1 + WT;
  float* R3 = R2 + QMAX * TS;
  // per head: dt, lc, e^{lc}, e^{L - lc}, x . dxd, dlc, u, dt e^{L - lc}
  float* vec = R3 + QMAX * TS;
  float* red = vec + HBMAX * VEC * QMAX;         // a warp's <h_in, D>
  const float4* R0v = reinterpret_cast<const float4*>(R0);
  const float4* R1v = reinterpret_cast<const float4*>(R1);
  const float4* R2v = reinterpret_cast<const float4*>(R2);
  const float4* R3v = reinterpret_cast<const float4*>(R3);

  const HeadBlock hb = head_block(s);
  const int ci = blockIdx.x, b = blockIdx.z;
  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, warp = tid / 32, lane = tid & 31;
  const long long t0 = (long long)ci * Q;
  const long long row0 = b * (long long)s.L + t0;   // (batch, step) row
  const bool cvec = P % 4 == 0;
  const float* cb0 = s.c + b * s.bb + t0 * s.bt + hb.g * s.bg;
  const float* bb0 = s.b + b * s.bb + t0 * s.bt + hb.g * s.bg;
  auto hv = [&](int hl, int k) { return vec + (hl * VEC + k) * QMAX; };

  if (warp < hb.nh) {
    const int h = hb.h0 + warp;
    float d0, d1, l0, l1;
    load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, d0, d1);
    const float last = scan_decay(d0, d1, s.a[h], Q, l0, l1);
    const float e0 = expf(last - l0), e1 = expf(last - l1);
    const float vals[VEC][2] = {{d0, d1}, {l0, l1},
                                {expf(l0), expf(l1)}, {e0, e1},
                                {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f},
                                {d0 * e0, d1 * e1}};
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      hv(warp, k)[2 * lane] = vals[k][0];
      hv(warp, k)[2 * lane + 1] = vals[k][1];
    }
  }
  stage_slot(R0, cb0, s.bt, Q, N, 64 * NR, s.bvec);
  stage_slot(R1, bb0, s.bt, Q, N, 64 * NR, s.bvec);
  __syncthreads();

  // C B^T, lower triangle, once for every head of the block
  float cb[4][4], dcb[4][4];   // [r][u], u <= r: (ty + 16 r, tx + 16 u)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u <= r; ++u) cb[r][u] = dcb[r][u] = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float4 c4 = R0v[n * (TS / 4) + ty], b4 = R1v[n * (TS / 4) + tx];
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u <= r; ++u) cb[r][u] = fmaf(cv[r], bv[u], cb[r][u]);
  }

  // Each pass walks items (head, 64-column tile).
  const int npt = (P + PT - 1) / PT, items = hb.nh * npt;
  auto x_of = [&](int it) {
    return s.x + b * s.xb + t0 * s.xt + (hb.h0 + it / npt) * s.xh;
  };
  auto dy_of = [&](int it) {
    return s.dy + (row0 * s.H + hb.h0 + it / npt) * P;
  };
  auto state_of = [&](const float* base, int it) {
    return base + (((long long)b * s.nc + ci) * s.H + hb.h0 + it / npt) *
                      N * P;
  };

  // (A) per head: dW = dy x^T (dt_j still to apply) over the columns, 64
  // at a time, and dx = dt (W^T dy); then T, dCB and x . (W^T dy)
  float4 py[4], px[4];
  float dw[4][4];
  for (int it = 0; it < items; ++it) {
    const int hl = it / npt, h = hb.h0 + hl, pt = it % npt * PT;
    const int pw = min(PT, P - pt);
    const float *dts = hv(hl, 0), *lc = hv(hl, 1);
    float *ddx = hv(hl, 4), *dlc = hv(hl, 5);
    __syncthreads();  // the last reads of every region are done
    if (pt == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u <= r; ++u) dw[r][u] = 0.0f;
      // W = [j <= i] e^{lc_i - lc_j} C B^T (masked before the
      // exponential), rows i, columns by slot
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = tx + 16 * u;
          w[u] = 0.0f;
          if (u <= r && j <= i && i < Q)
            w[u] = cb[r][u] * expf(lc[i] - lc[j]);
        }
        st4v(R2 + i * TS + 4 * tx, make_float4(w[0], w[1], w[2], w[3]));
      }
    }
    load_slot(py, tid, dy_of(it), (long long)s.H * P, Q, pt, P, s.yvec);
    load_slot(px, tid, x_of(it), s.xt, Q, pt, P, s.xvec);
    store_slot(py, tid, R3, R1);   // dy^T; dy
    store_slot(px, tid, R0, nullptr);
    __syncthreads();
    for (int p = 0; p < pw; ++p) {
      const float4 y4 = R3v[p * (TS / 4) + ty], x4 = R0v[p * (TS / 4) + tx];
      const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u <= r; ++u) dw[r][u] = fmaf(yv[r], xv[u], dw[r][u]);
    }
    // (W^T dy)_j = sum_{i >= j} W_ij dy_i: rows j = ty + 16 r, columns
    // 4 tx + k; the rows i of block m reach only rows j with r <= m
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int iend = min(Q, 16 * m + 16);
      for (int i = 16 * m; i < iend; ++i) {
        const float4 w4 = R2v[i * (TS / 4) + ty], y4 = R1v[i * (TS / 4) + tx];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int r = 0; r <= m; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[r][k] = fmaf(wv[r], yv[k], acc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j < Q) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = dts[j] * acc[r][k];
        st4(s.dx + ((row0 + j) * s.H + h) * P, pt + 4 * tx, P, cvec, o);
      }
    }
    if (pt + PT < P) continue;
    __syncthreads();  // every read of this head's dy^T done: R3 is free
    // R3 = dW o W (dt_j still to apply); dCB += dt_j e^{lc_i - lc_j} dW
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float4 w4 = ld4s(R2 + i * TS + 4 * tx);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tx + 16 * u;
        float t = 0.0f;
        if (u <= r) {
          t = dw[r][u] * wv[u];
          if (j <= i && i < Q)
            dcb[r][u] = fmaf(dw[r][u] * dts[j], expf(lc[i] - lc[j]),
                             dcb[r][u]);
        }
        R3[i * TS + j] = t;
      }
    }
    __syncthreads();
    // dlc_i += sum_j T_ij - sum_k T_ki with T_ij = dt_j (dW o W)_ij, and
    // x_j . (W^T dy)_j = sum_i (dW o W)_ij; four lanes a row
    {
      const int i = tid / 4, part = tid % 4;
      float rs = 0.0f, cs = 0.0f;
      for (int k = part; k < QMAX; k += 4) {
        rs = fmaf(dts[k], R3[i * TS + k], rs);
        cs += R3[k * TS + i];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
        cs += __shfl_xor_sync(0xffffffffu, cs, o);
      }
      if (part == 0) {
        dlc[i] += rs - dts[i] * cs;
        ddx[i] += cs;
      }
    }
  }

  // (B) per head: B D (to dx, x . dxd and u) and the block's sum of
  // e^{L - lc_j} D xd_j; then + dCB^T C: the block's dB
  __syncthreads();
  stage_rows<NR>(R1, bb0, s.bt, Q, N, s.bvec);
  // dCB^T by rows j, columns by slot, in R3 until the end (dCB's
  // registers are free from here)
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] = u <= r ? dcb[r][u] : 0.0f;
    st4v(R3 + (tx + 16 * u) * TS + 4 * ty, make_float4(o[0], o[1], o[2], o[3]));
  }
  float dbs[NR][4][4];
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) dbs[q][r][k] = 0.0f;
  for (int it = 0; it < items; ++it) {
    const int hl = it / npt, h = hb.h0 + hl, pt = it % npt * PT;
    const int pw = min(PT, P - pt);
    const float *er = hv(hl, 3), *wj = hv(hl, 7);
    float *ddx = hv(hl, 4), *dlc = hv(hl, 5), *us = hv(hl, 6);
    {
      __syncthreads();  // B staged; the last item's reads done
      {
        load_slot(px, tid, x_of(it), s.xt, Q, pt, P, s.xvec);
#pragma unroll
        for (int e = 0; e < NR; ++e) {                // D^T
          float4 dv[1][4];
          load_state<NR>(dv, e, state_of(s.ds, it), N, P, pt, cvec);
          store_state<NR>(dv, e, R0);
        }
        store_slot(px, tid, R2, nullptr);   // x^T
      }
      __syncthreads();
      // (B D)_jp = sum_n B_jn D_np: rows j = ty + 16 r, columns p = tx +
      // 16 k, 16-byte reads along n of both
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = R1v[((ty + 16 * r) * NS + n) / 4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 dv = R0v[((tx + 16 * k) * NS + n) / 4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float a = fmaf(bv[r].x, dv.x, acc[r][k]);
            a = fmaf(bv[r].y, dv.y, a);
            a = fmaf(bv[r].z, dv.z, a);
            acc[r][k] = fmaf(bv[r].w, dv.w, a);
          }
        }
      }
      // pass A's dx (dt_j (W^T dy)_j) at rows ty + 16 r, columns tx + 16 k,
      // loaded behind the row sums below where registers allow (N <= 64;
      // at N = 128 read where it is added)
      constexpr bool early_dx = NR == 1;
      float dxa[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = ty + 16 * r, p = tx + 16 * k;
          dxa[r][k] = early_dx && j < Q && p < pw
                          ? s.dx[((row0 + j) * s.H + h) * P + pt + p] : 0.0f;
        }
      // x_j . (B D)_j: dx += dt_j e^{L - lc_j} (B D)_j, x . dxd += e^{L -
      // lc_j} x_j . (B D)_j, u_j = dt_j e^{L - lc_j} x_j . (B D)_j
      float xbd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {   // x at (ty + 16 r, tx + 16 k)
        const float4 x4 = R2v[((tx + 16 * k) * TS) / 4 + ty];
        xbd[0] = fmaf(x4.x, acc[0][k], xbd[0]);
        xbd[1] = fmaf(x4.y, acc[1][k], xbd[1]);
        xbd[2] = fmaf(x4.z, acc[2][k], xbd[2]);
        xbd[3] = fmaf(x4.w, acc[3][k], xbd[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        const float part = row_sum16(xbd[r]);
        if (j < Q) {
          if (tx == 0) {
            const float u = wj[j] * part;
            ddx[j] += er[j] * part;
            dlc[j] -= u;
            us[j] += u;
          }
          float* dxr = s.dx + ((row0 + j) * s.H + h) * P + pt;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (tx + 16 * k < pw)
              dxr[tx + 16 * k] = fmaf(wj[j], acc[r][k], early_dx
                                      ? dxa[r][k] : dxr[tx + 16 * k]);
        }
      }
      // the block's e^{L - lc_j} D xd_j over this tile's columns
      const float w0 = wj[ty], w1 = wj[ty + 16], w2 = wj[ty + 32],
                  w3 = wj[ty + 48];
      for (int p = 0; p < pw; ++p) {
        const float4 x4 = R2v[p * (TS / 4) + ty];
        const float4 a4 = make_float4(x4.x * w0, x4.y * w1, x4.z * w2,
                                      x4.w * w3);
#pragma unroll
        for (int q = 0; q < NR; ++q)
          outer4(dbs[q], a4, R0v[(p * NS + 64 * q) / 4 + tx]);
      }
    }
  }
  // dB and dC rows (batch, step) of G x blocks: the block's at col (with
  // one block a group, db and dc themselves)
  const bool nvec = N % 4 == 0;
  const int rows = s.G * hb.nblk, col = hb.g * hb.nblk + hb.blk;
  __syncthreads();  // every read of the regions done
  // dCB by rows i, columns by slot: the thread's own entries of R3's
  // dCB^T, transposed; C as it lies
  {
    float4 t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) t[u] = ld4s(R3 + (tx + 16 * u) * TS + 4 * ty);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4v(R2 + (ty + 16 * r) * TS + 4 * tx,
           make_float4(lane4(t[0], r), lane4(t[1], r), lane4(t[2], r),
                       lane4(t[3], r)));
  }
  stage_rows<NR>(R0, cb0, s.bt, Q, N, s.bvec);
  __syncthreads();
  // dB_j += sum_{i >= j} dCB_ij C_i: the rows i of block m reach rows j
  // with r <= m
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int iend = min(Q, 16 * m + 16);
    for (int i = 16 * m; i < iend; ++i) {
      const float4 a4 = R2v[i * (TS / 4) + ty];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float4 c4 = R0v[(i * NS + 64 * q) / 4 + tx];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r <= m; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dbs[q][r][k] = fmaf(av[r], cv[k], dbs[q][r][k]);
      }
    }
  }
  {
    float* dst = (hb.nblk == 1 ? s.db_ : s.dbp) + (row0 * rows + col) * N;
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        if (j < Q)
          st4(dst + (long long)j * rows * N, 64 * q + 4 * tx, N, nvec,
              dbs[q][r]);
      }
  }

  // (C) per head: H dy (for dlc) and the block's sum of e^{lc_i} H dy_i;
  // then + dCB B: the block's dC
  float dcs[NR][4][4];
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) dcs[q][r][k] = 0.0f;
  float dci[NR][4][4], hd = 0.0f;
  for (int it = 0; it < items; ++it) {
    const int hl = it / npt, pt = it % npt * PT;
    const int pw = min(PT, P - pt);
    const float* el = hv(hl, 2);
    float* dlc = hv(hl, 5);
    if (pt == 0) {
      hd = 0.0f;
#pragma unroll
      for (int q = 0; q < NR; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) dci[q][r][k] = 0.0f;
    }
    {
      __syncthreads();  // C staged; the last item's reads done
#pragma unroll
      for (int e = 0; e < NR; ++e) {                  // h_in^T, <h_in, D>
        float4 hs[1][4], ds[1][4];
        load_state<NR>(hs, e, state_of(s.cs, it), N, P, pt, cvec);
        store_state<NR>(hs, e, R1);
        load_state<NR>(ds, e, state_of(s.ds, it), N, P, pt, cvec);
        hd += dot_state<NR>(R1, e, ds);
      }
      load_slot(py, tid, dy_of(it), (long long)s.H * P, Q, pt, P, s.yvec);
      store_slot(py, tid, R2, nullptr);   // dy^T
      __syncthreads();
      for (int p = 0; p < pw; ++p) {
        const float4 a4 = R2v[p * (TS / 4) + ty];
#pragma unroll
        for (int q = 0; q < NR; ++q)
          outer4(dci[q], a4, R1v[(p * NS + 64 * q) / 4 + tx]);
      }
    }
    if (pt + PT < P) continue;
    // dlc_i += e^{lc_i} C_i . (H dy_i); dC += e^{lc_i} H dy_i
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float e = el[i];
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float4 c4 = R0v[(i * NS + 64 * q) / 4 + tx];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          part = fmaf(cv[k], dci[q][r][k], part);
          dcs[q][r][k] = fmaf(e, dci[q][r][k], dcs[q][r][k]);
        }
      }
      part = row_sum16(part);
      if (tx == 0 && i < Q) dlc[i] += e * part;
    }
    hd = warp_sum(hd);
    if (lane == 0) red[hl * WARPS + warp] = hd;
  }
  __syncthreads();  // every read of the regions done
  stage_rows<NR>(R1, bb0, s.bt, Q, N, s.bvec);
  __syncthreads();
  // dC_i += sum_{j <= i} dCB_ij B_j: the rows j of block m reach rows i
  // with r >= m
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int jend = min(Q, 16 * m + 16);
    for (int j = 16 * m; j < jend; ++j) {
      const float4 a4 = R3v[j * (TS / 4) + ty];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float4 b4 = R1v[(j * NS + 64 * q) / 4 + tx];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = m; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dcs[q][r][k] = fmaf(av[r], bv[k], dcs[q][r][k]);
      }
    }
  }
  {
    float* dst = (hb.nblk == 1 ? s.dc_ : s.dcp) + (row0 * rows + col) * N;
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < Q)
          st4(dst + (long long)i * rows * N, 64 * q + 4 * tx, N, nvec,
              dcs[q][r]);
      }
  }

  // dda_k = sum_{i >= k} dlc_i, with e^{L} <H, D> + sum_j u_j at Q - 1;
  // warp hl finishes head hl, lane l steps 2l and 2l + 1
  if (warp < hb.nh) {
    const int hl = warp, h = hb.h0 + hl;
    const float *dts = hv(hl, 0), *lc = hv(hl, 1), *ddx = hv(hl, 4);
    const float *dlc = hv(hl, 5), *us = hv(hl, 6);
    float hdt = 0.0f;
    for (int w = 0; w < WARPS; ++w) hdt += red[hl * WARPS + w];
    const float extra = expf(lc[Q - 1]) * hdt +
                        warp_sum(us[2 * lane] + us[2 * lane + 1]);
    const float v0 = dlc[2 * lane], v1 = dlc[2 * lane + 1];
    float incl = v0 + v1;             // over lanes >= l
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.0f;
    const float g1 = after + v1 + extra, g0 = g1 + v0;
    const float av = s.a[h];
    const int k0 = 2 * lane;
    if (k0 < Q) s.ddt[(row0 + k0) * s.H + h] = ddx[k0] + av * g0;
    if (k0 + 1 < Q) s.ddt[(row0 + k0 + 1) * s.H + h] = ddx[k0 + 1] + av * g1;
    const float dap = warp_sum(fmaf(g0, dts[k0], g1 * dts[k0 + 1]));
    if (lane == 0) s.dap[((long long)b * s.nc + ci) * s.H + h] = dap;
  }
}

// -- 7. dB and dC over each group's blocks, da over batch and chunks -------
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_sum_kernel(const SsdArgs s, int batch) {
  const int nblk = (s.H / s.G + s.hblk - 1) / s.hblk;
  const long long per = (long long)batch * s.L * s.G * s.N;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (nblk > 1 && e < 2 * per) {
    const bool isc = e >= per;
    const long long f = isc ? e - per : e;
    const long long row = f / ((long long)s.G * s.N);   // (batch, step)
    const int gn = (int)(f % ((long long)s.G * s.N));
    const int g = gn / s.N, n = gn % s.N;
    const float* src = (isc ? s.dcp : s.dbp) +
                       ((row * s.G + g) * nblk) * s.N + n;
    float acc = 0.0f;
    for (int k = 0; k < nblk; ++k) acc += src[(long long)k * s.N];
    (isc ? s.dc_ : s.db_)[f] = acc;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < s.H; h += THREADS) {
      float acc = 0.0f;
      for (long long k = 0; k < (long long)batch * s.nc; ++k)
        acc += s.dap[k * s.H + h];
      s.da[h] = acc;
    }
}

template <typename K>
cudaError_t opt_in(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int NR>
cudaError_t launch(const SsdArgs& s, int batch, cudaStream_t st) {
  const int nhb = (s.H / s.G + s.hblk - 1) / s.hblk;
  if (s.nc > 0) {
    ssd_chunk_state_kernel<NR>
        <<<dim3(s.nc, s.H, batch), THREADS,
           state_smem(NR) * sizeof(float), st>>>(s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long np = (long long)s.N * s.P;
  ssd_state_pass_kernel<<<
      dim3((unsigned)((np + 4 * PASS_THREADS - 1) / (4 * PASS_THREADS)),
           s.H, batch),
      PASS_THREADS, 0, st>>>(s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || s.nc == 0) return e;
  ssd_chunk_scan_kernel<NR><<<dim3(s.nc, s.G, batch * nhb), THREADS,
                              scan_smem(NR) * sizeof(float), st>>>(s);
  return cudaGetLastError();
}

bool aligned16(const void* p, const long long* strides, int n) {
  long long bits = (long long)reinterpret_cast<uintptr_t>(p) & 15;
  for (int i = 0; i < n; ++i) bits |= (strides[i] * 4) & 15;
  return bits == 0;
}

}  // namespace

// C interface (loaded with ctypes).  x (batch, L, H, P), dt (batch, L, H)
// and b/c (batch, L, G, N) fp32 with element strides xs, dts (batch, step,
// head) and bs (batch, step, group; shared by b and c), innermost strides
// 1; a (H,) fp32; y (batch, L, H, P) and state (batch, H, N, P)
// contiguous fp32; scratch batch * (L / Q) * H * (N * P + 1) floats.
// head_block heads share one C B^T in the chunk scan.  Takes 1 <= Q <= 64
// with L % Q == 0, 1 <= N <= 128 and H % G == 0; anything else returns
// cudaErrorInvalidValue unlaunched.  Nothing is launched for an empty
// batch, head set or state column set; L == 0 gives a zero state.
extern "C" int ssd_scan_launch(const void* x, const long long* xs,
                               const void* dt, const long long* dts,
                               const void* a, const void* b, const void* c,
                               const long long* bs, void* y, void* state,
                               void* scratch, int batch, int L, int H,
                               int G, int N, int P, int Q, int head_block,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || H == 0 || P == 0) return 0;
  if (Q < 1 || Q > QMAX || L % Q || N < 1 || N > NMAX || G < 1 || H % G ||
      head_block < 1)
    return (int)cudaErrorInvalidValue;
  const int nhb = (H / G + head_block - 1) / head_block;
  if (H > 65535 || batch > 65535 || (long long)batch * nhb > 65535 ||
      G > 65535)
    return (int)cudaErrorInvalidConfiguration;
  static bool attr_set = false;  // one opt-in per kernel, at its size
  if (!attr_set) {
    cudaError_t e;
    if ((e = opt_in(ssd_chunk_state_kernel<1>, state_smem(1))) ||
        (e = opt_in(ssd_chunk_state_kernel<2>, state_smem(2))) ||
        (e = opt_in(ssd_chunk_scan_kernel<1>, scan_smem(1))) ||
        (e = opt_in(ssd_chunk_scan_kernel<2>, scan_smem(2))))
      return (int)e;
    attr_set = true;
  }
  const int nc = L / Q;
  float* cs = static_cast<float*>(scratch);
  SsdArgs s;
  s.x = static_cast<const float*>(x);
  s.dt = static_cast<const float*>(dt);
  s.a = static_cast<const float*>(a);
  s.b = static_cast<const float*>(b);
  s.c = static_cast<const float*>(c);
  s.y = static_cast<float*>(y);
  s.state = static_cast<float*>(state);
  s.cs = cs;
  s.decay = cs + (long long)batch * nc * H * N * P;
  s.xb = xs[0]; s.xt = xs[1]; s.xh = xs[2];
  s.db = dts[0]; s.dtt = dts[1]; s.dh = dts[2];
  s.bb = bs[0]; s.bt = bs[1]; s.bg = bs[2];
  s.L = L; s.H = H; s.G = G; s.N = N; s.P = P; s.Q = Q; s.nc = nc;
  s.hblk = head_block;
  s.xvec = aligned16(x, xs, 3);
  s.bvec = aligned16(b, bs, 3) && aligned16(c, bs, 3);
  return (int)(N <= 64 ? launch<1>(s, batch, st) : launch<2>(s, batch, st));
}

namespace {

// The backward's shared-memory opt-in, once per kernel at its size.
cudaError_t bwd_opt_in() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t e;
  if ((e = opt_in(ssd_bwd_dstate_kernel<1>, dstate_smem(1))) ||
      (e = opt_in(ssd_bwd_dstate_kernel<2>, dstate_smem(2))) ||
      (e = opt_in(ssd_bwd_chunk_kernel<1>, bwd_smem(1))) ||
      (e = opt_in(ssd_bwd_chunk_kernel<2>, bwd_smem(2))))
    return e;
  attr_set = true;
  return cudaSuccess;
}

template <int NR>
cudaError_t launch_backward(const SsdArgs& s, int batch, int blocks,
                            cudaStream_t st) {
  const dim3 grid(s.nc, s.G * blocks, batch);
  const long long np = (long long)s.N * s.P;
  const dim3 pass((unsigned)((np + 4 * PASS_THREADS - 1) / (4 * PASS_THREADS)),
                  s.H, batch);
  ssd_bwd_dstate_kernel<NR>
      <<<grid, THREADS, dstate_smem(NR) * sizeof(float), st>>>(s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_state_pass_kernel<<<pass, PASS_THREADS, 0, st>>>(s);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<NR>
      <<<grid, THREADS, bwd_smem(NR) * sizeof(float), st>>>(s);
  return cudaGetLastError();
}

template <typename K>
cudaError_t kernel_info(K kernel, int floats, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, kernel, THREADS, floats * sizeof(float));
  out[0] = floats * (int)sizeof(float);
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return e;
}

}  // namespace

// The backward's chunk kernels as built, for a state width N: out[0..3]
// the chunk kernel's shared bytes, CTAs an SM (the runtime's occupancy,
// registers included), registers a thread and local (spilled) bytes a
// thread; out[4..7] the same of the S_c kernel.
extern "C" int ssd_scan_backward_info(int N, int* out) {
  cudaError_t e = bwd_opt_in();
  if (e != cudaSuccess) return (int)e;
  if (N > 64) {
    if ((e = kernel_info(ssd_bwd_chunk_kernel<2>, bwd_smem(2), out)) ||
        (e = kernel_info(ssd_bwd_dstate_kernel<2>, dstate_smem(2), out + 4)))
      return (int)e;
  } else if ((e = kernel_info(ssd_bwd_chunk_kernel<1>, bwd_smem(1), out)) ||
             (e = kernel_info(ssd_bwd_dstate_kernel<1>, dstate_smem(1),
                              out + 4))) {
    return (int)e;
  }
  return 0;
}

// C interface of the backward.  x, dt, a, b, c as ssd_scan_launch read
// them (the same strides); dy (batch, L, H, P) and dh_final (batch, H, N,
// P; null: zero) contiguous fp32; fwd_scratch the forward's scratch of the
// same operands (h_in, then the decays), read only.  Writes dx (batch, L,
// H, P), ddt (batch, L, H), da (H,), db and dc (batch, L, G, N), all
// contiguous fp32.  head_block (1..4) heads of a group share a CTA of the
// chunk kernels; with blocks = ceil(H / G / head_block) > 1 the blocks' dB
// and dC go to scratch first.  scratch: batch * (L / Q) * H * N * P
// floats (the state gradients), then batch * (L / Q) * H (the da terms)
// rounded up to a multiple of 4, then where blocks > 1 2 * batch * L * G *
// blocks * N (the blocks' dB and dC).  Takes what ssd_scan_launch takes;
// an empty batch, head set or state column set launches nothing.
extern "C" int ssd_scan_backward_launch(
    const void* x, const long long* xs, const void* dt, const long long* dts,
    const void* a, const void* b, const void* c, const long long* bs,
    const void* dy, const void* dh_final, const void* fwd_scratch, void* dx,
    void* ddt, void* da, void* db, void* dc, void* scratch, int batch, int L,
    int H, int G, int N, int P, int Q, int head_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || H == 0 || P == 0) return 0;
  if (Q < 1 || Q > QMAX || L % Q || N < 1 || N > NMAX || G < 1 || H % G ||
      head_block < 1 || head_block > HBMAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (H / G + head_block - 1) / head_block;
  if (H > 65535 || batch > 65535 || (long long)G * blocks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = bwd_opt_in();
  if (e != cudaSuccess) return (int)e;
  const int nc = L / Q;
  const long long states = (long long)batch * nc * H * N * P;
  const long long terms = ((long long)batch * nc * H + 3) / 4 * 4;
  float* scr = static_cast<float*>(scratch);
  const float* fwd = static_cast<const float*>(fwd_scratch);
  SsdArgs s = {};
  s.x = static_cast<const float*>(x);
  s.dt = static_cast<const float*>(dt);
  s.a = static_cast<const float*>(a);
  s.b = static_cast<const float*>(b);
  s.c = static_cast<const float*>(c);
  s.cs = const_cast<float*>(fwd);               // h_in, read only
  s.decay = const_cast<float*>(fwd) + states;
  s.xb = xs[0]; s.xt = xs[1]; s.xh = xs[2];
  s.db = dts[0]; s.dtt = dts[1]; s.dh = dts[2];
  s.bb = bs[0]; s.bt = bs[1]; s.bg = bs[2];
  s.L = L; s.H = H; s.G = G; s.N = N; s.P = P; s.Q = Q; s.nc = nc;
  s.hblk = head_block;
  s.xvec = aligned16(x, xs, 3);
  s.bvec = aligned16(b, bs, 3) && aligned16(c, bs, 3);
  const long long ys[3] = {(long long)L * H * P, (long long)H * P, P};
  s.yvec = aligned16(dy, ys, 3);
  s.dy = static_cast<const float*>(dy);
  s.dhf = static_cast<const float*>(dh_final);
  s.ds = scr;
  s.dap = scr + states;
  s.dx = static_cast<float*>(dx);
  s.ddt = static_cast<float*>(ddt);
  s.da = static_cast<float*>(da);
  s.db_ = static_cast<float*>(db);
  s.dc_ = static_cast<float*>(dc);
  s.dbp = blocks > 1 ? s.dap + terms : s.db_;
  s.dcp = blocks > 1 ? s.dbp + (long long)batch * L * G * blocks * N : s.dc_;
  if (nc > 0) {
    e = N > 64 ? launch_backward<2>(s, batch, blocks, st)
               : launch_backward<1>(s, batch, blocks, st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per = (long long)batch * L * G * N;
  const long long sum_blocks =
      blocks > 1 && per > 0 ? (2 * per + THREADS - 1) / THREADS : 1;
  if (sum_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_bwd_sum_kernel<<<(unsigned)sum_blocks, THREADS, 0, st>>>(s, batch);
  return (int)cudaGetLastError();
}
