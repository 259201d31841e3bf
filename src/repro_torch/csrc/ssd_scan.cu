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
// in four launches: 4. ssd_bwd_dstate_kernel, one CTA a (chunk, head,
// batch), S_c into the backward's scratch; 5. ssd_bwd_state_pass_kernel,
// the reverse carry (the forward's pass run from the last chunk), writing
// each chunk's D over its S_c; 6. ssd_bwd_chunk_kernel, one CTA a (chunk,
// head, batch): everything else of the chunk, dx and ddt to their outputs,
// each head's dB and dC rows and its chunk's da term to scratch (where a
// group has one head, dB and dC go straight to the outputs); 7.
// ssd_bwd_sum_kernel sums dB and dC over the heads of each group and da
// over batch and chunks, each in a fixed order.  No float atomics: two
// calls give the same bits.  One CTA a head gives nc H B CTAs (4096 at
// mamba2-370m's 4 x 2048 training batch), where one a group would give
// 128, fewer than the 132 SMs.
//
// What bounds the backward: the operations.  Per chunk and head the
// four Q x Q products with P or N (dW, W^T dy, dC's and dB's intra
// terms), Q(Q+1)/2 (2P + 2N) multiply-adds, and four Q N P products (S_c,
// H dy, D xd, D^T B); C B^T once per group: 23.8 GFLOP at mamba2-370m's
// training shape (x (4, 2048, 32, 64), B/C (4, 2048, 1, 128)), 0.355 ms at
// 67 TFLOP/s fp32, and 25.9 GFLOP at zamba2-1.2b's (x (4, 2048, 64, 64),
// N = 64), 0.387 ms; the bytes (inputs, h_in, outputs) take 0.10-0.16 ms
// at 3.35 TB/s.  The design is the simple one: every product runs from
// shared memory through scalar reads into 4 x 4 register tiles
// (mm_tile), on tiles whose odd row strides keep both orientations free
// of bank conflicts; C B^T is recomputed per head; fp32 on the CUDA cores
// as the forward (the tolerance rules out TF32).
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
  // their D; dbp/dcp (B, L, H, N) and dap (B, nc, H) the per-head terms
  const float *dy, *dhf;
  float *ds, *dx, *ddt, *da, *db_, *dc_, *dbp, *dcp, *dap;
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
constexpr int BQ = QMAX + 1;        // row stride of the 64-wide tiles

// Shared floats of the backward kernels, by the state's 64-row groups NR
// (NP = 64 NR + 1: the row stride of the N-wide tiles).
__host__ __device__ constexpr int dstate_smem(int nr) {
  return QMAX * (64 * nr + 1) + QMAX * BQ + QMAX;
}
__host__ __device__ constexpr int bwd_smem(int nr) {
  return 2 * QMAX * (64 * nr + 1) + 3 * QMAX * BQ + 2 * 64 * nr * BQ +
         7 * QMAX + THREADS / 32;
}

// acc[q][r][k] += sum_{t < T} A[t as + i ai] B[t bs + j bi] for the
// thread's rows i = ty + 16 r and columns j = 64 q + tx + 16 k: a 64 x 64 NQ
// output block from shared memory.  With a unit or odd stride on i and on
// j, neither operand's reads conflict on a bank.
template <int NQ>
__device__ __forceinline__ void mm_tile(float (&acc)[NQ][4][4],
                                        const float* A, int as, int ai,
                                        const float* B, int bs, int bi,
                                        int T) {
  const float* a0 = A + (threadIdx.x / TX) * ai;
  const float* b0 = B + (threadIdx.x % TX) * bi;
  for (int t = 0; t < T; ++t) {
    float av[4], bv[NQ][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a0[t * as + 16 * r * ai];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bv[q][k] = b0[t * bs + (64 * q + 16 * k) * bi];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[q][r][k] = fmaf(av[r], bv[q][k], acc[q][r][k]);
  }
}

template <int NQ>
__device__ __forceinline__ void zero_tile(float (&acc)[NQ][4][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][r][k] = 0.0f;
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

// -- 4. S_c = sum_i e^{lc_i} C_i dy_i^T -------------------------------------
template <int NR>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_dstate_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int NP = 64 * NR + 1;
  float* Cs = reinterpret_cast<float*>(smem4);   // QMAX x NP: e^{lc_i} C_i
  float* Ys = Cs + QMAX * NP;                    // QMAX x BQ: dy rows
  float* el = Ys + QMAX * BQ;                    // QMAX: e^{lc_i}

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (s.H / s.G);
  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const long long t0 = (long long)ci * Q;
  const float* cb = s.c + b * s.bb + t0 * s.bt + g * s.bg;
  const float* yb = s.dy + ((b * (long long)s.L + t0) * s.H + h) * P;
  float* out = s.ds + (((long long)b * s.nc + ci) * s.H + h) * N * P;

  if (tid < 32) {
    float d0, d1, l0, l1;
    load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, d0, d1);
    scan_decay(d0, d1, s.a[h], Q, l0, l1);
    el[2 * tid] = expf(l0);
    el[2 * tid + 1] = expf(l1);
  }
  __syncthreads();
  for (int idx = tid; idx < QMAX * 64 * NR; idx += THREADS) {
    const int i = idx / (64 * NR), n = idx % (64 * NR);
    Cs[i * NP + n] = i < Q && n < N ? el[i] * cb[i * s.bt + n] : 0.0f;
  }
  for (int pt = 0; pt < P; pt += PT) {
    const int pw = min(PT, P - pt);
    __syncthreads();  // C staged; the last tile's reads of Ys done
    for (int idx = tid; idx < QMAX * PT; idx += THREADS) {
      const int i = idx / PT, p = idx % PT;
      Ys[i * BQ + p] =
          i < Q && p < pw ? yb[(long long)i * s.H * P + pt + p] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      float acc[1][4][4];
      zero_tile(acc);
      mm_tile(acc, Cs + 64 * q, NP, 1, Ys, BQ, 1, Q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 64 * q + ty + 16 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (n < N && p < pw) out[(long long)n * P + pt + p] = acc[0][r][k];
        }
      }
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
// Thread (ty, tx) owns rows ty + 16 r and columns 64 q + tx + 16 k of every
// product (mm_tile); the row's lanes sum its dot products with shuffles.
template <int NR>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_chunk_kernel(const SsdArgs s) {
  extern __shared__ float4 smem4[];
  constexpr int NP = 64 * NR + 1;
  float* Cs = reinterpret_cast<float*>(smem4);   // QMAX x NP: C rows
  float* Bs = Cs + QMAX * NP;                    // QMAX x NP: B rows
  float* Ws = Bs + QMAX * NP;                    // QMAX x BQ: W
  float* Ys = Ws + QMAX * BQ;                    // QMAX x BQ: dy; then T
  float* Xs = Ys + QMAX * BQ;                    // QMAX x BQ: x; then dCB
  float* Hs = Xs + QMAX * BQ;                    // 64 NR x BQ: h_in rows
  float* Ds = Hs + 64 * NR * BQ;                 // 64 NR x BQ: D rows
  float* lc = Ds + 64 * NR * BQ;                 // QMAX each
  float* el = lc + QMAX;                         // e^{lc_i}
  float* er = el + QMAX;                         // e^{L - lc_j}
  float* dts = er + QMAX;
  float* ddx = dts + QMAX;                       // x_j . dxd_j
  float* dlc = ddx + QMAX;
  float* us = dlc + QMAX;                        // u_j
  float* red = us + QMAX;                        // a warp's <h_in, D>
  float* Ts = Ys;
  float* Gs = Xs;

  const int Q = s.Q, N = s.N, P = s.P, tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX, lane = tid & 31;
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (s.H / s.G);
  const long long t0 = (long long)ci * Q;
  const long long cbase = ((long long)b * s.nc + ci) * s.H + h;
  const float* hin = s.cs + cbase * N * P;
  const float* dho = s.ds + cbase * N * P;
  const float* xb = s.x + b * s.xb + t0 * s.xt + h * s.xh;
  const float* yb = s.dy + ((b * (long long)s.L + t0) * s.H + h) * P;
  const long long row0 = b * (long long)s.L + t0;   // (batch, step) row

  float d0 = 0.0f, d1 = 0.0f, last = 0.0f;
  if (tid < 32) {
    float l0, l1;
    load_dt(s.dt + b * s.db + t0 * s.dtt + h * s.dh, s.dtt, Q, d0, d1);
    last = scan_decay(d0, d1, s.a[h], Q, l0, l1);
    lc[2 * tid] = l0;
    lc[2 * tid + 1] = l1;
    el[2 * tid] = expf(l0);
    el[2 * tid + 1] = expf(l1);
    er[2 * tid] = expf(last - l0);
    er[2 * tid + 1] = expf(last - l1);
    dts[2 * tid] = d0;
    dts[2 * tid + 1] = d1;
    ddx[2 * tid] = ddx[2 * tid + 1] = 0.0f;
  }
  {
    const float* cb = s.c + b * s.bb + t0 * s.bt + g * s.bg;
    const float* bb = s.b + b * s.bb + t0 * s.bt + g * s.bg;
    for (int idx = tid; idx < QMAX * 64 * NR; idx += THREADS) {
      const int i = idx / (64 * NR), n = idx % (64 * NR);
      const bool in = i < Q && n < N;
      Cs[i * NP + n] = in ? cb[i * s.bt + n] : 0.0f;
      Bs[i * NP + n] = in ? bb[i * s.bt + n] : 0.0f;
    }
  }
  __syncthreads();

  // W = [j <= i] e^{lc_i - lc_j} C B^T (masked before the exponential)
  {
    float cbt[1][4][4];
    zero_tile(cbt);
    mm_tile(cbt, Cs, 1, NP, Bs, 1, NP, N);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tx + 16 * k;
        Ws[i * BQ + j] =
            j <= i && i < Q ? cbt[0][r][k] * expf(lc[i] - lc[j]) : 0.0f;
      }
    }
  }

  // over the state's columns, 64 at a time: dW = dy x^T, H dy, D x (each
  // row j still to be scaled by dt_j), and dxd, dx and x . dxd
  float dw[1][4][4], dci[NR][4][4], dbs[NR][4][4];
  zero_tile(dw);
  zero_tile(dci);
  zero_tile(dbs);
  float hd = 0.0f;
  for (int pt = 0; pt < P; pt += PT) {
    const int pw = min(PT, P - pt);
    __syncthreads();  // W written; the last tile's reads done
    for (int idx = tid; idx < QMAX * PT; idx += THREADS) {
      const int i = idx / PT, p = idx % PT;
      const bool in = i < Q && p < pw;
      Ys[i * BQ + p] = in ? yb[(long long)i * s.H * P + pt + p] : 0.0f;
      Xs[i * BQ + p] = in ? xb[i * s.xt + pt + p] : 0.0f;
    }
    for (int idx = tid; idx < 64 * NR * PT; idx += THREADS) {
      const int n = idx / PT, p = idx % PT;
      const bool in = n < N && p < pw;
      const float hv = in ? hin[(long long)n * P + pt + p] : 0.0f;
      const float dv = in ? dho[(long long)n * P + pt + p] : 0.0f;
      Hs[n * BQ + p] = hv;
      Ds[n * BQ + p] = dv;
      hd = fmaf(hv, dv, hd);
    }
    __syncthreads();
    mm_tile(dw, Ys, 1, BQ, Xs, 1, BQ, pw);
    mm_tile(dci, Ys, 1, BQ, Hs, 1, BQ, pw);
    mm_tile(dbs, Xs, 1, BQ, Ds, 1, BQ, pw);
    float dxd[1][4][4];
    zero_tile(dxd);
    mm_tile(dxd, Bs, 1, NP, Ds, BQ, 1, N);          // D^T B_j
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) dxd[0][r][k] *= er[ty + 16 * r];
    mm_tile(dxd, Ws, BQ, 1, Ys, BQ, 1, Q);          // + sum_i W_ij dy_i
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tx + 16 * k;
        part = fmaf(Xs[j * BQ + p], dxd[0][r][k], part);
        if (j < Q && p < pw)
          s.dx[((row0 + j) * s.H + h) * P + pt + p] = dts[j] * dxd[0][r][k];
      }
      part = row_sum16(part);
      if (tx == 0) ddx[j] += part;
    }
  }
  __syncthreads();  // every read of the tiles done: Ys and Xs are free

  hd = warp_sum(hd);
  if (lane == 0) red[tid / 32] = hd;
  // T = dW o W and dCB = [j <= i] e^{lc_i - lc_j} dW
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = tx + 16 * k;
      const float v = dw[0][r][k] * dts[j];
      Ts[i * BQ + j] = v * Ws[i * BQ + j];
      Gs[i * BQ + j] = j <= i && i < Q ? v * expf(lc[i] - lc[j]) : 0.0f;
    }
  }
  __syncthreads();
  if (tid < QMAX) {
    float v = 0.0f;
    for (int j = 0; j < QMAX; ++j) v += Ts[tid * BQ + j] - Ts[j * BQ + tid];
    dlc[tid] = v;
  }
  __syncthreads();

  // dC = e^{lc_i} H dy_i + sum_j dCB_ij B_j; dlc_i += C_i . e^{lc_i} H dy_i
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dci[q][r][k] *= el[i];
        part = fmaf(Cs[i * NP + 64 * q + tx + 16 * k], dci[q][r][k], part);
      }
    part = row_sum16(part);
    if (tx == 0) dlc[i] += part;
  }
  mm_tile(dci, Gs, 1, BQ, Bs, NP, 1, Q);
  // dB = e^{L - lc_j} D xd_j + sum_i dCB_ij C_i; dlc_j -= u_j
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    const float w = dts[j] * er[j];
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dbs[q][r][k] *= w;
        part = fmaf(Bs[j * NP + 64 * q + tx + 16 * k], dbs[q][r][k], part);
      }
    part = row_sum16(part);
    if (tx == 0) {
      dlc[j] -= part;
      us[j] = part;
    }
  }
  mm_tile(dbs, Gs, BQ, 1, Cs, NP, 1, Q);
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 64 * q + tx + 16 * k;
        if (i < Q && n < N) {
          const long long o = ((row0 + i) * s.H + h) * N + n;
          s.dcp[o] = dci[q][r][k];
          s.dbp[o] = dbs[q][r][k];
        }
      }
    }
  __syncthreads();

  // dda_k = sum_{i >= k} dlc_i, with e^{L} <H, D> + sum_j u_j at Q - 1;
  // lane l holds steps 2l and 2l + 1
  if (tid < 32) {
    float hdt = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) hdt += red[w];
    const float extra = expf(last) * hdt + warp_sum(us[2 * lane] +
                                                    us[2 * lane + 1]);
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
    const float dap = warp_sum(fmaf(g0, d0, g1 * d1));   // d is 0 past Q
    if (lane == 0) s.dap[cbase] = dap;
  }
}

// -- 7. dB and dC over each group's heads, da over batch and chunks --------
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_sum_kernel(const SsdArgs s, int batch) {
  const int R = s.H / s.G;
  const long long per = (long long)batch * s.L * s.G * s.N;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (R > 1 && e < 2 * per) {
    const bool isc = e >= per;
    const long long f = isc ? e - per : e;
    const long long row = f / ((long long)s.G * s.N);   // (batch, step)
    const int gn = (int)(f % ((long long)s.G * s.N));
    const int g = gn / s.N, n = gn % s.N;
    const float* src =
        (isc ? s.dcp : s.dbp) + (row * s.H + (long long)g * R) * s.N + n;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += src[(long long)r * s.N];
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

// C interface of the backward.  x, dt, a, b, c as ssd_scan_launch read
// them (the same strides); dy (batch, L, H, P) and dh_final (batch, H, N,
// P; null: zero) contiguous fp32; fwd_scratch the forward's scratch of the
// same operands (h_in, then the decays), read only.  Writes dx (batch, L,
// H, P), ddt (batch, L, H), da (H,), db and dc (batch, L, G, N), all
// contiguous fp32.  scratch: batch * (L / Q) * H * (N * P + 1) floats, and
// where H > G another 2 * batch * L * H * N (the per-head dB and dC).
// Takes what ssd_scan_launch takes; an empty batch, head set or state
// column set launches nothing.
extern "C" int ssd_scan_backward_launch(
    const void* x, const long long* xs, const void* dt, const long long* dts,
    const void* a, const void* b, const void* c, const long long* bs,
    const void* dy, const void* dh_final, const void* fwd_scratch, void* dx,
    void* ddt, void* da, void* db, void* dc, void* scratch, int batch, int L,
    int H, int G, int N, int P, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || H == 0 || P == 0) return 0;
  if (Q < 1 || Q > QMAX || L % Q || N < 1 || N > NMAX || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e;
    if ((e = opt_in(ssd_bwd_dstate_kernel<1>, dstate_smem(1))) ||
        (e = opt_in(ssd_bwd_dstate_kernel<2>, dstate_smem(2))) ||
        (e = opt_in(ssd_bwd_chunk_kernel<1>, bwd_smem(1))) ||
        (e = opt_in(ssd_bwd_chunk_kernel<2>, bwd_smem(2))))
      return (int)e;
    attr_set = true;
  }
  const int nc = L / Q;
  const long long states = (long long)batch * nc * H * N * P;
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
  s.dy = static_cast<const float*>(dy);
  s.dhf = static_cast<const float*>(dh_final);
  s.ds = scr;
  s.dap = scr + states;
  s.dx = static_cast<float*>(dx);
  s.ddt = static_cast<float*>(ddt);
  s.da = static_cast<float*>(da);
  s.db_ = static_cast<float*>(db);
  s.dc_ = static_cast<float*>(dc);
  const bool shared_group = H > G;
  s.dbp = shared_group ? s.dap + (long long)batch * nc * H : s.db_;
  s.dcp = shared_group ? s.dbp + (long long)batch * L * H * N : s.dc_;
  cudaError_t e;
  if (nc > 0) {
    const bool wide = N > 64;
    if (wide)
      ssd_bwd_dstate_kernel<2><<<dim3(nc, H, batch), THREADS,
                                 dstate_smem(2) * sizeof(float), st>>>(s);
    else
      ssd_bwd_dstate_kernel<1><<<dim3(nc, H, batch), THREADS,
                                 dstate_smem(1) * sizeof(float), st>>>(s);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const long long np = (long long)N * P;
    ssd_bwd_state_pass_kernel<<<
        dim3((unsigned)((np + 4 * PASS_THREADS - 1) / (4 * PASS_THREADS)), H,
             batch),
        PASS_THREADS, 0, st>>>(s);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (wide)
      ssd_bwd_chunk_kernel<2><<<dim3(nc, H, batch), THREADS,
                                bwd_smem(2) * sizeof(float), st>>>(s);
    else
      ssd_bwd_chunk_kernel<1><<<dim3(nc, H, batch), THREADS,
                                bwd_smem(1) * sizeof(float), st>>>(s);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long per = (long long)batch * L * G * N;
  const long long sum_blocks =
      shared_group && per > 0 ? (2 * per + THREADS - 1) / THREADS : 1;
  if (sum_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_bwd_sum_kernel<<<(unsigned)sum_blocks, THREADS, 0, st>>>(s, batch);
  return (int)cudaGetLastError();
}
