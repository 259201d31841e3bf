// The SIMT tile mainloop's pieces, shared by the STT GEMM templates
// (stt_gemm.cu: the output-stationary and reduction-tree tile kernel and
// the operand-stationary tile kernel) and the fused megakernels'
// `dot` stages (fused_chain.cu).
//
// A CTA of TILE_THREADS threads owns a BM x BN output tile; each thread
// owns a TM x TN register tile laid out as 4-wide quadrants, so that
// every k step reads its A and B fragments from shared memory as float4
// (fma_quads).  Operands are staged SLAB_K deep at a time through
// registers (Slab): the next slab's global loads are issued before this
// slab's FMAs and stored to shared memory after them, so one barrier a
// slab remains.  Loads are 16 bytes (8 for bf16) along whichever axis of
// the view has unit stride (Stage, picked by stage_mode), and
// element by element for other views.  Every output adds its products in
// ascending k, one fmaf at a time into one fp32 register.
#pragma once

#include "common.cuh"

namespace {

// k depth of a staged slab, and the threads of a tile CTA (16 x 16)
constexpr int SLAB_K = 32;
constexpr int TILE_THREADS = 256;

// How an operand's slab is staged: 4 elements a load along k, 4 along its
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

// The transposed view: element (c, r) of the result is element (r, c) of
// v.  A B operand (k, n) goes through Slab as its (n, k) transpose.
template <typename T>
__host__ __device__ __forceinline__ View<T> transposed(const View<T>& v) {
  return View<T>{v.p, v.sb, v.sc, v.sr};
}

// Column of row r at k in a swizzled slab: float4 group r / 4 XOR k / 4
// (mod 8).  A warp's k-major stores (8 k-quads x 4 rows, or 32 float4s of
// one k) then hit 32 banks, and a fragment read (4 or 8 consecutive
// float4s of one k) stays conflict-free.
__device__ __forceinline__ int swz(int k, int r) {
  return r ^ (4 * ((k / 4) % 8));
}

// The next slab of an operand viewed as (rows, k): rows [r0, r0 + R) x k
// [kk, kk + SLAB_K), held in registers between its global loads and its
// k-major store S[k][col(k, r)] (row length LD); zero past rmax and kend.
// A passes its (m, k) view, B the transposed view of its (k, n) one.  SW
// swizzles the columns (swz, rows of R); otherwise rows are R + 4 long,
// which offsets the banks of one k from the next.
template <typename T, int R, bool SW>
struct Slab {
  static constexpr int LD = SW ? R : R + 4;
  static constexpr int N4 = R * SLAB_K / 4 / TILE_THREADS;
  float4 v[N4];

  __device__ __forceinline__ void load(const View<T>& A, long long aoff,
                                       int r0, int kk, int rmax, int kend,
                                       int mode) {
    if (mode != STAGE_SCALAR && r0 + R <= rmax && kk + SLAB_K <= kend) {
      // the whole slab in range: vector loads, no element checks
      const T* base = A.p + aoff + (long long)r0 * A.sr + (long long)kk * A.sc;
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        const int idx = threadIdx.x + i * TILE_THREADS;
        if (mode == STAGE_MN)
          v[i] = load4(base + 4 * (idx % (R / 4)) +
                       (long long)(idx / (R / 4)) * A.sc);
        else
          v[i] = load4(base + (long long)(idx / (SLAB_K / 4)) * A.sr +
                       4 * (idx % (SLAB_K / 4)));
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const int idx = threadIdx.x + i * TILE_THREADS;
      if (mode == STAGE_MN) {  // 4 rows at one k
        const int r = 4 * (idx % (R / 4)), kq = idx / (R / 4);
        v[i] = fetch4(A, aoff, r0 + r, kk + kq, 1, 0, rmax, kend, true);
      } else {                 // 4 k at one row
        const int r = idx / (SLAB_K / 4), kq = 4 * (idx % (SLAB_K / 4));
        v[i] = fetch4(A, aoff, r0 + r, kk + kq, 0, 1, rmax, kend,
                      mode == STAGE_K);
      }
    }
  }
  __device__ __forceinline__ void store(float* S, int mode) const {
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const int idx = threadIdx.x + i * TILE_THREADS;
      if (mode == STAGE_MN) {
        const int r = 4 * (idx % (R / 4)), kq = idx / (R / 4);
        *reinterpret_cast<float4*>(S + kq * LD + (SW ? swz(kq, r) : r)) =
            v[i];
      } else {
        const int r = idx / (SLAB_K / 4), kq = 4 * (idx % (SLAB_K / 4));
        const int c = SW ? swz(kq, r) : r;  // the same for kq .. kq + 3
#pragma unroll
        for (int j = 0; j < 4; ++j) S[(kq + j) * LD + c] = at(v[i], j);
      }
    }
  }
};

// Thread (ty, tx) of the 16 x 16 grid: warp w covers ty 4 (w / 2) ..
// +3 and tx 8 (w % 2) .. +7, so that a warp's float4 fragment loads hit 4
// (A) and 8 (B) distinct addresses, one shared-memory wavefront each.
__device__ __forceinline__ int quad_ty() {
  return 4 * (threadIdx.x / 64) + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int quad_tx() {
  return 8 * ((threadIdx.x / 32) % 2) + threadIdx.x % 8;
}

// acc += As(:, slab) x Bs(slab, :) over SLAB_K k, ascending; As laid out
// as Slab<., BM, SW>'s, Bs rows of LDB, swizzled as Slab's when SW.
// Thread (ty, tx) owns rows q * (BM / QM) + 4 ty + i and columns q * (BN
// / QN) + 4 tx + j of the tile.
template <int BM, int BN, int TM, int TN, int LDB, bool SW>
__device__ __forceinline__ void fma_quads(float (&acc)[TM][TN],
                                          const float* As, const float* Bs,
                                          int ty, int tx) {
  constexpr int QM = TM / 4, QN = TN / 4, LDA = SW ? BM : BM + 4;
#pragma unroll
  for (int kq = 0; kq < SLAB_K; ++kq) {
    float a[TM], bv[TN];
#pragma unroll
    for (int q = 0; q < QM; ++q) {
      const int r = q * (BM / QM) + 4 * ty;
      const float4 x = *reinterpret_cast<const float4*>(
          As + kq * LDA + (SW ? swz(kq, r) : r));
      a[4 * q] = x.x; a[4 * q + 1] = x.y; a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int c = q * (BN / QN) + 4 * tx;
      const float4 x = *reinterpret_cast<const float4*>(
          Bs + kq * LDB + (SW ? swz(kq, c) : c));
      bv[4 * q] = x.x; bv[4 * q + 1] = x.y; bv[4 * q + 2] = x.z;
      bv[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// 4 flushed values (epilogue + cast) at out[idx + j], columns c + j < n;
// one vector store when `vec` (c and n multiples of 4, out aligned) and
// there is no epilogue.
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

// 4 raw fp32 sums at ws[idx + j], columns c + j < n (the softmax row
// phase's workspace, or a k split's partials); one vector store when
// `vec`.
__device__ __forceinline__ void store4(float* ws, long long idx, float4 v,
                                       int c, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(ws + idx) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) ws[idx + j] = at(v, j);
}

// The staging mode of one operand: s_k is its stride along k, s_o along
// its other axis.  Vector loads need that axis's unit stride, the other
// strides and the base pointer in whole 4-element steps.  The STT
// wrappers ask it on the host, the fused kernel once a stage on the card.
template <typename T>
__host__ __device__ int stage_mode(const void* p, long long sb, long long s_k,
                                   long long s_o) {
  const bool aligned =
      reinterpret_cast<unsigned long long>(p) % (4 * sizeof(T)) == 0 &&
      sb % 4 == 0;
  if (aligned && s_k == 1 && s_o % 4 == 0) return STAGE_K;
  if (aligned && s_o == 1 && s_k % 4 == 0) return STAGE_MN;
  return STAGE_SCALAR;
}

}  // namespace
