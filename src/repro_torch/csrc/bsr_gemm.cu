// Block-sparse GEMM for Hopper (sm_90a); replaces the reference's
// kernels/bsr_gemm.py:bsr_matmul (_bsr_kernel).
//
//   C (m, n) = S (m, k) @ D (k, n),  S block-sparse with (bm, bk) blocks
//
// The TPU kernel walks a row-major block-COO list in one ordered grid and
// resets its VMEM accumulator whenever the block-row changes.  CTAs run in
// no order, so here the pattern arrives as CSR: row_ptr (n_block_rows + 1)
// and col_idx (nnz, ascending within a row), int32 arrays in device memory
// that the wrapper builds once per pattern.  One CTA owns one (block-row
// sub-tile, n tile): it walks its block-row's nonzero blocks in ascending
// k and keeps the fp32 sum in registers, so a block-row without a nonzero
// block is still written (zeros) and no output is left uninitialized.
// S is read in place from the masked dense operand through its strides;
// only the nonzero blocks are ever loaded, so the TPU's gather of nonzero
// blocks into a packed array has no counterpart here.
//
// Each output adds its products in ascending k with fma_slab (common.cuh),
// one fmaf at a time, as the output-stationary template does: at density
// 1.0 the result is bit-identical to that template's.
//
// What bounds it on the H100: fp32 FLOPs on the nonzero blocks (CUDA
// cores, TF32 off) at the main path's shapes -- gemm 4096^3 at density
// 0.25 is 34.4 GFLOP, 0.51 ms at 67 TFLOP/s, against 151 MB of bytes
// (nonzero blocks, the dense operand and the output once: 0.045 ms).  The design does nothing about the bound yet beyond not
// touching zero blocks: it is the SIMT 128x128 tile of the dense template
// (wgmma/TMA are later work).
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.

#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    bsr_kernel(View<T> S, View<T> D, T* out, const int* row_ptr,
               const int* col_idx, int m, int n, int bm, int bk,
               int subtiles) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK * BM];
  __shared__ float Bs[BK * BN];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int brow = blockIdx.y / subtiles;
  const int r0 = brow * bm + (blockIdx.y % subtiles) * BM;
  const int rend = min(m, brow * bm + bm);  // this block-row's last row + 1
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const int e_end = row_ptr[brow + 1];
  for (int e = row_ptr[brow]; e < e_end; ++e) {
    const int k0 = col_idx[e] * bk;
    const int kend = k0 + bk;
    for (int kk = k0; kk < kend; kk += BK) {
      load_tile<T, BM, BK, true, NT>(As, S, 0, r0, kk, rend, kend);
      load_tile<T, BK, BN, false, NT>(Bs, D, 0, kk, n0, kend, n);
      __syncthreads();
      fma_slab<BM, BN, BK, TM, TN>(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + ty + i * (BM / TM);
      const int c = n0 + tx + j * (BN / TN);
      if (r < rend && c < n) out[(long long)r * n + c] = from_f<T>(acc[i][j]);
    }
}

template <typename T, typename C>
int bsr_launch_t(View<T> S, View<T> D, void* out, const int* row_ptr,
                 const int* col_idx, int m, int n, int bm, int bk,
                 cudaStream_t st) {
  const int subtiles = cdiv(bm, C::BM);
  const dim3 g(cdiv(n, C::BN), cdiv(m, bm) * subtiles, 1);
  if (!grid_ok(g)) return (int)cudaErrorInvalidConfiguration;
  bsr_kernel<T, C::BM, C::BN, C::BK, C::TM, C::TN>
      <<<g, (C::BM / C::TM) * (C::BN / C::TN), 0, st>>>(
          S, D, static_cast<T*>(out), row_ptr, col_idx, m, n, bm, bk,
          subtiles);
  return (int)cudaGetLastError();
}

template <typename T>
int bsr_dispatch(const void* s, long long s_sr, long long s_sc,
                 const void* d, long long d_sr, long long d_sc, void* out,
                 const void* row_ptr, const void* col_idx, int m, int n,
                 int bm, int bk, cudaStream_t st) {
  View<T> S = make_view<T>(s, 0, s_sr, s_sc);
  View<T> D = make_view<T>(d, 0, d_sr, d_sc);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  // the dense template's tiles: skinny block-rows take the 8-row tile
  if (bm <= TileS::BM)
    return bsr_launch_t<T, TileS>(S, D, out, rp, ci, m, n, bm, bk, st);
  return bsr_launch_t<T, TileL>(S, D, out, rp, ci, m, n, bm, bk, st);
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Strides in elements; row_ptr/col_idx are int32 device arrays.
extern "C" int bsr_launch(int dtype, const void* s, long long s_sr,
                          long long s_sc, const void* d, long long d_sr,
                          long long d_sc, void* out, const void* row_ptr,
                          const void* col_idx, int m, int n, int bm, int bk,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bsr_dispatch<float>(s, s_sr, s_sc, d, d_sr, d_sc, out, row_ptr,
                               col_idx, m, n, bm, bk, st);
  if (dtype == 1)
    return bsr_dispatch<__nv_bfloat16>(s, s_sr, s_sc, d, d_sr, d_sc, out,
                                       row_ptr, col_idx, m, n, bm, bk, st);
  return (int)cudaErrorInvalidValue;
}
