// Block-sparse GEMM for Hopper (sm_90a); replaces the reference's
// kernels/bsr_gemm.py:bsr_matmul (_bsr_kernel).
//
//   C (m, n) = S (m, k) @ D (k, n),  S block-sparse with (bm, bk) blocks
//
// The TPU kernel walks a row-major block-COO list in one ordered grid and
// resets its VMEM accumulator whenever the block-row changes.  CTAs run in
// no order, so here the pattern arrives as CSR: row_ptr (n_block_rows + 1)
// and col_idx (nnz, ascending within a row), int32 arrays in device memory
// that the wrapper builds once per pattern.  S is read in place from the
// masked dense operand through its strides; only the nonzero blocks are
// ever loaded, so the TPU's gather of nonzero blocks into a packed array
// has no counterpart here.
//
// What bounds it on the H100: fp32 FLOPs on the nonzero blocks (CUDA
// cores, TF32 off) at the main path's shapes -- gemm 4096^3 at density
// 0.25 is 34.4 GFLOP, 0.513 ms at 67 TFLOP/s, against 151 MB of bytes
// (nonzero blocks, the dense operand and the output once: 0.045 ms).  The
// design (bsr_tile_kernel):
// - the SIMT tile mainloop of simt_tile.cuh, as the output-stationary
//   tile kernel runs it: a BM x BN CTA tile of 256 threads, float4
//   register fragments (fma_quads), both operands in swizzled SLAB_K-deep
//   slabs double-buffered through registers, one barrier a slab, 16-byte
//   (bf16: 8-byte) loads along each operand's unit-stride axis;
// - a CTA walks its block-row's nonzero blocks as one sequence of slabs,
//   cdiv(bk, SLAB_K) a block, each zero past its block's end: the next
//   slab's loads, of the next block where this one ends, are issued
//   before this slab's FMAs, so the pipeline does not drain at a block
//   boundary, and the next block's column is read one block ahead;
// - the host's plan (kernels/bsr_gemm.py:launch_plan) picks the tile --
//   128 x 128 where it divides bm and gives one wave of the card's 132
//   SMs, else 64 x 64 -- and the work order: a tile never straddles two
//   block-rows (cdiv(bm, BM) sub-tiles a block-row, rows past its end
//   masked), and (block-row, sub-tile) items run heaviest block-row
//   first, all n tiles of an item together, so that the last wave holds
//   the lightest rows;
// - a slab of a block starts at a block offset, so 16-byte loads along k
//   need bk % 4 == 0 and along S's rows bm % 4 == 0; the plan says which
//   hold, and other operands are staged element by element;
// - the sums are flushed straight from registers (no epilogue: the
//   pipeline applies it after the kernel).
// Each output keeps one fp32 accumulator from 0 that adds one fmaf a
// product in ascending k; padded slab entries add 0 * 0.  So at density
// 1.0 the result is bit-identical to the output-stationary tile kernel's
// (stt_gemm.cu) for any bk.  No split-k, no atomics.  A block-row without
// a nonzero block runs no slab and is written as zeros.
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.

#include "simt_tile.cuh"

namespace {

// CTA t of a 1-D grid owns n tile t % n_tiles of work item
// order[t / n_tiles] = block_row * subtiles + sub, rows brow * bm + sub *
// BM .. + BM of S (masked at the block-row's end).  S is viewed as (m, k),
// Dt as D's (n, k) transpose.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    bsr_tile_kernel(View<T> S, View<T> Dt, T* out, const int* row_ptr,
                    const int* col_idx, const int* order, int n, int bm,
                    int bk, int subtiles, int n_tiles, int s_mode,
                    int d_mode) {
  constexpr int TM = BM / 16, TN = BN / 16, QM = TM / 4, QN = TN / 4;
  constexpr int LDA = Slab<T, BM, true>::LD, LDB = Slab<T, BN, true>::LD;
  extern __shared__ __align__(16) float tsm[];
  float* As = tsm;                    // 2 x SLAB_K x LDA
  float* Bs = As + 2 * SLAB_K * LDA;  // 2 x SLAB_K x LDB
  const int tx = quad_tx(), ty = quad_ty();
  const int item = order[blockIdx.x / n_tiles];
  const int brow = item / subtiles;
  const int r0 = brow * bm + (item % subtiles) * BM;
  const int rend = brow * bm + bm;  // this block-row's last row + 1
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const bool vec = n % 4 == 0;      // output rows hold whole float4s
  const int e0 = row_ptr[brow];
  const int nblk = row_ptr[brow + 1] - e0;
  const int spb = cdiv(bk, SLAB_K);  // slabs a block
  const int nsl = nblk * spb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  if (nsl > 0) {
    Slab<T, BM, true> na;
    Slab<T, BN, true> nb;
    // the slab being loaded: block e (first k kb), slab j of the block;
    // the column of block e + 1 is read one block ahead
    int e = 0, j = 0;
    int kb = col_idx[e0] * bk;
    int kb_next = nblk > 1 ? col_idx[e0 + 1] * bk : 0;
    na.load(S, 0, r0, kb, rend, kb + bk, s_mode);
    nb.load(Dt, 0, n0, kb, n, kb + bk, d_mode);
    na.store(As, s_mode);
    nb.store(Bs, d_mode);
    __syncthreads();
    for (int s = 0; s < nsl; ++s) {
      const bool more = s + 1 < nsl;
      if (more) {
        if (++j == spb) {
          j = 0;
          ++e;
          kb = kb_next;
          if (e + 1 < nblk) kb_next = col_idx[e0 + e + 1] * bk;
        }
        const int kk = kb + j * SLAB_K;
        na.load(S, 0, r0, kk, rend, kb + bk, s_mode);
        nb.load(Dt, 0, n0, kk, n, kb + bk, d_mode);
      }
      fma_quads<BM, BN, TM, TN, LDB, true>(
          acc, As + (s & 1) * SLAB_K * LDA, Bs + (s & 1) * SLAB_K * LDB, ty,
          tx);
      if (more) {
        na.store(As + ((s + 1) & 1) * SLAB_K * LDA, s_mode);
        nb.store(Bs + ((s + 1) & 1) * SLAB_K * LDB, d_mode);
      }
      __syncthreads();
    }
  }
  const Epi epi{0};  // no epilogue
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + (i / 4) * (BM / QM) + 4 * ty + i % 4;
    if (r >= rend) continue;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int c = n0 + q * (BN / QN) + 4 * tx;
      if (c >= n) continue;
      const float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                   acc[i][4 * q + 2], acc[i][4 * q + 3]);
      flush4<T>(out, (long long)r * n + c, v, c, n, vec, epi);
    }
  }
}

// Opt the kernel into its dynamic shared memory once per instantiation,
// then launch one CTA a (work item, n tile).
template <typename T, int TILE>
int bsr_launch_t(View<T> S, View<T> D, void* out, const int* row_ptr,
                 const int* col_idx, const int* order, int m, int n, int bm,
                 int bk, int s_mode, int d_mode, cudaStream_t st) {
  static bool attr_set = false;
  constexpr int smem = 2 * SLAB_K *
                       (Slab<T, TILE, true>::LD + Slab<T, TILE, true>::LD) *
                       (int)sizeof(float);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsr_tile_kernel<T, TILE, TILE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int subtiles = cdiv(bm, TILE), n_tiles = cdiv(n, TILE);
  const long long ctas = (long long)(m / bm) * subtiles * n_tiles;
  if (ctas < 1 || ctas > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  bsr_tile_kernel<T, TILE, TILE><<<(unsigned)ctas, TILE_THREADS, smem, st>>>(
      S, transposed(D), static_cast<T*>(out), row_ptr, col_idx, order, n,
      bm, bk, subtiles, n_tiles, s_mode, d_mode);
  return (int)cudaGetLastError();
}

// The staging mode of each operand: stage_mode's test of the base pointer
// and the strides, and the plan's of the block offsets (k_vec: bk % 4 ==
// 0, every slab starts on a whole 4-element step along k; m_vec: bm % 4
// == 0, every block-row does along m).
template <typename T>
int bsr_dispatch(const void* s, long long s_sr, long long s_sc,
                 const void* d, long long d_sr, long long d_sc, void* out,
                 const void* row_ptr, const void* col_idx, const void* order,
                 int m, int n, int bm, int bk, int tile, int k_vec,
                 int m_vec, cudaStream_t st) {
  int s_mode = stage_mode<T>(s, 0, s_sc, s_sr);
  if ((s_mode == STAGE_K && !k_vec) || (s_mode == STAGE_MN && !m_vec))
    s_mode = STAGE_SCALAR;
  int d_mode = stage_mode<T>(d, 0, d_sr, d_sc);
  if (d_mode == STAGE_K && !k_vec) d_mode = STAGE_SCALAR;
  View<T> S = make_view<T>(s, 0, s_sr, s_sc);
  View<T> D = make_view<T>(d, 0, d_sr, d_sc);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  const int* od = static_cast<const int*>(order);
  if (tile == 128)
    return bsr_launch_t<T, 128>(S, D, out, rp, ci, od, m, n, bm, bk, s_mode,
                                d_mode, st);
  if (tile == 64)
    return bsr_launch_t<T, 64>(S, D, out, rp, ci, od, m, n, bm, bk, s_mode,
                               d_mode, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Strides in elements; row_ptr, col_idx and order (the plan's m / bm x
// cdiv(bm, tile) work items, heaviest block-row first) are int32 device
// arrays; tile is the plan's CTA tile edge, 128 or 64.
extern "C" int bsr_launch(int dtype, const void* s, long long s_sr,
                          long long s_sc, const void* d, long long d_sr,
                          long long d_sc, void* out, const void* row_ptr,
                          const void* col_idx, const void* order, int m,
                          int n, int bm, int bk, int tile, int k_vec,
                          int m_vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bsr_dispatch<float>(s, s_sr, s_sc, d, d_sr, d_sc, out, row_ptr,
                               col_idx, order, m, n, bm, bk, tile, k_vec,
                               m_vec, st);
  if (dtype == 1)
    return bsr_dispatch<__nv_bfloat16>(s, s_sr, s_sc, d, d_sr, d_sc, out,
                                       row_ptr, col_idx, order, m, n, bm, bk,
                                       tile, k_vec, m_vec, st);
  return (int)cudaErrorInvalidValue;
}
