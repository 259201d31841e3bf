// Paged-cache gather for Hopper (sm_90a); replaces the reference's
// kernels/paged.py:paged_gather_pallas (_gather_kernel).
//
//   view[c, j*page:(j+1)*page, :] = pool[table[c, j], :, :]
//
// pool (P, page, F) and view (C, n*page, F) are contiguous; table (C, n)
// int32 lives in device memory.  The TPU kernel scalar-prefetches the
// table into its BlockSpec index maps and DMAs one page per grid step.
// Here each page is cut into runs of CHUNK bytes, and one CTA copies one
// run of one (slot, logical page): it reads its physical page id from the
// table itself.  Unmapped entries point at the pool's scratch page and
// are copied like any other page.
//
// What bounds it on the H100: bytes.  Nothing is computed; the distinct
// pages are read and the view written, each once, over 3.35 TB/s (at the
// h2o-danube-1.8b serve shape, 8 slots x 128 pages of 16 x 15360 bf16:
// 327 distinct pages, 160 MB read and 503 MB written, 0.198 ms).  The
// design keeps enough bytes in flight to cover device-memory latency:
// every thread issues UNROLL independent 16-byte loads before their
// stores (32 KB a CTA, 15 CTAs a danube page), neighbouring threads on
// neighbouring addresses.  Loads take the non-coherent path without L1
// allocation; stores are streaming (evict first), so the view, far larger
// than L2, does not push out the pages that several slots read.  When a
// page's byte size or a base address is not a multiple of 16, the bytes
// past the last whole vector (or the whole run) are copied one element at
// a time.  A pure copy: the output is bit-identical to the plain gather
// for every element type.  Hopper's bulk-copy engine (cp.async.bulk into
// a ring of shared-memory stages and back, one issuing thread a CTA) was
// measured too and ran about 6% slower at the serve shape on an H100
// (PERF.md).
//
// Launch contract: one launch, on the given stream; allocates nothing,
// and the entry point returns cudaGetLastError() right after the launch.
// A page id outside [0, P) traps, as the plain gather raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;                        // 16-byte loads in flight
constexpr long long CHUNK = THREADS * UNROLL * 16;   // bytes a CTA: 32 KB

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Words [0, n) of src to dst, n <= THREADS * UNROLL: all loads first.
__device__ __forceinline__ void copy_words(const uint4* src, uint4* dst,
                                           int n) {
  uint4 v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < n) v[k] = ld_stream(src + i);
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < n) __stcs(dst + i, v[k]);
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const char* pool, const int* table, char* out,
                  int n_pages_pool, long long page_bytes, int chunks) {
  const long long page = blockIdx.x / chunks;    // c * n + j
  const long long lo = (long long)(blockIdx.x % chunks) * CHUNK;
  const long long hi = min(lo + CHUNK, page_bytes);
  const int pid = table[page];
  if (pid < 0 || pid >= n_pages_pool) __trap();
  const char* src = pool + (long long)pid * page_bytes;
  char* dst = out + page * page_bytes;
  long long tail = lo;                           // the element path's start
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    tail = min(hi, page_bytes / 16 * 16);
    copy_words(reinterpret_cast<const uint4*>(src + lo),
               reinterpret_cast<uint4*>(dst + lo), (int)((tail - lo) / 16));
  }
  const E* s = reinterpret_cast<const E*>(src);
  E* d = reinterpret_cast<E*>(dst);
  for (long long i = tail / (long long)sizeof(E) + threadIdx.x;
       i < hi / (long long)sizeof(E); i += THREADS)
    d[i] = s[i];
}

template <typename E>
int launch(const void* pool, const void* table, void* out, int n_pages_pool,
           long long pages, long long page_bytes, cudaStream_t st) {
  const long long chunks = (page_bytes + CHUNK - 1) / CHUNK;
  if (pages * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  gather_kernel<E><<<(unsigned)(pages * chunks), THREADS, 0, st>>>(
      static_cast<const char*>(pool), static_cast<const int*>(table),
      static_cast<char*>(out), n_pages_pool, page_bytes, (int)chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes).  elt: the element size in bytes (1,
// 2, 4 or 8); page_elems = page * F.  Nothing is launched for an empty
// table.
extern "C" int paged_gather_launch(const void* pool, const void* table,
                                   void* out, int n_pages_pool, int c, int n,
                                   long long page_elems, int elt,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long page_bytes = page_elems * elt;
  const long long pages = (long long)c * n;
  if (pages == 0 || page_bytes == 0) return 0;
  switch (elt) {
    case 1: return launch<uint8_t>(pool, table, out, n_pages_pool, pages,
                                   page_bytes, st);
    case 2: return launch<uint16_t>(pool, table, out, n_pages_pool, pages,
                                    page_bytes, st);
    case 4: return launch<uint32_t>(pool, table, out, n_pages_pool, pages,
                                    page_bytes, st);
    case 8: return launch<uint64_t>(pool, table, out, n_pages_pool, pages,
                                    page_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
