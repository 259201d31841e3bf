// Paged-cache gather for Hopper (sm_90a); replaces the reference's
// kernels/paged.py:paged_gather_pallas (_gather_kernel).
//
//   view[c, j*page:(j+1)*page, :] = pool[table[c, j], :, :]
//
// pool (P, page, F) and view (C, n*page, F) are contiguous; table (C, n)
// int32 lives in device memory.  The TPU kernel scalar-prefetches the
// table into its BlockSpec index maps and DMAs one page per grid step.
// Here one CTA owns one (slot, logical page): it reads its physical page
// id from the table itself and copies the page, which is one contiguous
// block of page*F elements on both sides.  Unmapped entries point at the
// pool's scratch page and are copied like any other page.
//
// What bounds it on the H100: bytes.  Nothing is computed; every byte is
// read once and written once, 2 * C*n*page*F*elt over 3.35 TB/s (at the
// h2o-danube-1.8b serve shape, 8 slots x 128 pages of 16 x 15360 bf16:
// 0.5 GB each way per leaf).  The design answers with 16-byte vector
// loads and stores, neighbouring threads on neighbouring addresses, and
// enough CTAs (one per page) to keep every SM's loads in flight.  When a
// page's byte size or a base address is not a multiple of 16, the bytes
// past the last whole vector (or the whole page) are copied one element
// at a time.  A pure copy: the output is bit-identical to the plain
// gather for every element type.
//
// Launch contract: runs on the given stream, allocates nothing, and the
// entry point returns cudaGetLastError() right after the launch.  A page
// id outside [0, P) traps, as the plain gather raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename W>
__device__ __forceinline__ void copy_words(const char* src, char* dst,
                                           long long n_words) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (long long i = threadIdx.x; i < n_words; i += THREADS) d[i] = s[i];
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const char* pool, const int* table, char* out,
                  int n_pages_pool, int n, long long page_bytes) {
  const int j = blockIdx.x, c = blockIdx.y;
  const int pid = table[(long long)c * n + j];
  if (pid < 0 || pid >= n_pages_pool) __trap();
  const char* src = pool + (long long)pid * page_bytes;
  char* dst = out + ((long long)c * n + j) * page_bytes;
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    head = page_bytes / 16 * 16;
    copy_words<uint4>(src, dst, head / 16);
  }
  copy_words<E>(src + head, dst + head, (page_bytes - head) / sizeof(E));
}

template <typename E>
int launch(const void* pool, const void* table, void* out, int n_pages_pool,
           int c, int n, long long page_bytes, cudaStream_t st) {
  if (c > 65535) return (int)cudaErrorInvalidConfiguration;  // grid.y
  gather_kernel<E><<<dim3(n, c), THREADS, 0, st>>>(
      static_cast<const char*>(pool), static_cast<const int*>(table),
      static_cast<char*>(out), n_pages_pool, n, page_bytes);
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
  if (c == 0 || n == 0 || page_bytes == 0) return 0;
  switch (elt) {
    case 1: return launch<uint8_t>(pool, table, out, n_pages_pool, c, n,
                                   page_bytes, st);
    case 2: return launch<uint16_t>(pool, table, out, n_pages_pool, c, n,
                                    page_bytes, st);
    case 4: return launch<uint32_t>(pool, table, out, n_pages_pool, c, n,
                                    page_bytes, st);
    case 8: return launch<uint64_t>(pool, table, out, n_pages_pool, c, n,
                                    page_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
