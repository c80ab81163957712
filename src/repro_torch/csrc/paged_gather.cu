// Block-table page gather on Hopper.
//
// Replaces: repro/kernels/paged_gather.py::paged_gather (Pallas, TPU),
// used by the gather attention backend (attention._gather_pages).
//
//   out[b, i] = pool[bt[b, i]]      pool [P, page, E], out [B, n, page, E]
//
// Bound on the H100: bytes.  A pure copy: every gathered page is read
// once and written once, 2 * B*n*page*E*itemsize / 3.35 TB/s.
//
// Design: one CTA per gathered page (b, i) loads its own page id (the
// TPU kernel's scalar-prefetched block table) and copies the page as
// raw bytes, so any pool dtype works.  When the page size is a multiple
// of 16 bytes each thread moves 16-byte vectors (one uint4) with
// neighbouring threads on neighbouring addresses; otherwise bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_vec16(const uint4* __restrict__ pool, const int* __restrict__ bt,
             uint4* __restrict__ out, long long vecs_per_page) {
  const long long row = blockIdx.x;
  const uint4* src = pool + (long long)bt[row] * vecs_per_page;
  uint4* dst = out + row * vecs_per_page;
  for (long long v = threadIdx.x; v < vecs_per_page; v += kThreads)
    dst[v] = src[v];
}

__global__ void __launch_bounds__(kThreads)
gather_bytes(const unsigned char* __restrict__ pool, const int* __restrict__ bt,
             unsigned char* __restrict__ out, long long page_bytes) {
  const long long row = blockIdx.x;
  const unsigned char* src = pool + (long long)bt[row] * page_bytes;
  unsigned char* dst = out + row * page_bytes;
  for (long long v = threadIdx.x; v < page_bytes; v += kThreads)
    dst[v] = src[v];
}

}  // namespace

// pool [P, page_bytes] bytes, bt [rows] int32 (pre-clipped to [0, P)),
// out [rows, page_bytes] bytes.
extern "C" int paged_gather(const void* pool, const void* bt, void* out,
                            int rows, long long page_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      page_bytes % 16 == 0 &&
      reinterpret_cast<unsigned long long>(pool) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(out) % 16 == 0;
  if (aligned)
    gather_vec16<<<rows, kThreads, 0, st>>>(
        static_cast<const uint4*>(pool), static_cast<const int*>(bt),
        static_cast<uint4*>(out), page_bytes / 16);
  else
    gather_bytes<<<rows, kThreads, 0, st>>>(
        static_cast<const unsigned char*>(pool), static_cast<const int*>(bt),
        static_cast<unsigned char*>(out), page_bytes);
  return static_cast<int>(cudaGetLastError());
}
