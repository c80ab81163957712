// Block-table page gather on Hopper.
//
// Replaces: repro/kernels/paged_gather.py::paged_gather (Pallas, TPU),
// used by the gather attention backend (attention._gather_pages).
//
//   out[b, i] = pool[max(bt[b, i], 0)]   pool [P, page, E], out [B, n, page, E]
//
// Bound on the H100: bytes.  A pure copy: every distinct gathered page is
// read once and every output page written once, over 3.35 TB/s.  At the
// sizes the gather backend runs (a few MB) the copy is bound by latency:
// the launch and the DRAM round trips a thread waits for.
//
// Design: a flat grid over the output, one 16-byte vector (uint4) a
// thread when the page size and both base addresses are 16-byte
// multiples, so neighbouring threads move neighbouring vectors and a
// Yi-9B gather of 128 pages runs 256 CTAs of 512 threads, ~2 per SM, with
// every load in flight at once.  (Two, four or eight vectors a thread,
// loads issued before stores, and 128-1024 threads a CTA were no faster
// on the H100.)  Each vector finds its page id
// in the table itself and clips a negative (unallocated) entry to page 0,
// as the plain version does, so one call is one launch.  Other page
// sizes take a byte path of the same shape.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_flat(const V* __restrict__ pool, const int* __restrict__ bt,
            V* __restrict__ out, long long per_page, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // 32-bit division where the output's vectors fit (every real case)
  const long long row = total <= 0x7fffffffLL
      ? (long long)((unsigned)i / (unsigned)per_page) : i / per_page;
  const int pid = max(bt[row], 0);
  out[i] = pool[(long long)pid * per_page + (i - row * per_page)];
}

template <typename V>
cudaError_t launch(const void* pool, const void* bt, void* out, long long rows,
                   long long per_page, cudaStream_t st) {
  const long long total = rows * per_page;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  gather_flat<V><<<blocks, kThreads, 0, st>>>(
      static_cast<const V*>(pool), static_cast<const int*>(bt),
      static_cast<V*>(out), per_page, total);
  return cudaGetLastError();
}

}  // namespace

// pool [P, page_bytes] bytes, bt [rows] int32 (negative entries read page
// 0), out [rows, page_bytes] bytes.
extern "C" int paged_gather(const void* pool, const void* bt, void* out,
                            int rows, long long page_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      page_bytes % 16 == 0 &&
      reinterpret_cast<unsigned long long>(pool) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(out) % 16 == 0;
  cudaError_t e = aligned
      ? launch<uint4>(pool, bt, out, rows, page_bytes / 16, st)
      : launch<unsigned char>(pool, bt, out, rows, page_bytes, st);
  return static_cast<int>(e);
}
