// GRIFFIN eq. 6 statistic on Hopper.
//
// Replaces: repro/kernels/expert_stat.py::expert_stat (Pallas, TPU),
// the function the reference model computes in ffn.griffin_stat_sq.
//
//   s_sq[b, j] = sum_t z[b,t,j]^2 * inv[b,t],  inv = 1/||z[b,t]||^2 (0 if 0)
//
// Bound on the H100: bytes.  The work is 3 flops per element read once,
// far below the ~20 flop/byte an fp32 pass needs to leave the memory
// bound, so the least time is B*S*F*itemsize / 3.35 TB/s.  At a prefill
// chunk ([1, 32, 11008] bf16, 704 KB) that is 0.2 us, so a call is bound
// by latency: one launch, and z's rows in flight at once.
//
// Design: one launch, z read once, no scratch and no atomics (s_sq feeds
// a top-k, so its sum order must not change from run to run).
// * Each b is one thread block cluster of `cluster` CTAs (at most 8, the
//   portable size); CTA r owns columns [r * vpc, (r + 1) * vpc) * VEC of
//   F, one VEC-wide vector per thread (16 bytes where the row and the
//   pointer allow it: 8 bf16 or 4 fp32; narrower otherwise).
// * The cluster walks S in tiles of kRows rows inside the launch (the
//   TPU kernel's token grid axis).  Per tile each thread loads its vector
//   of all kRows rows into registers at once (kRows independent loads in
//   flight), reduces its squared partial row norms in a fixed tree (warp
//   shuffles, then warps in order) and writes them into its slot of every
//   CTA's shared memory (distributed shared memory); after one cluster
//   barrier each CTA sums its own copy of the cluster's partials of each
//   row in rank order, so every CTA holds the same inv bit for bit.  Then
//   it adds v^2 * inv[t] into its columns' registers in row order.  The
//   slots are double-buffered by tile, so one cluster barrier per tile
//   suffices (a CTA cannot write a buffer again before every CTA has
//   passed the next tile's barrier, which follows its reads), and since no
//   CTA reads another's shared memory, none waits for the others at the
//   end: pushing the partials instead of pulling them saves the trailing
//   cluster barrier that keeps a CTA alive for its readers.
// * A slice wider than the CTA (more than 256 vectors) takes more
//   vectors per thread: the first stays in registers, the others are read
//   again from L2 for the column sums, and their running sums go through
//   the output row, which only that thread touches.  Same sum order.
//
// Tensor parallelism (the reference's ffn.griffin_stat_sq under a TP
// axis: `row = psum_if_tp(row)` before 1/row) splits F across ranks, so a
// rank's row norm is a partial sum that must be all-reduced before any
// column is normalized.  Two more entry points split the launch there:
// * expert_stat_row_sq: the same kernel up to the row norms (same plan,
//   same fixed reduction order); CTA 0 of the cluster writes row_sq[b, t]
//   and no column is summed.  Nothing carries from one row tile to the
//   next, so each cluster takes one (b, tile): B * ceil(S / 32) clusters
//   in flight instead of B.  Bound: bytes, B*S*F*itemsize read.
// * expert_stat_from_norm: the column sums from a given (all-reduced)
//   row_sq, with the reference's `row > 0` guard.  No row norm is formed
//   and no cluster is needed: each CTA of the grid owns its column slice
//   alone.  Bound: bytes, z read once plus B*S*4 + B*F*4.
// The caller all-reduces row_sq between the two launches.  Without TP the
// single launch above runs, unchanged.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;         // rows of z per tile (a prefill chunk)
constexpr int kMaxThreads = 256;  // threads of a CTA (a slice of <= 256 vectors)
constexpr int kMaxCluster = 8;    // portable thread block cluster size

// VEC consecutive elements of a row, as raw 32-bit words
template <typename T, int VEC>
struct Pack {
  static constexpr int kBytes = VEC * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (kBytes == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  // element i as fp32 (bf16 -> fp32 is a 16-bit shift: exact)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const uint32_t word = w[i / 2];
      return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
    }
  }
};

// what one launch computes
enum Mode : int {
  kFull = 0,      // s_sq from z alone (row norms merged in the cluster)
  kRowSq = 1,     // the row norms only: row_sq [B, S]
  kFromNorm = 2,  // s_sq from z and a given row_sq [B, S]
};

template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
expert_stat_kernel(const T* __restrict__ z,       // [B, S, F]
                   float* __restrict__ out,       // [B, F] (kFull, kFromNorm)
                   float* __restrict__ row_sq,    // [B, S] (kRowSq: out; kFromNorm: in)
                   int S, int F, int vpc) {
  namespace cg = cooperative_groups;
  __shared__ float warp_part[kMaxThreads / 32][kRows];
  // every CTA's partial row norms, pushed here by their owners; by tile
  // parity
  __shared__ float part[2][kMaxCluster][kRows];
  __shared__ float inv[kRows];
  // the CTAs of a cluster may start at different times: remote shared
  // memory is written only after every CTA has arrived here
  if constexpr (MODE != kFromNorm)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int n_cta = gridDim.x, rank = blockIdx.x;  // the grid's x is one cluster
  const int n_tiles = (S + kRows - 1) / kRows;
  // kRowSq carries nothing from one tile to the next: each cluster takes
  // one (b, tile); the others walk all of b's tiles
  const int b = MODE == kRowSq ? blockIdx.y / n_tiles : blockIdx.y;
  const int t_begin = MODE == kRowSq ? blockIdx.y % n_tiles : 0;
  const int t_end = MODE == kRowSq ? t_begin + 1 : n_tiles;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_warps = blockDim.x / 32;
  const int n_vec = F / VEC;
  const int v_hi = min(n_vec, (rank + 1) * vpc);
  const int v0 = rank * vpc + tid;  // this thread's first vector
  const bool own0 = v0 < v_hi;
  const T* zb = z + (long long)b * S * F;
  float* ob = MODE == kRowSq ? nullptr : out + (long long)b * F;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int t0 = tile * kRows;
    const int nt = min(kRows, S - t0);
    const T* zt = zb + (long long)t0 * F;

    // -- the first vector of every row of the tile, all loads in flight
    Pack<T, VEC> keep[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (own0 && t < nt)
        keep[t].load(zt + (long long)t * F + (long long)v0 * VEC);
      else
        keep[t].zero();
    }
    if constexpr (MODE == kFromNorm) {
      // the all-reduced row norms, guarded as the reference's
      // `where(row > 0, 1/row, 0)`; the previous tile's readers of inv
      // have passed the barrier first
      __syncthreads();
      if (tid < kRows) {
        const float r = tid < nt ? row_sq[(long long)b * S + t0 + tid] : 0.f;
        inv[tid] = r > 0.f ? 1.f / r : 0.f;
      }
      __syncthreads();
    } else {
    float rowp[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = keep[t].get(k);
        s += v * v;
      }
      rowp[t] = s;
    }
    // -- further vectors of a wide slice (read again below, from L2)
    for (int v = v0 + blockDim.x; v < v_hi; v += blockDim.x) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {  // unrolled: rowp stays in registers
        if (t < nt) {
          Pack<T, VEC> p;
          p.load(zt + (long long)t * F + (long long)v * VEC);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float x = p.get(k);
            rowp[t] += x * x;
          }
        }
      }
    }

    // -- partial row norms of this CTA: lanes, then warps, in a fixed tree
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rowp[t] += __shfl_xor_sync(0xffffffffu, rowp[t], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) warp_part[warp][t] = rowp[t];
    }
    __syncthreads();
    if (tile == t_begin) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // -- this CTA's partials, written into slot `rank` of every CTA of the
    //    cluster; after the barrier each CTA sums its own copy in rank order
    if (tid < kRows) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += warp_part[w][tid];
      for (int r = 0; r < n_cta; ++r)
        cg::this_cluster().map_shared_rank(&part[tile & 1][rank][0], r)[tid] = s;
    }
    cg::this_cluster().sync();
    if (tid < kRows) {
      float total = 0.f;
      for (int r = 0; r < n_cta; ++r) total += part[tile & 1][r][tid];
      if constexpr (MODE == kRowSq) {
        if (rank == 0 && tid < nt) row_sq[(long long)b * S + t0 + tid] = total;
      } else {
        inv[tid] = total > 0.f ? 1.f / total : 0.f;
      }
    }
    if constexpr (MODE == kRowSq) continue;  // no column is summed
    __syncthreads();
    }  // MODE != kFromNorm

    // -- column sums, rows in order (rows past S hold zeros: they add 0)
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const float it = inv[t];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = keep[t].get(k);
        acc[k] += (v * v) * it;
      }
    }
    for (int v = v0 + blockDim.x; v < v_hi; v += blockDim.x) {
      float* o = ob + (long long)v * VEC;
      float a[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = tile == 0 ? 0.f : o[k];
      for (int t = 0; t < nt; ++t) {
        Pack<T, VEC> p;
        p.load(zt + (long long)t * F + (long long)v * VEC);
        const float it = inv[t];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float x = p.get(k);
          a[k] += (x * x) * it;
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = a[k];
    }
  }

  if (MODE != kRowSq && own0) {
    float* o = ob + (long long)v0 * VEC;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        *reinterpret_cast<float4*>(o + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = acc[k];
    }
  }
}

template <typename T, int VEC, int MODE>
cudaError_t launch(const void* z, void* out, void* row_sq, int B, int S, int F,
                   int cluster, int threads, cudaStream_t stream) {
  const int n_vec = F / VEC;
  const int vpc = (n_vec + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  // kRowSq: one cluster per (b, row tile)
  cfg.gridDim = dim3(cluster, MODE == kRowSq ? B * ((S + kRows - 1) / kRows) : B);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  // kFromNorm shares no shared memory: its CTAs need not be co-scheduled
  cfg.numAttrs = MODE == kFromNorm ? 0 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, expert_stat_kernel<T, VEC, MODE>,
                                     static_cast<const T*>(z),
                                     static_cast<float*>(out),
                                     static_cast<float*>(row_sq), S, F, vpc);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MODE>
int dispatch(const void* z, void* out, void* row_sq, int B, int S, int F,
             int vec, int cluster, int threads, int z_is_bf16, void* stream) {
  const int isz = z_is_bf16 ? 2 : 4;
  const bool ok = B > 0 && S > 0 && F > 0 && vec > 0 && F % vec == 0 &&
                  vec * isz <= 16 && (vec & (vec - 1)) == 0 &&
                  reinterpret_cast<unsigned long long>(z) % (vec * isz) == 0 &&
                  cluster >= 1 && cluster <= kMaxCluster && threads >= 32 &&
                  threads <= kMaxThreads && threads % 32 == 0 &&
                  // the grid's y (kRowSq: one cluster per b and row tile)
                  (MODE == kRowSq ? (long long)B * ((S + kRows - 1) / kRows) : B) <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (z_is_bf16) {
    switch (vec) {
      case 8: e = launch<__nv_bfloat16, 8, MODE>(z, out, row_sq, B, S, F, cluster, threads, st); break;
      case 4: e = launch<__nv_bfloat16, 4, MODE>(z, out, row_sq, B, S, F, cluster, threads, st); break;
      case 2: e = launch<__nv_bfloat16, 2, MODE>(z, out, row_sq, B, S, F, cluster, threads, st); break;
      default: e = launch<__nv_bfloat16, 1, MODE>(z, out, row_sq, B, S, F, cluster, threads, st);
    }
  } else {
    switch (vec) {
      case 4: e = launch<float, 4, MODE>(z, out, row_sq, B, S, F, cluster, threads, st); break;
      case 2: e = launch<float, 2, MODE>(z, out, row_sq, B, S, F, cluster, threads, st); break;
      default: e = launch<float, 1, MODE>(z, out, row_sq, B, S, F, cluster, threads, st);
    }
  }
  return static_cast<int>(e);
}

}  // namespace

// z [B, S, F] fp32 or bf16, out [B, F] fp32.  The caller sizes the launch
// (kernels/expert_stat.py::stat_plan): vec elements per vector (a power
// of two dividing F whose bytes divide z's address, at most 16 bytes),
// cluster CTAs per b (1..8), threads per CTA (a multiple of 32, <= 256).
extern "C" int expert_stat(const void* z, void* out, int B, int S, int F,
                           int vec, int cluster, int threads, int z_is_bf16,
                           void* stream) {
  return dispatch<kFull>(z, out, nullptr, B, S, F, vec, cluster, threads,
                         z_is_bf16, stream);
}

// The two steps of the statistic under tensor parallelism, with the same
// plan: row_sq [B, S] fp32 out (this rank's partial row norms) ...
extern "C" int expert_stat_row_sq(const void* z, void* row_sq, int B, int S,
                                  int F, int vec, int cluster, int threads,
                                  int z_is_bf16, void* stream) {
  return dispatch<kRowSq>(z, nullptr, row_sq, B, S, F, vec, cluster, threads,
                          z_is_bf16, stream);
}

// ... and, once they are all-reduced, out [B, F] fp32 from row_sq [B, S].
extern "C" int expert_stat_from_norm(const void* z, const void* row_sq,
                                     void* out, int B, int S, int F, int vec,
                                     int cluster, int threads, int z_is_bf16,
                                     void* stream) {
  return dispatch<kFromNorm>(z, out, const_cast<void*>(row_sq), B, S, F, vec,
                             cluster, threads, z_is_bf16, stream);
}
