// Dense GLU FF forward on Hopper:
//   y = (act(x . Wg) * (x . W1)) . W2,  fp32 out,
// x [M, D], Wg/W1 [D, F], W2 [F, D].
//
// Replaces: repro/kernels/glu_ffn.py::glu_ffn / _kernel (Pallas, TPU),
// entry point ops.glu_ffn_forward.  Unlike the TPU kernel it takes any M,
// D and F (no F % 512 tile rule: Yi-9B's F = 11008 is not a multiple of
// 512).
//
// Bound on the H100: bytes.  At a prefill chunk of M = 32 rows the three
// weight matrices (3 * D * F * itemsize, 270 MB at Yi-9B width in bf16)
// take 81 us at 3.35 TB/s, against 9 us for the operations (6 * M * D * F)
// at the bf16 tensor-core rate.  So the kernel has to keep the weights
// streaming at the memory rate from every SM, and do its products on the
// tensor cores fast enough to stay behind the loads.
//
// Design: two launches, no library call, no scratch besides z.
// * Both passes are one tiled loop: a CTA of 4 warps owns an output tile
//   [MT rows, BN = 128 columns] over one range of the K rows, and tiles of
//   the A operand (x or z) and of the weights stream through a ring of
//   kStages stages.  bf16 weights whose rows and addresses are 16-byte
//   aligned come by TMA: per stage one thread issues [BK, 64] boxes of a
//   tensor map (128-byte swizzled, the tensor's edges zero-filled by the
//   copy engine) that complete on the stage's mbarrier.  Everything else
//   (the A tiles, fp32 and unaligned weights) is cp.async, 16-byte copies
//   where the rows and pointers allow, narrower otherwise, ragged edges
//   zero-filled in shared memory.
// * The K rows of a column tile are cut into ranges (at most 8) that run
//   as one thread block cluster; each CTA leaves its fp32 partials in
//   shared memory and, after a cluster barrier, rank r sums the float4
//   groups r, r + splits, ... over every rank in rank order (distributed
//   shared memory), so the sum order is fixed and no partial goes through
//   device memory.  The up pass (z = act(x . Wg) * (x . W1)) merges g and
//   h before the activation; the down pass (y = z . W2) merges y.
//   kernels/glu_ffn.py::glu_plan sizes the ranges so that every CTA of a
//   pass is resident at once at 3 CTAs per SM: at Yi-9B width 86 column
//   tiles x 4 ranges for the up pass, 32 x 8 for the down pass.
// * What shaped the tiles, from timing variants on the H100: whole
//   residency mattered most (a ring of 3 stages, ~60 KB, lets 3 CTAs
//   share an SM; deeper rings that cost residency or a second wave were
//   slower); 256-byte runs of a weight row (BN = 128, with the K split to
//   keep the CTA count) beat 128-byte runs; TMA boxes beat cp.async for
//   the weights, while 1-D bulk copies of single rows were slower than
//   either.
// * bf16: mma.sync.m16n8k16 with fp32 accumulators; x and z tiles come
//   through ldmatrix (rows padded by 16 bytes), the [k][n] weight tiles
//   through ldmatrix.trans (the swizzle, or the padding, keeps both free
//   of bank conflicts).  z = act(g) * h is rounded to bf16 before the
//   second product, as the TPU kernel rounds before its second dot.
// * fp32: tensor cores would mean TF32 (~3 digits), outside the 1e-4
//   tolerance at K = 4096, so the same tiles and ring feed exact fp32 FMA
//   (a thread owns 4 columns of several rows).
// * Bits are the same from run to run: every sum has a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"

namespace {

using griffin::cp_async;
using griffin::cp_async_commit;
using griffin::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;       // ring depth
constexpr int kPad = 16;         // bytes after each staged row
constexpr int kUpN = 128;        // z columns of an up-pass CTA
constexpr int kUpKBytes = 64;    // bytes of an x row per up-pass k tile
constexpr int kDownN = 128;      // y columns of a down-pass CTA
constexpr int kDownKBytes = 128; // bytes of a z row per down-pass k tile
constexpr int kMaxSplits = 8;    // portable thread block cluster size

// rows of x (and z) one CTA takes: 32 for a prefill chunk, 64 above
inline int row_tile(int M) { return M <= 32 ? 32 : 64; }

// shared memory of one pass: kStages stages of NB B tiles [BK, BN] and an
// A tile [MT, BK], BK = KB bytes of an A row; the same memory then holds
// the fp32 partials [NB][MT][BN + 4] that the cluster merges.  A B tile is
// rows padded by kPad bytes (cp.async), or with TMA boxes of [BK, 64]
// bf16 (128-byte rows, 128-byte swizzled, each 1024-byte aligned).
template <typename T, int MT, int BN, int NB, int KB, bool TMA>
struct Tiles {
  static constexpr int BK = KB / (int)sizeof(T);
  static constexpr int a_pitch = KB + kPad;  // bytes
  static constexpr int b_pitch = TMA ? 128 : BN * (int)sizeof(T) + kPad;
  static constexpr int box_bytes = BK * 128;
  static constexpr int a_bytes = MT * a_pitch;
  static constexpr int b_bytes = TMA ? BN * (int)sizeof(T) / 128 * box_bytes : BK * b_pitch;
  static constexpr int a_off = NB * b_bytes;
  static constexpr int align = TMA ? 1024 : 16;
  static constexpr int stage = (a_off + a_bytes + align - 1) / align * align;
  static constexpr int part_pitch = BN + 4;  // floats
  static constexpr int part_bytes = NB * MT * part_pitch * 4;
  static constexpr int smem =
      (kStages * stage > part_bytes ? kStages * stage : part_bytes) + align;
};

// Stage rows [0, R) x elements [0, W) of a tile: row r from src + r * ld.
// Rows >= rows_valid and elements >= cols_valid are zero.  cp bytes per
// copy divide every row and the address, so a copy is wholly in or out;
// 2 (an odd bf16 row) is a plain load and store.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, int pitch,
                                           const T* src, long long ld, int R,
                                           int W, int rows_valid,
                                           int cols_valid, int cp) {
  const int per = cp / (int)sizeof(T);
  const int sh = __ffs(W / per) - 1;  // copies per row: a power of two
  const int n = R << sh;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i >> sh, e = (i & ((1 << sh) - 1)) * per;
    unsigned char* d = dst + r * pitch + e * (int)sizeof(T);
    if (r < rows_valid && e < cols_valid) {
      const T* s = src + r * ld + e;
      if (cp >= 4)
        cp_async(d, s, cp);
      else
        *reinterpret_cast<unsigned short*>(d) = *reinterpret_cast<const unsigned short*>(s);
    } else if (cp == 16) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (cp == 8) {
      *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else if (cp == 4) {
      *reinterpret_cast<uint32_t*>(d) = 0u;
    } else {
      *reinterpret_cast<unsigned short*>(d) = 0;
    }
  }
}

// The products of one k tile, fp32: exact FMA.  Thread t owns columns
// 4 * (t % CG) .. +3 of rows (t / CG) * RPT .. +RPT-1.
template <typename T, int MT, int BN, int NB, int KB, bool TMA>
struct Engine {
  using L = Tiles<T, MT, BN, NB, KB, false>;
  static constexpr int CG = BN / 4, RG = kThreads / CG, RPT = MT / RG;
  float acc[NB][RPT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
  }

  __device__ __forceinline__ void compute(const unsigned char* sa,
                                          const unsigned char* sb) {
    const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
#pragma unroll 2
    for (int k = 0; k < L::BK; k += 4) {
      float4 a4[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a4[i] = *reinterpret_cast<const float4*>(sa + (rg * RPT + i) * L::a_pitch + k * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 w = *reinterpret_cast<const float4*>(
              sb + b * L::b_bytes + (k + kk) * L::b_pitch + cg * 16);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
            acc[b][i][0] += a * w.x;
            acc[b][i][1] += a * w.y;
            acc[b][i][2] += a * w.z;
            acc[b][i][3] += a * w.w;
          }
        }
      }
    }
  }

  // f(row, column, value of each B matrix) for every accumulator
  template <class Fn>
  __device__ __forceinline__ void for_each(Fn f) const {
    const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) v[b] = acc[b][i][j];
        f(rg * RPT + i, cg * 4 + j, v);
      }
  }
};

// The products of one k tile, bf16: mma.sync.m16n8k16 (fp32 sums).  Warp
// w owns columns [w * WN, (w + 1) * WN) of all MT rows.
template <int MT, int BN, int NB, int KB, bool TMA>
struct Engine<__nv_bfloat16, MT, BN, NB, KB, TMA> {
  using L = Tiles<__nv_bfloat16, MT, BN, NB, KB, TMA>;
  static constexpr int MI = MT / 16, WN = BN / kWarps, NT = WN / 8;
  float acc[NB][MI][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][mi][nt][e] = 0.f;
  }

  __device__ __forceinline__ void compute(const unsigned char* sa,
                                          const unsigned char* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_col = warp * WN + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < L::BK / 16; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        griffin::ldsm_x4(af[mi], sa + (mi * 16 + a_row) * L::a_pitch + (ks * 16 + a_col) * 2);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          const int k = ks * 16 + b_row, n = b_col + np * 16;
          if constexpr (TMA)  // box n / 64, 16-byte chunk (n % 64) / 8 xor k % 8
            griffin::ldsm_x4_t(bf, sb + b * L::b_bytes + (n / 64) * L::box_bytes + k * 128 +
                                       ((((n % 64) / 8) ^ (k & 7)) * 16));
          else
            griffin::ldsm_x4_t(bf, sb + b * L::b_bytes + k * L::b_pitch + n * 2);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            griffin::mma_bf16(acc[b][mi][2 * np], af[mi], bf[0], bf[1]);
            griffin::mma_bf16(acc[b][mi][2 * np + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }

  template <class Fn>
  __device__ __forceinline__ void for_each(Fn f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) v[b] = acc[b][mi][nt][e];
          f(mi * 16 + (lane >> 2) + (e >> 1) * 8,
            warp * WN + nt * 8 + (lane & 3) * 2 + (e & 1), v);
        }
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the mbarrier of a ring stage: armed by one thread with the bytes its
// TMA boxes will bring, complete when they have all landed
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity) : "memory");
}

// a [rows, 64] bf16 box at (column c0, row c1) of a tensor map, by the
// copy engine; rows and columns outside the tensor land as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}

// eng += A[MT, K] . B_b[K, BN] for each b: A row r at a + r * lda (rows >=
// a_rows zero), B_b row k at b[b] + k * ldb (columns >= b_cols zero), K
// walked in BK tiles through the ring.  With TMA the B tiles come instead
// as boxes of maps[b] at columns n0.., rows k_base.. (the tensor's edges
// zero-filled by the copy engine; a range's rows end at a k tile or at
// the tensor's end), completing on a per-stage mbarrier; the A tile is
// always cp.async.  Leaves the ring drained, so the caller may reuse
// shared memory.
template <typename T, int MT, int BN, int NB, int KB, bool TMA>
__device__ __forceinline__ void mainloop(unsigned char* smem, const T* a,
                                         long long lda, int a_rows,
                                         const T* const (&b)[NB], long long ldb,
                                         int b_cols, int K, int cp_a, int cp_b,
                                         const CUtensorMap* const (&maps)[NB],
                                         int n0, int k_base,
                                         Engine<T, MT, BN, NB, KB, TMA>& eng) {
  using L = Tiles<T, MT, BN, NB, KB, TMA>;
  __shared__ uint64_t bars[kStages];
  const int nk = (K + L::BK - 1) / L::BK;
  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int kt) {
    unsigned char* st = smem + (kt % kStages) * L::stage;
    const int k0 = kt * L::BK;
    stage_tile<T>(st + L::a_off, L::a_pitch, a + k0, lda, MT, L::BK, a_rows, K - k0, cp_a);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[kt % kStages];
        // the warps' reads of this stage come before the copy engine's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(bar, NB * L::b_bytes);
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int h = 0; h < BN * (int)sizeof(T) / 128; ++h)
            tma_box(st + i * L::b_bytes + h * L::box_bytes, maps[i], n0 + h * 64,
                    k_base + k0, bar);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        stage_tile<T>(st + i * L::b_bytes, L::b_pitch, b[i] + k0 * ldb, ldb, L::BK, BN,
                      K - k0, b_cols, cp_b);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    if constexpr (TMA) mbar_wait(&bars[kt % kStages], (kt / kStages) & 1);
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kt % kStages) * L::stage;
    eng.compute(st + L::a_off, st);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The partials of a [MT, BN] tile (NB matrices) of the CTAs of one
// cluster, merged in rank order: each CTA leaves its partials in its own
// shared memory; after a cluster barrier rank r sums the float4 groups r,
// r + splits, ... (in units of kThreads) over every rank through
// distributed shared memory and hands emit(row, column, sums) the result.
// A second barrier keeps each CTA's partials alive until every reader is
// done.  The sum order is fixed, so the result is the same from run to
// run, and no partial goes through device memory.  A cluster of one CTA
// reads its own partials.
template <int MT, int BN, int NB, class Eng, class Emit>
__device__ __forceinline__ void cluster_merge(unsigned char* smem,
                                              const Eng& eng, int splits,
                                              int rank, Emit emit) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int pitch = BN + 4;
  float* part = reinterpret_cast<float*>(smem);  // [NB][MT][pitch]
  eng.for_each([&](int r, int c, const float* v) {
#pragma unroll
    for (int b = 0; b < NB; ++b) part[(b * MT + r) * pitch + c] = v[b];
  });
  cluster.sync();
  constexpr int kGroups = MT * BN / 4;
  for (int g = rank * kThreads + threadIdx.x; g < kGroups; g += splits * kThreads) {
    const int r = g / (BN / 4), c = (g % (BN / 4)) * 4;
    float4 s[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) s[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = cluster.map_shared_rank(part, sp);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(p + (b * MT + r) * pitch + c);
        s[b].x += v.x;
        s[b].y += v.y;
        s[b].z += v.z;
        s[b].w += v.w;
      }
    }
    emit(r, c, s);
  }
  cluster.sync();
}

// the ring, aligned for the TMA boxes' 128-byte swizzle
template <int kAlign>
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem) {
  const unsigned a = smem_addr(smem);
  return smem + ((kAlign - a % kAlign) % kAlign);
}

// z = act(x . Wg) * (x . W1) over columns [n0, n0 + kUpN); the CTAs of
// one cluster take consecutive ranges of D's rows
template <typename T, int MT, bool TMA>
__global__ void __launch_bounds__(kThreads, 2)
glu_up(const T* __restrict__ x,   // [M, D]
       const T* __restrict__ wg,  // [D, F]
       const T* __restrict__ w1,  // [D, F]
       T* __restrict__ z,         // [M, F]
       int M, int D, int F, int act, int splits, int k_per_split, int cp_x,
       int cp_w, const __grid_constant__ CUtensorMap map_g,
       const __grid_constant__ CUtensorMap map_1) {
  using L = Tiles<T, MT, kUpN, 2, kUpKBytes, TMA>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = ring_base<L::align>(smem_raw);
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = tile * kUpN, m0 = blockIdx.y * MT;
  const int k0 = split * k_per_split;
  const int K = min(D, k0 + k_per_split) - k0;
  Engine<T, MT, kUpN, 2, kUpKBytes, TMA> eng;
  eng.zero();
  const T* const b[2] = {wg + (long long)k0 * F + n0, w1 + (long long)k0 * F + n0};
  const CUtensorMap* const maps[2] = {&map_g, &map_1};
  mainloop<T, MT, kUpN, 2, kUpKBytes, TMA>(smem, x + (long long)m0 * D + k0, D, M - m0,
                                           b, F, F - n0, K, cp_x, cp_w, maps, n0, k0, eng);
  cluster_merge<MT, kUpN, 2>(smem, eng, splits, split,
                             [&](int r, int c, const float4* s) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M) return;
    const float g[4] = {s[0].x, s[0].y, s[0].z, s[0].w};
    const float h[4] = {s[1].x, s[1].y, s[1].z, s[1].w};
    T* o = z + (long long)m * F + n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < F) o[j] = griffin::from_f32<T>(griffin::glu_act(g[j], act) * h[j]);
  });
}

// y = z . W2 over columns [n0, n0 + kDownN); the CTAs of one cluster take
// consecutive ranges of F's rows
template <typename T, int MT, bool TMA>
__global__ void __launch_bounds__(kThreads, 2)
glu_down(const T* __restrict__ z,   // [M, F]
         const T* __restrict__ w2,  // [F, D]
         float* __restrict__ y,     // [M, D]
         int M, int D, int F, int splits, int k_per_split, int cp_z,
         int cp_w, const __grid_constant__ CUtensorMap map_2) {
  using L = Tiles<T, MT, kDownN, 1, kDownKBytes, TMA>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = ring_base<L::align>(smem_raw);
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = tile * kDownN, m0 = blockIdx.y * MT;
  const int k0 = split * k_per_split;
  const int K = min(F, k0 + k_per_split) - k0;
  Engine<T, MT, kDownN, 1, kDownKBytes, TMA> eng;
  eng.zero();
  const T* const b[1] = {w2 + (long long)k0 * D + n0};
  const CUtensorMap* const maps[1] = {&map_2};
  mainloop<T, MT, kDownN, 1, kDownKBytes, TMA>(smem, z + (long long)m0 * F + k0, F,
                                               M - m0, b, D, D - n0, K, cp_z, cp_w, maps,
                                               n0, k0, eng);
  const bool vec4 = D % 4 == 0;
  cluster_merge<MT, kDownN, 1>(smem, eng, splits, split,
                               [&](int r, int c, const float4* s) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= D) return;
    float* o = y + (long long)m * D + n;
    if (vec4) {
      *reinterpret_cast<float4*>(o) = s[0];
    } else {
      const float v[4] = {s[0].x, s[0].y, s[0].z, s[0].w};
      for (int j = 0; j < 4 && n + j < D; ++j) o[j] = v[j];
    }
  });
}

// largest copy (16, 8, 4, or 2 for bf16) dividing a row and the addresses
inline int copy_bytes(int row_bytes, int min_bytes, const void* p0,
                      const void* p1 = nullptr) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p0) |
                               reinterpret_cast<unsigned long long>(p1);
  for (int c = 16; c > min_bytes; c /= 2)
    if (row_bytes % c == 0 && a % c == 0) return c;
  return min_bytes;
}

// grid (column tiles x splits, row tiles); the splits of a column tile run
// as one thread block cluster
template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, int smem, int col_tiles, int splits,
                            int m_tiles, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles * splits, m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A [rows, cols] bf16 row-major tensor as TMA boxes of [box_rows, 64],
// 128-byte swizzled, zeros outside; false where libcuda offers no
// cuTensorMapEncodeTiled or refuses the tensor
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int MT, bool TMA>
cudaError_t launch(const T* x, const T* wg, const T* w1, const T* w2, T* z,
                   float* y, int M, int D, int F, int act, int up_splits,
                   int up_k, int down_splits, int down_k, const CUtensorMap* maps,
                   cudaStream_t stream) {
  constexpr int isz = sizeof(T);
  const int m_tiles = (M + MT - 1) / MT;
  cudaError_t e = launch_clusters(
      glu_up<T, MT, TMA>, Tiles<T, MT, kUpN, 2, kUpKBytes, TMA>::smem,
      (F + kUpN - 1) / kUpN, up_splits, m_tiles, stream, x, wg, w1, z, M, D, F,
      act, up_splits, up_k, copy_bytes(D * isz, isz, x),
      copy_bytes(F * isz, isz, wg, w1), maps[0], maps[1]);
  if (e != cudaSuccess) return e;
  return launch_clusters(
      glu_down<T, MT, TMA>, Tiles<T, MT, kDownN, 1, kDownKBytes, TMA>::smem,
      (D + kDownN - 1) / kDownN, down_splits, m_tiles, stream,
      static_cast<const T*>(z), w2, y, M, D, F, down_splits, down_k,
      copy_bytes(F * isz, isz, z), copy_bytes(D * isz, isz, w2), maps[2]);
}

template <typename T>
cudaError_t launch_any(const void* x, const void* wg, const void* w1,
                       const void* w2, void* z, void* y, int M, int D, int F,
                       int act, int up_splits, int up_k, int down_splits,
                       int down_k, cudaStream_t st) {
  // bf16 weights whose rows and addresses are 16-byte aligned come by TMA
  CUtensorMap maps[3] = {};
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool tma = std::is_same<T, __nv_bfloat16>::value && D % 8 == 0 && F % 8 == 0 &&
                   aligned(wg) && aligned(w1) && aligned(w2) &&
                   bf16_map(&maps[0], wg, D, F, kUpKBytes / 2) &&
                   bf16_map(&maps[1], w1, D, F, kUpKBytes / 2) &&
                   bf16_map(&maps[2], w2, F, D, kDownKBytes / 2);
  auto run = [&](auto mt, auto use_tma) {
    return launch<T, decltype(mt)::value, decltype(use_tma)::value>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(w1), static_cast<const T*>(w2),
        static_cast<T*>(z), static_cast<float*>(y), M, D, F, act, up_splits,
        up_k, down_splits, down_k, maps, st);
  };
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using Yes = std::true_type;
  using No = std::false_type;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tma) return row_tile(M) == 32 ? run(I32{}, Yes{}) : run(I64{}, Yes{});
  }
  return row_tile(M) == 32 ? run(I32{}, No{}) : run(I64{}, No{});
}

// K rows cut into `splits` ranges of k_per_split rows: 1..8 ranges (one
// cluster), each a whole number of bk-row k tiles, none empty
inline bool valid_split(int K, int splits, int k_per_split, int bk) {
  return splits >= 1 && splits <= kMaxSplits && k_per_split > 0 &&
         k_per_split % bk == 0 && (long long)(splits - 1) * k_per_split < K &&
         (long long)splits * k_per_split >= K;
}

}  // namespace

// x [M, D], wg/w1 [D, F], w2 [F, D] in one dtype (fp32 or bf16); z [M, F]
// scratch in x's dtype; y [M, D] fp32.  act: 0 swiglu, 1 geglu (tanh),
// 2 reglu.  The up pass cuts D, the down pass F, into ranges that run as
// one cluster per column tile (kernels/glu_ffn.py::k_splits): up_splits
// ranges of up_k rows, down_splits of down_k, each a whole number of k
// tiles (64 bytes of an x row, 128 bytes of a z row), none empty; else
// cudaErrorInvalidValue.
extern "C" int glu_ffn(const void* x, const void* wg, const void* w1,
                       const void* w2, void* z, void* y, int M, int D, int F,
                       int act, int up_splits, int up_k, int down_splits,
                       int down_k, int is_bf16, void* stream) {
  const int isz = is_bf16 ? 2 : 4;
  const bool ok = M > 0 && D > 0 && F > 0 &&
                  valid_split(D, up_splits, up_k, kUpKBytes / isz) &&
                  valid_split(F, down_splits, down_k, kDownKBytes / isz);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_any<__nv_bfloat16>(x, wg, w1, w2, z, y, M, D, F, act,
                                          up_splits, up_k, down_splits,
                                          down_k, st)
              : launch_any<float>(x, wg, w1, w2, z, y, M, D, F, act,
                                  up_splits, up_k, down_splits, down_k, st);
  return static_cast<int>(e);
}
