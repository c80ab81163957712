// The tiled loop of the GLU FF kernels (glu_ffn.cu, griffin_ffn.cu) and
// their two passes:
//   ffn_up:   z = act(x . Wg) * (x . W1)   x [M, D] -> z [M, N]
//   ffn_down: y = z . W2                   z [M, K] -> y [M, D] fp32
//
// A CTA of 4 warps owns an output tile [MT rows, BN columns] over one
// range of the K rows; tiles of the A operand (x or z) and of the weights
// stream through a ring of kStages stages.  bf16 weights whose rows and
// addresses are 16-byte aligned come by TMA (per stage one thread issues
// boxes of 64 bf16 columns of a tensor map, 128-byte swizzled, that
// complete on the stage's mbarrier); everything else is cp.async, 16-byte
// copies where the rows and pointers allow, narrower otherwise, ragged
// edges zero-filled in shared memory.  The K rows of a column tile are cut
// into ranges (at most 8) that run as one thread block cluster and merge
// their fp32 partials in rank order through distributed shared memory, so
// the sum order is fixed and no partial goes through device memory.
// bf16 products run on mma.sync.m16n8k16 with fp32 sums; fp32 products
// on exact FMA (TF32 would be outside the 1e-4 tolerance at K = 4096).
// Both passes are programmatic dependent launches (launch_clusters sets
// the attribute on every launch): each waits with griddepcontrol.wait for
// the kernel before it on the stream before it touches memory that kernel
// may use, ffn_up lets the down pass be scheduled at once, and ffn_down
// heads its first W2 tiles for L2 before it waits for z.
//
// Where the weight rows come from is a row map: Dense (row r is row r,
// glu_ffn) or Blocks (row r is block_ids[r / bs] * bs + r % bs, GRIFFIN's
// selected neuron blocks read in place).  The weights are either [K, N]
// ("[k][n]" tiles, glu_ffn's Wg/W1 and both kernels' W2: the map picks K
// rows) or neuron rows [N, K] ("[n][k]" tiles, BT, griffin_ffn's Wg/W1:
// the map picks N rows).  A TMA box takes one row coordinate, so a box of
// mapped rows must lie inside one selected block: the callers take TMA
// only when the block size is a multiple of the box's 64 rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace griffin {
// internal linkage: each translation unit that includes this header gets
// its own copy of the kernels, so the FF sources link side by side
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;     // ring depth
constexpr int kPad = 16;       // bytes after each staged row
constexpr int kBoxRows = 64;   // rows of an [n][k] TMA box
constexpr int kMaxSplits = 8;  // portable thread block cluster size

// weight row r of a dense matrix
struct Dense {
  __device__ __forceinline__ long long operator()(int r) const { return r; }
};

// weight row r of the selected blocks of bs rows: block_ids[r / bs] * bs
// + r % bs (a few hundred bytes of ids, read through L1)
struct Blocks {
  const int* ids;
  int bs;
  __device__ __forceinline__ long long operator()(int r) const {
    return (long long)__ldg(ids + r / bs) * bs + r % bs;
  }
};

// shared memory of one pass: kStages stages of NB B tiles and an A tile
// [MT, BK], BK = KB bytes of an A row; the same memory then holds the fp32
// partials [NB][MT][BN + 4] that the cluster merges.  A B tile is [BK][BN]
// ([k][n]) or [BN][BK] (BT, [n][k]), rows padded by kPad bytes
// (cp.async), or with TMA boxes of 64 bf16 columns (128-byte rows,
// 128-byte swizzled, each 1024-byte aligned): [BK, 64] boxes of a [k][n]
// tile side by side in n, [64, 64] boxes of an [n][k] tile stacked in n.
template <typename T, int MT, int BN, int NB, int KB, bool TMA, bool BT>
struct Tiles {
  static_assert(!(TMA && BT) || (KB == 128 && BN % kBoxRows == 0),
                "an [n][k] TMA tile is whole [64, 64] boxes");
  static constexpr int BK = KB / (int)sizeof(T);
  static constexpr int a_pitch = KB + kPad;  // bytes
  static constexpr int b_pitch = TMA ? 128 : (BT ? KB : BN * (int)sizeof(T)) + kPad;
  static constexpr int box_bytes = (BT ? kBoxRows : BK) * 128;
  static constexpr int boxes = BT ? BN / kBoxRows : BN * (int)sizeof(T) / 128;
  static constexpr int a_bytes = MT * a_pitch;
  static constexpr int b_bytes = TMA ? boxes * box_bytes : (BT ? BN : BK) * b_pitch;
  static constexpr int a_off = NB * b_bytes;
  static constexpr int align = TMA ? 1024 : 16;
  static constexpr int stage = (a_off + a_bytes + align - 1) / align * align;
  static constexpr int part_bytes = NB * MT * (BN + 4) * 4;
  static constexpr int smem =
      (kStages * stage > part_bytes ? kStages * stage : part_bytes) + align;
};

// Stage rows [0, R) x elements [0, W) of a tile: row r from row(r).
// Rows >= rows_valid and elements >= cols_valid are zero (row() is not
// called for them).  cp bytes per copy divide every row and the address,
// so a copy is wholly in or out; 2 (an odd bf16 row) is a plain load and
// store.
template <typename T, class Row>
__device__ __forceinline__ void stage_tile(unsigned char* dst, int pitch, Row row, int R,
                                           int W, int rows_valid, int cols_valid, int cp) {
  const int per = cp / (int)sizeof(T);
  const int sh = __ffs(W / per) - 1;  // copies per row: a power of two
  const int n = R << sh;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i >> sh, e = (i & ((1 << sh) - 1)) * per;
    unsigned char* d = dst + r * pitch + e * (int)sizeof(T);
    if (r < rows_valid && e < cols_valid) {
      const T* s = row(r) + e;
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

// The products of one k tile, fp32: exact FMA.  Thread t owns 4 columns
// of rows (t / CG) * RPT .. +RPT-1: columns 4 * (t % CG) .. +3 of a [k][n]
// tile (one float4 of a B row), or t % CG + j * CG of an [n][k] tile (one
// B row each, neighbouring threads on neighbouring rows).
template <typename T, int MT, int BN, int NB, int KB, bool TMA, bool BT>
struct Engine {
  using L = Tiles<T, MT, BN, NB, KB, false, BT>;
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
      if constexpr (BT) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(
                sb + b * L::b_bytes + (cg + j * CG) * L::b_pitch + k * 4);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              float& c = acc[b][i][j];
              c += a4[i].x * w.x;
              c += a4[i].y * w.y;
              c += a4[i].z * w.z;
              c += a4[i].w * w.w;
            }
          }
      } else {
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
        f(rg * RPT + i, BT ? cg + j * CG : cg * 4 + j, v);
      }
  }
};

// The products of one k tile, bf16: mma.sync.m16n8k16 (fp32 sums).  Warp
// w owns columns [w * WN, (w + 1) * WN) of all MT rows.  A comes through
// ldmatrix (rows padded by 16 bytes); a [k][n] B tile through
// ldmatrix.trans, an [n][k] one through ldmatrix, which hands over the
// mma's column-major B fragments as they lie (the swizzle, or the
// padding, keeps all of them free of bank conflicts).
template <int MT, int BN, int NB, int KB, bool TMA, bool BT>
struct Engine<__nv_bfloat16, MT, BN, NB, KB, TMA, BT> {
  using L = Tiles<__nv_bfloat16, MT, BN, NB, KB, TMA, BT>;
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

  // the B fragments of n-tiles n and n + 8 at k rows ks * 16 ..: lane l
  // points at 8x8 matrix l / 8 (k half (l / 8) % 2, n half l / 16)
  __device__ __forceinline__ void load_b(uint32_t* bf, const unsigned char* sb, int ks,
                                         int n) const {
    const int lane = threadIdx.x & 31;
    if constexpr (BT) {  // [n][k]: row n, 16-byte chunk k / 8
      const int r = n + (lane >> 4) * 8 + (lane & 7), k = ks * 16 + ((lane >> 3) & 1) * 8;
      if constexpr (TMA)  // chunk k / 8 xor r % 8
        griffin::ldsm_x4(bf, sb + r * 128 + (((k / 8) ^ (r & 7)) * 16));
      else
        griffin::ldsm_x4(bf, sb + r * L::b_pitch + k * 2);
    } else {  // [k][n]: row k, 16-byte chunk n / 8
      const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, c = n + (lane >> 4) * 8;
      if constexpr (TMA)  // box c / 64, chunk (c % 64) / 8 xor k % 8
        griffin::ldsm_x4_t(bf, sb + (c / 64) * L::box_bytes + k * 128 +
                                   ((((c % 64) / 8) ^ (k & 7)) * 16));
      else
        griffin::ldsm_x4_t(bf, sb + k * L::b_pitch + c * 2);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* sa,
                                          const unsigned char* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
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
          load_b(bf, sb + b * L::b_bytes, ks, warp * WN + np * 16);
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

// a box of 64 bf16 columns at (column c0, row c1) of a tensor map, by the
// copy engine; rows and columns outside the tensor land as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}

// the same box fetched into L2 only
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(map),
               "r"(c0), "r"(c1) : "memory");
}

// eng += A[MT, K] . B_b for each b, K walked in BK tiles through the ring.
// A row r at a + r * lda (rows >= a_rows zero).  B_b is weight matrix
// b[b] (row stride ldb) through the row map: [k][n] tiles take K rows
// map(k_base + k), columns n0.. (columns >= n_valid zero); [n][k] tiles
// (BT) take N rows map(n0 + n) (rows >= n_valid zero), columns k_base +
// k.  With TMA the B tiles come instead as boxes of maps[b] (the tensor's
// edges zero-filled by the copy engine; a range's rows end at a k tile or
// at the tensor's end; an [n][k] box past n_valid reads row oob_row,
// outside the tensor, so zeros), completing on a per-stage mbarrier; the
// A tile is always cp.async.  Leaves the ring drained, so the caller may
// reuse shared memory.
template <typename T, int MT, int BN, int NB, int KB, bool TMA, bool BT, class Map>
__device__ __forceinline__ void mainloop(unsigned char* smem, const T* a, long long lda,
                                         int a_rows, const T* const (&b)[NB], long long ldb,
                                         Map map, int n0, int n_valid, int k_base, int K,
                                         int oob_row, int cp_a, int cp_b,
                                         const CUtensorMap* const (&maps)[NB],
                                         Engine<T, MT, BN, NB, KB, TMA, BT>& eng) {
  using L = Tiles<T, MT, BN, NB, KB, TMA, BT>;
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
    stage_tile<T>(st + L::a_off, L::a_pitch,
                  [&](int r) { return a + r * lda + k0; }, MT, L::BK, a_rows, K - k0, cp_a);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[kt % kStages];
        // the warps' reads of this stage come before the copy engine's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(bar, NB * L::b_bytes);
#pragma unroll
        for (int h = 0; h < L::boxes; ++h) {
          int c0, c1;
          if constexpr (BT) {
            c0 = k_base + k0;
            c1 = h * kBoxRows < n_valid ? (int)map(n0 + h * kBoxRows) : oob_row;
          } else {
            c0 = n0 + h * 64;
            c1 = (int)map(k_base + k0);
          }
#pragma unroll
          for (int i = 0; i < NB; ++i)
            tma_box(st + i * L::b_bytes + h * L::box_bytes, maps[i], c0, c1, bar);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const T* w = b[i];
        if constexpr (BT)
          stage_tile<T>(st + i * L::b_bytes, L::b_pitch,
                        [&](int r) { return w + map(n0 + r) * ldb + k_base + k0; }, BN,
                        L::BK, n_valid, K - k0, cp_b);
        else
          stage_tile<T>(st + i * L::b_bytes, L::b_pitch,
                        [&](int r) { return w + map(k_base + k0 + r) * ldb + n0; }, L::BK,
                        BN, K - k0, n_valid, cp_b);
      }
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
__device__ __forceinline__ void cluster_merge(unsigned char* smem, const Eng& eng, int splits,
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

// z = act(x . Wg) * (x . W1) over z columns [n0, n0 + BN); the CTAs of one
// cluster take consecutive ranges of D's rows.  Wg/W1 are [D, N] (BT
// false) or neuron rows [*, D] (BT), z's column n taking row map(n).
template <typename T, int MT, int BN, int KB, bool TMA, bool BT, class Map>
__global__ void __launch_bounds__(kThreads, 2)
ffn_up(const T* __restrict__ x,   // [M, D]
       const T* __restrict__ wg,  // [D, N] or [*, D]
       const T* __restrict__ w1,  // as wg
       T* __restrict__ z,         // [M, N]
       int M, int D, int N, int act, int splits, int k_per_split, int cp_x,
       int cp_w, Map map, int oob_row, const __grid_constant__ CUtensorMap map_g,
       const __grid_constant__ CUtensorMap map_1) {
  using L = Tiles<T, MT, BN, 2, KB, TMA, BT>;
  // the down pass may be scheduled from now on (it waits for z); x, and
  // the memory z takes, are the previous kernel's until it is done
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = ring_base<L::align>(smem_raw);
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = tile * BN, m0 = blockIdx.y * MT;
  const int k0 = split * k_per_split;
  const int K = min(D, k0 + k_per_split) - k0;
  Engine<T, MT, BN, 2, KB, TMA, BT> eng;
  eng.zero();
  const T* const b[2] = {wg, w1};
  const CUtensorMap* const maps[2] = {&map_g, &map_1};
  mainloop<T, MT, BN, 2, KB, TMA, BT>(smem, x + (long long)m0 * D + k0, D, M - m0, b,
                                      BT ? D : N, map, n0, N - n0, k0, K, oob_row, cp_x, cp_w,
                                      maps, eng);
  cluster_merge<MT, BN, 2>(smem, eng, splits, split, [&](int r, int c, const float4* s) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M) return;
    const float g[4] = {s[0].x, s[0].y, s[0].z, s[0].w};
    const float h[4] = {s[1].x, s[1].y, s[1].z, s[1].w};
    T* o = z + (long long)m * N + n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) o[j] = griffin::from_f32<T>(griffin::glu_act(g[j], act) * h[j]);
  });
}

// y = z . W2 over columns [n0, n0 + BN); the CTAs of one cluster take
// consecutive ranges of z's K columns, z's column k taking W2's row
// map(k)
template <typename T, int MT, int BN, int KB, bool TMA, class Map>
__global__ void __launch_bounds__(kThreads, 2)
ffn_down(const T* __restrict__ z,   // [M, K]
         const T* __restrict__ w2,  // [*, D]
         float* __restrict__ y,     // [M, D]
         int M, int D, int K, int splits, int k_per_split, int cp_z, int cp_w, Map map,
         const __grid_constant__ CUtensorMap map_2) {
  using L = Tiles<T, MT, BN, 1, KB, TMA, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = ring_base<L::align>(smem_raw);
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = tile * BN, m0 = blockIdx.y * MT;
  const int k0 = split * k_per_split;
  const int Kr = min(K, k0 + k_per_split) - k0;
  // launched while the up pass may still run: W2 does not depend on it,
  // so the ring's first tiles head for L2 before the wait for z
  if (TMA && threadIdx.x == 0)
    for (int kt = 0; kt < kStages - 1 && kt * L::BK < Kr; ++kt)
      for (int h = 0; h < L::boxes; ++h)
        tma_prefetch(&map_2, n0 + h * 64, (int)map(k0 + kt * L::BK));
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  Engine<T, MT, BN, 1, KB, TMA, false> eng;
  eng.zero();
  const T* const b[1] = {w2};
  const CUtensorMap* const maps[1] = {&map_2};
  mainloop<T, MT, BN, 1, KB, TMA, false>(smem, z + (long long)m0 * K + k0, K, M - m0, b, D,
                                         map, n0, D - n0, k0, Kr, 0, cp_z, cp_w, maps, eng);
  const bool vec4 = D % 4 == 0;
  cluster_merge<MT, BN, 1>(smem, eng, splits, split, [&](int r, int c, const float4* s) {
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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// grid (column tiles x splits, row tiles); the splits of a column tile run
// as one thread block cluster, and the kernel is a programmatic dependent
// launch: it may start before the previous kernel on the stream ends, and
// waits for it itself (griddepcontrol.wait)
template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, int smem, int col_tiles, int splits, int m_tiles,
                            cudaStream_t stream, Args... args) {
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
  cudaLaunchAttribute attrs[2] = {cluster, {}};
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// CTAs of `kernel` that one SM holds at once with `smem` bytes of dynamic
// shared memory: registers and shared memory both count; 0 on an error
template <class Kernel>
int resident_ctas(Kernel kernel, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return n;
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

// K rows cut into `splits` ranges of k_per_split rows: 1..8 ranges (one
// cluster), each a whole number of bk-row k tiles, none empty
inline bool valid_split(int K, int splits, int k_per_split, int bk) {
  return splits >= 1 && splits <= kMaxSplits && k_per_split > 0 && k_per_split % bk == 0 &&
         (long long)(splits - 1) * k_per_split < K && (long long)splits * k_per_split >= K;
}

}  // namespace
}  // namespace griffin
