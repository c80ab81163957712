// Fused paged attention on Hopper: K/V scatter + online-softmax GQA
// attention over the pages each request owns, one launch per call.
//
// Replaces: repro/kernels/paged_attn.py::paged_attn / _kernel (Pallas,
// TPU), fp32 and bf16 pools, and its quantized body (int8 / fp8 e4m3
// pools behind per-(page, kv-head) fp32 scales).  Every attention layer
// of every prefill chunk and decode tick runs it.
//
// Bound on the H100: bytes at decode.  Each (b, kv) reads its live pages
// once, sum_b ceil((pos_b+S)/page) * page * KV * hd * 2 * itemsize per
// layer over 3.35 TB/s; the flops (4 * S*G * context * hd per (b, kv))
// are far below the bf16 ridge until S*G reaches the hundreds.  A decode
// step moves ~2 MB, so in practice it is bound by latency: the launch,
// the block table's and the pages' DRAM round trips, a CTA with one warp
// per scheduler walking its pages, and the merge of the splits.
//
// Design:
// * Grid (row tiles x page splits, KV, B), 4 warps per CTA.  The S*G
//   query rows of one (b, kv) are cut into tiles of kRows = 64 rows
//   (4 warps x 16, the M of one mma.sync); the W block-table columns into
//   `splits` ranges of `pages_per_split` pages (kernels/paged_attn.py::
//   page_splits).  Each CTA counts its request's owned pages from the
//   block table, num_pages[b] = min(ceil((pos+S)/page), allocated), with
//   no host sync, and skips whole pages below the sliding window.
// * Loads in flight: pages are copied with cp.async, 16-byte vectors
//   where the row allows, into a ring of 8 stages in the pool's own dtype
//   (a bf16 K page of one kv head at hd=128 is 4 KB, rows padded by 16
//   bytes so the fragment loads are free of bank conflicts).  Pages go in
//   rounds of 4, two rounds in flight: round r+2 loads while round r is
//   computed.
// * Work of a warp: one page at a time, in blocks of 16 key slots, over
//   its 16 query rows.  When the tile has at most 16 rows (every decode
//   step: S*G = 8 at Yi-9B) the four warps take different pages of the
//   round ("page mode") and their softmax states are merged in warp order
//   at the end; otherwise each warp owns 16 rows and walks every page
//   ("row mode").  Scores, the row max and the row sum stay in registers
//   (the mma accumulator layout), reduced across the 4 lanes of a quad
//   with shuffles: no serial per-row loop and no CTA barrier between the
//   scores and the softmax.
// * QK^T on tensor cores where it is exact: bf16 queries against bf16,
//   int8 or e4m3 pages (all exact in bf16) run mma.sync.m16n8k16 with an
//   fp32 accumulator, the query fragments held in registers for the
//   whole walk; a quantized page's scale multiplies the score afterwards.
//   fp32 queries or fp32 pools use register-tiled fp32 FMA (TF32 would
//   keep ~3 digits) over bits * scale, as the plain version reads them.
//   P.V: P rounded to bf16 would cost ~4e-3 against the 1e-5 tolerance,
//   so the tensor-core path splits P (times a quantized page's V scale)
//   into three bf16 parts whose sum is P to ~2^-24 and runs three
//   mma.sync per n-tile into the fp32 accumulator; the score registers
//   are already the A operand's layout, and V comes from ldmatrix.trans
//   (bf16) or byte loads (8-bit values, exact in bf16).  The FMA path
//   runs P.V in fp32 over bits * scale.
// * Softmax: the TPU kernel's recurrence; NEG_INF = -2e38 is finite,
//   masked entries get probability 0 by an explicit test, rows with no
//   weight finalize to 0.
// * One launch.  With one split the CTA finalizes ctx itself.  With more
//   (at most 8), the splits of one (b, kv, row tile) are launched as one
//   thread block cluster: each CTA leaves its unnormalized accumulator and
//   (max, sum) per row in its shared memory, and after a cluster barrier
//   split k merges rows k, k + splits, ... from every split's shared
//   memory (distributed shared memory), in split order, so the result is
//   the same whatever order the CTAs finish in.  No partial goes through
//   device memory and no counter or scratch buffer is needed.
// * A CTA has one warp per scheduler, so no dependent chain is hidden by
//   another warp: head_dim is a power of two (shifts, no runtime integer
//   division), G divides by a multiply-high, and the query positions of
//   a warp's rows are computed once.
// * Write-back (fp32/bf16 pools): the Pallas kernel rewrites every
//   visited page, which is safe only because TPU grid steps run in order.
//   Here the step's new rows are merged into the staged page (rounded to
//   the pool dtype), and only the row-tile-0 CTA of the split that owns
//   the page writes those slots to the pool; other tiles use their own
//   shared-memory copy, so nothing depends on write order.  By the
//   copy-on-write contract those pages belong to this request alone;
//   shared read-only pages and the trash page are never written.
// * Quantized pools re-encode a page whole when its scale grows.  When
//   the S*G rows fit one row tile (every decode step), a page receiving
//   rows is read by exactly one CTA, which re-encodes it in shared memory
//   in the launch: amax over the new rows, s_new = max(s_old, amax *
//   (1/qmax)), every slot q(bits * s_old / max(s_new, EPS)) or, for a new
//   row, q(row / max(s_new, EPS)), then bits and s_new written back and
//   the page attended from shared memory.  With several row tiles
//   (quantized prefill) several CTAs read that page, so a first launch
//   (kv_quant_scatter, one CTA per (b, page touched, kv)) does the
//   scatter before attention reads any page.  IEEE division and no fast
//   math keep the bits those of kernels/kv_quant.py.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;                 // rows of one warp (mma M)
constexpr int kRows = kWarps * kWarpRows;     // query rows of one CTA
constexpr int kRound = kWarps;                // pages per round
constexpr int kInFlight = 2;                  // rounds in flight
constexpr int kStages = kRound * kInFlight;   // pages in the ring
constexpr int kBlk = 16;                      // key slots per score block
constexpr int kMaxHd = 128;
constexpr int kRowPad = 16;                   // bytes after each staged row
constexpr int kQPad = 4;                      // floats after each query row
constexpr int kPPitch = kWarpRows + 4;        // floats per slot row of P^T
constexpr int kMaxSplits = 8;                 // portable thread block cluster size

// Shared memory, in bytes: the page ring (reused by the epilogue for the
// per-warp states, which the other CTAs of the cluster read), fp32
// queries, per-warp P^T and rescale factors (reused for the warp-merge
// weights), the ring's scales, the split's page ids, a zero bf16 row (the
// V operand of slots past a short page), and reduction scratch.
struct Layout {
  int pitch, stage;
  size_t q, p, sc, pid, z, misc, total;
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int page, int hd, int tsize, int pps) {
  Layout L;
  L.pitch = hd * tsize + kRowPad;
  L.stage = 2 * page * L.pitch;
  const size_t ring = (size_t)kStages * L.stage;
  const size_t states = sizeof(float) * (size_t)kRows * (hd + 2);
  L.q = up16(ring > states ? ring : states);
  L.p = L.q + up16(sizeof(float) * kRows * (hd + kQPad));
  L.sc = L.p + up16(sizeof(float) * kWarps * (kBlk * kPPitch + kWarpRows));
  L.pid = L.sc + up16(sizeof(float) * 2 * kStages);
  L.z = L.pid + up16(sizeof(int) * (size_t)pps);
  L.misc = L.z + 2 * kMaxHd;
  L.total = L.misc + 64;
  return L;
}

__device__ __forceinline__ bool is_valid(int kpos, int qpos, int window) {
  return kpos <= qpos && (window == 0 || kpos > qpos - window);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive elements of a staged row as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  return make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                     static_cast<float>(p[2]), static_cast<float>(p[3]));
}

// a 16-byte vector of queries as fp32 (the pointer picks the type)
__device__ __forceinline__ void unpack(const uint4& v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
    f[2 * k] = __low2float(h);
    f[2 * k + 1] = __high2float(h);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two consecutive elements of a staged K row as a bf16x2 mma operand
// (exact: int8 and e4m3 values are bf16 values)
__device__ __forceinline__ uint32_t load_b(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t load_b(const int8_t* p) {
  return pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[1]));
}
__device__ __forceinline__ uint32_t load_b(const __nv_fp8_e4m3* p) {
  return pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[1]));
}

// a value as pool bits: quantized pools encode it under its scale already
// applied (kv_quant.quantize), fp32/bf16 pools round it (bf16: to nearest
// even); overloads on the pool pointer so every instantiation resolves
__device__ __forceinline__ float encode(float v, const float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 encode(float v, const __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ int8_t encode(float v, const int8_t*) {
  return griffin::quantize<int8_t>(v);
}
__device__ __forceinline__ __nv_fp8_e4m3 encode(float v, const __nv_fp8_e4m3*) {
  return griffin::quantize<__nv_fp8_e4m3>(v);
}

// four 8x8 bf16 matrices, transposed: the B operands of two n-tiles
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// fp32 pairs as three bf16 pairs whose sum is the pair to ~2^-24: the P
// operand of a P.V on tensor cores that keeps fp32 accuracy
__device__ __forceinline__ void split3(float x, float y, uint32_t* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[k] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// two 8-bit V elements of rows k, k+1 (zero past the page) as a bf16 pair
template <typename T>
__device__ __forceinline__ uint32_t v_pair(const unsigned char* sv, int pitch,
                                           int k, int n, int page) {
  const float lo = k < page ? static_cast<float>(reinterpret_cast<const T*>(sv + (size_t)k * pitch)[n]) : 0.f;
  const float hi = k + 1 < page ? static_cast<float>(reinterpret_cast<const T*>(sv + (size_t)(k + 1) * pitch)[n]) : 0.f;
  return pack_bf16(lo, hi);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float block_max(float v, float* red, int n_threads) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < n_threads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

template <typename T>
__device__ __forceinline__ T* srow(unsigned char* base, int pitch, int t) {
  return reinterpret_cast<T*>(base + (size_t)t * pitch);
}

template <typename TIn, typename T, bool kMma>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TIn* __restrict__ q,      // [B, S, H, hd]
                  const TIn* __restrict__ k_new,  // [B, S, KV, hd]
                  const TIn* __restrict__ v_new,  // [B, S, KV, hd]
                  T* __restrict__ pool_k,         // [P+1, page, KV, hd]
                  T* __restrict__ pool_v,
                  float* __restrict__ scale_k,    // [P+1, KV] (quantized)
                  float* __restrict__ scale_v,
                  const int* __restrict__ bt,     // [B, W]
                  const int* __restrict__ pos,    // [B]
                  const unsigned char* __restrict__ wm,  // [B, S]
                  float* __restrict__ ctx,        // [B, S, H, hd]
                  int S, int H, int KV, int hd, int page, int W, int window,
                  float scale, int pps, int splits, int scatter,
                  float inv_qmax, float eps, int cp_bytes) {
  constexpr bool kQuant =
      std::is_same<T, int8_t>::value || std::is_same<T, __nv_fp8_e4m3>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int SG = S * G;
  const Layout L = layout(page, hd, sizeof(T), pps);
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* pw = reinterpret_cast<float*>(smem + L.p);
  float* scs = reinterpret_cast<float*>(smem + L.sc);
  int* pids = reinterpret_cast<int*>(smem + L.pid);
  const __nv_bfloat16* zrow = reinterpret_cast<const __nv_bfloat16*>(smem + L.z);
  float* misc = reinterpret_cast<float*>(smem + L.misc);

  const int n_tiles = (SG + kRows - 1) / kRows;
  // the splits of a row tile are consecutive: one cluster
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  // a CTA has one warp per scheduler, so a runtime division's dependent
  // chain is never hidden: head_dim (a power of two) divides by shifts,
  // G by a multiply-high (exact while R * G < 2^32)
  const int hd_sh = __ffs(hd) - 1;
  const unsigned g_inv = G > 1 ? 0xffffffffu / G + 1 : 0u;
  auto div_g = [&](int R) { return G > 1 ? (int)__umulhi((unsigned)R, g_inv) : R; };
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = tile * kRows;
  const int nr = min(kRows, SG - r0);
  const bool page_mode = nr <= kWarpRows;
  const int posb = pos[b];
  const int j_begin = split * pps;

  // query rows r0..r0+nr of (b, kv) (row R = s*G + g is head kv*G + g):
  // their 16-byte vectors are loaded into registers first, so that their
  // latency overlaps the block table's and the first pages'
  constexpr int kQv = 16 / sizeof(TIn);                     // elements a vector
  constexpr int kQvSh = kQv == 8 ? 3 : 2;
  constexpr int kQBatch = kRows * kMaxHd / kQv / kThreads;  // vectors a thread
  const int nvr = hd / kQv, nvr_sh = hd_sh - kQvSh;
  const bool q_vec = hd % kQv == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int nr_pad = (nr + kWarpRows - 1) / kWarpRows * kWarpRows;
  uint4 qv[kQBatch];
  if (q_vec) {
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) {
      const int i = tid + k * kThreads, r = i >> nvr_sh;
      if (r < nr) {
        const int R = r0 + r, s = div_g(R), g = R - s * G;
        qv[k] = *reinterpret_cast<const uint4*>(
            q + (((long long)b * S + s) * H + kv * G + g) * hd + (i & (nvr - 1)) * kQv);
      }
    }
  }

  // owned pages: tables are prefix-allocated, so count the non-negative
  // entries of row b; cache this split's page ids on the way
  int n_alloc = 0;
  for (int j0 = 0; j0 < W; j0 += kThreads) {
    const int j = j0 + tid;
    const int pid = j < W ? bt[(long long)b * W + j] : -1;
    if (j >= j_begin && j < j_begin + pps && j < W) pids[j - j_begin] = pid;
    n_alloc += __syncthreads_count(pid >= 0);
  }
  const int npb = min((posb + S + page - 1) / page, n_alloc);
  // whole pages below every query's window contribute nothing (and no new
  // row lands there: new rows sit at positions >= pos)
  int j_win = 0;
  if (window > 0 && posb - window - page + 1 >= 0)
    j_win = (posb - window - page + 1) / page + 1;
  const int j_lo = max(j_begin, j_win);
  const int units = max(0, min(j_begin + pps, npb) - j_lo);
  const int n_rounds = (units + kRound - 1) / kRound;
  const int row_bytes = hd * (int)sizeof(T);

  auto issue = [&](int rr) {
    for (int k = 0; k < kRound; ++k) {
      const int u = rr * kRound + k;
      if (u >= units) break;
      const int st = (rr % kInFlight) * kRound + k;
      const long long pid = pids[j_lo + u - j_begin];
      unsigned char* sk = ring + (size_t)st * L.stage;
      unsigned char* sv = sk + (size_t)page * L.pitch;
      const int cpr = row_bytes / cp_bytes, cpr_sh = __ffs(cpr) - 1;
      for (int i = tid; i < page * cpr; i += kThreads) {
        const int t = i >> cpr_sh, c = i & (cpr - 1);
        const long long g = ((pid * page + t) * KV + kv) * (long long)row_bytes + c * cp_bytes;
        cp_async(sk + t * L.pitch + c * cp_bytes,
                 reinterpret_cast<const unsigned char*>(pool_k) + g, cp_bytes);
        cp_async(sv + t * L.pitch + c * cp_bytes,
                 reinterpret_cast<const unsigned char*>(pool_v) + g, cp_bytes);
      }
      if (kQuant && tid == 0) {
        cp_async(&scs[2 * st], scale_k + pid * KV + kv, 4);
        cp_async(&scs[2 * st + 1], scale_v + pid * KV + kv, 4);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };
  for (int rr = 0; rr < kInFlight; ++rr) issue(rr);

  for (int i = tid; i < kMaxHd / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(smem + L.z)[i] = 0u;
  // the queries into shared memory as fp32; rows past nr up to the warp
  // tile are zero
  const int qp = hd + kQPad;
  if (q_vec) {
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) {
      const int i = tid + k * kThreads, r = i >> nvr_sh;
      if (r < nr_pad) {
        float f[kQv];
#pragma unroll
        for (int e = 0; e < kQv; ++e) f[e] = 0.f;
        if (r < nr) unpack(qv[k], f, q);
        float* dst = qs + r * qp + (i & (nvr - 1)) * kQv;
#pragma unroll
        for (int e = 0; e < kQv; e += 4)
          *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  } else {
    for (int i = tid; i < nr_pad * hd; i += kThreads) {
      const int r = i >> hd_sh, d = i & (hd - 1);
      float v = 0.f;
      if (r < nr) {
        const int R = r0 + r, s = div_g(R), g = R - s * G;
        v = griffin::to_f32(q[(((long long)b * S + s) * H + kv * G + g) * hd + d]);
      }
      qs[r * qp + d] = v;
    }
  }
  __syncthreads();

  // -- per-warp state ------------------------------------------------------
  const int wr0 = page_mode ? 0 : warp * kWarpRows;  // first tile row of the warp
  const int nw = max(0, min(kWarpRows, nr - wr0));   // its rows
  const int quad = lane / 4, c4 = lane % 4;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // P.V layout: lane owns 4 feature columns (chunk pc) of rows pg*rpl..
  const int nch = hd / 4;
  const int groups = max(1, 32 / nch);
  const int rpl = (kWarpRows + groups - 1) / groups;
  const int pc = lane % nch, pg = lane / nch;
  const bool pv_lane = lane < groups * nch && pg < groups;
  float acc[kWarpRows][4];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float* pT = pw + warp * (kBlk * kPPitch + kWarpRows);  // [kBlk][kPPitch]
  float* aw = pT + kBlk * kPPitch;                        // [kWarpRows]

  uint32_t qa[kMaxHd / 16][4];
  if constexpr (kMma) {
    const float* q0 = qs + (wr0 + quad) * qp;
    const float* q1 = q0 + 8 * qp;
#pragma unroll
    for (int ks = 0; ks < kMaxHd / 16; ++ks) {
      if (ks * 16 < hd) {
        const int d = ks * 16 + 2 * c4;
        qa[ks][0] = pack_bf16(q0[d], q0[d + 1]);
        qa[ks][1] = pack_bf16(q1[d], q1[d + 1]);
        qa[ks][2] = pack_bf16(q0[d + 8], q0[d + 9]);
        qa[ks][3] = pack_bf16(q1[d + 8], q1[d + 9]);
      }
    }
  }

  // query position of the quad's two rows
  const int qpos_h[2] = {posb + div_g(r0 + wr0 + quad), posb + div_g(r0 + wr0 + quad + 8)};

  // one page of stage st (logical page j) into the warp's state
  auto attend = [&](int st, int j) {
    unsigned char* sk = ring + (size_t)st * L.stage;
    unsigned char* sv = sk + (size_t)page * L.pitch;
    float sck = 1.f, scv = 1.f;
    if constexpr (kQuant) {
      sck = scs[2 * st];
      scv = scs[2 * st + 1];
    }
    for (int blk = 0; blk < page; blk += kBlk) {
      // scores of rows (quad, quad + 8) x slots blk + {2c4, 2c4+1, 8+2c4, 9+2c4}
      float sc[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
      if constexpr (kMma) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = min(blk + nt * 8 + quad, page - 1);
          const T* kr = srow<T>(sk, L.pitch, n);
          // two accumulator chains (even, odd k-steps) halve the mma latency
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < kMaxHd / 16; ++ks) {
            if (ks * 16 < hd) {
              const uint32_t b0 = load_b(kr + ks * 16 + 2 * c4);
              const uint32_t b1 = load_b(kr + ks * 16 + 8 + 2 * c4);
              mma_bf16(c[ks % 2], qa[ks], b0, b1);
            }
          }
          sc[0][2 * nt] = c[0][0] + c[1][0];
          sc[0][2 * nt + 1] = c[0][1] + c[1][1];
          sc[1][2 * nt] = c[0][2] + c[1][2];
          sc[1][2 * nt + 1] = c[0][3] + c[1][3];
        }
      } else {
        const float* q0 = qs + (wr0 + quad) * qp;
        const float* q1 = q0 + 8 * qp;
        const T* kr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kr[e] = srow<T>(sk, L.pitch,
                          min(blk + (e / 2) * 8 + 2 * c4 + (e % 2), page - 1));
        const bool two = nw > 8;
        for (int d = 0; d < hd; d += 4) {
          const float4 a = load4(q0 + d);
          float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (two) a1 = load4(q1 + d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float4 k = load4(kr[e] + d);
            if constexpr (kQuant) {  // bits * scale, as the plain version reads
              k.x *= sck;
              k.y *= sck;
              k.z *= sck;
              k.w *= sck;
            }
            float s0 = sc[0][e];
            s0 = fmaf(a.x, k.x, s0);
            s0 = fmaf(a.y, k.y, s0);
            s0 = fmaf(a.z, k.z, s0);
            s0 = fmaf(a.w, k.w, s0);
            sc[0][e] = s0;
            if (two) {
              float s1 = sc[1][e];
              s1 = fmaf(a1.x, k.x, s1);
              s1 = fmaf(a1.y, k.y, s1);
              s1 = fmaf(a1.z, k.z, s1);
              s1 = fmaf(a1.w, k.w, s1);
              sc[1][e] = s1;
            }
          }
        }
      }
      // -- online softmax on the quad's rows --------------------------------
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = quad + 8 * h;
        const int qpos = qpos_h[h];
        bool ok[4];
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = blk + (e / 2) * 8 + 2 * c4 + (e % 2);
          ok[e] = slot < page && is_valid(j * page + slot, qpos, window);
          // the mma path applies the page's K scale to the whole score
          sc[h][e] = ok[e] ? (kMma ? sc[h][e] * sck : sc[h][e]) * scale : kNegInf;
          mx = fmaxf(mx, sc[h][e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx);
        const float a = expf(m_run[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ok[e] ? expf(sc[h][e] - m_new) : 0.f;
          sum += p;
          sc[h][e] = p;
          if constexpr (!kMma) pT[((e / 2) * 8 + 2 * c4 + (e % 2)) * kPPitch + row] = p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[h] = l_run[h] * a + sum;
        m_run[h] = m_new;
        alpha[h] = a;
        if (!kMma && c4 == 0) aw[row] = a;
      }
      if constexpr (kMma) {
        // -- acc = acc * alpha + P @ V on tensor cores: P (the score
        //    registers, already the A layout) as three bf16 parts, V the
        //    staged page (bf16, or 8-bit values exact in bf16) times its
        //    scale folded into P; acc [n-tile][c] in the accumulator layout
#pragma unroll
        for (int nt = 0; nt < kMaxHd / 8; ++nt) {
          acc[nt][0] *= alpha[0];
          acc[nt][1] *= alpha[0];
          acc[nt][2] *= alpha[1];
          acc[nt][3] *= alpha[1];
        }
        // A registers a0..a3: (row quad, slots 2c4..), (quad + 8, 2c4..),
        // (quad, 8 + 2c4..), (quad + 8, 8 + 2c4..)
        uint32_t parts[4][3];
        split3(sc[0][0] * scv, sc[0][1] * scv, parts[0]);
        split3(sc[1][0] * scv, sc[1][1] * scv, parts[1]);
        split3(sc[0][2] * scv, sc[0][3] * scv, parts[2]);
        split3(sc[1][2] * scv, sc[1][3] * scv, parts[3]);
        uint32_t pk[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[k][i] = parts[i][k];
        const int kr = blk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < kMaxHd / 16; ++np) {
          if (np * 16 < hd) {
            uint32_t bv[4];
            if constexpr (std::is_same<T, __nv_bfloat16>::value) {
              const int col = np * 16 + (lane >> 4) * 8;
              ldsm_x4_t(bv, kr < page ? static_cast<const void*>(srow<T>(sv, L.pitch, kr) + col)
                                      : static_cast<const void*>(zrow + col));
            } else {
              const int n0 = np * 16 + quad;
              bv[0] = v_pair<T>(sv, L.pitch, blk + 2 * c4, n0, page);
              bv[1] = v_pair<T>(sv, L.pitch, blk + 2 * c4 + 8, n0, page);
              bv[2] = v_pair<T>(sv, L.pitch, blk + 2 * c4, n0 + 8, page);
              bv[3] = v_pair<T>(sv, L.pitch, blk + 2 * c4 + 8, n0 + 8, page);
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              mma_bf16(acc[2 * np], pk[k], bv[0], bv[1]);
              mma_bf16(acc[2 * np + 1], pk[k], bv[2], bv[3]);
            }
          }
        }
        continue;
      }
      __syncwarp();
      // -- acc = acc * alpha + P @ V ---------------------------------------
      if (pv_lane) {
        const int nt = min(kBlk, page - blk);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const int row = pg * rpl + i;
          if (i < rpl && row < nw) {
            const float a = aw[row];
            acc[i][0] *= a;
            acc[i][1] *= a;
            acc[i][2] *= a;
            acc[i][3] *= a;
          }
        }
        for (int t = 0; t < nt; ++t) {
          float4 v = load4(srow<T>(sv, L.pitch, blk + t) + 4 * pc);
          if constexpr (kQuant) {
            v.x *= scv;
            v.y *= scv;
            v.z *= scv;
            v.w *= scv;
          }
          const float* pr = pT + t * kPPitch;
#pragma unroll
          for (int i = 0; i < kWarpRows; ++i) {
            const int row = pg * rpl + i;
            if (i < rpl && row < nw) {
              const float p = pr[row];
              acc[i][0] = fmaf(p, v.x, acc[i][0]);
              acc[i][1] = fmaf(p, v.y, acc[i][1]);
              acc[i][2] = fmaf(p, v.z, acc[i][2]);
              acc[i][3] = fmaf(p, v.w, acc[i][3]);
            }
          }
        }
      }
      __syncwarp();
    }
  };

  // the step's new rows of a staged page (uniform over the CTA)
  auto merge_new_rows = [&](int st, int j) {
    unsigned char* sk = ring + (size_t)st * L.stage;
    unsigned char* sv = sk + (size_t)page * L.pitch;
    const long long pid = pids[j - j_begin];
    const int t_lo = max(posb - j * page, 0);
    const int t_hi = min(posb + S - j * page, page);
    if constexpr (!kQuant) {
      // rounded to T, so the casts back are exact; tile 0 writes the pool
#pragma unroll 4
      for (int i = tid; i < (t_hi - t_lo) * hd; i += kThreads) {
        const int t = t_lo + (i >> hd_sh), d = i & (hd - 1);
        const int s = j * page + t - posb;
        if (wm[(long long)b * S + s]) {
          const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
          const T kval = encode(griffin::to_f32(k_new[n_idx]), pool_k);
          const T vval = encode(griffin::to_f32(v_new[n_idx]), pool_v);
          srow<T>(sk, L.pitch, t)[d] = kval;
          srow<T>(sv, L.pitch, t)[d] = vval;
          if (tile == 0) {
            const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
            pool_k[g_idx] = kval;
            pool_v[g_idx] = vval;
          }
        }
      }
    } else {
      // amax of the page's new rows (rows with write_mask unset are not written)
      float ak = 0.f, av = 0.f;
      int any = 0;
      for (int i = tid; i < (t_hi - t_lo) * hd; i += kThreads) {
        const int t = t_lo + (i >> hd_sh), d = i & (hd - 1);
        const int s = j * page + t - posb;
        if (wm[(long long)b * S + s]) {
          const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
          ak = fmaxf(ak, fabsf(griffin::to_f32(k_new[n_idx])));
          av = fmaxf(av, fabsf(griffin::to_f32(v_new[n_idx])));
          any = 1;
        }
      }
      if (!__syncthreads_or(any)) return;  // no row: scale and bits unchanged
      ak = block_max(ak, misc, kThreads);
      av = block_max(av, misc, kThreads);
      const float sk_old = scs[2 * st], sv_old = scs[2 * st + 1];
      const float sk_new = fmaxf(sk_old, ak * inv_qmax);
      const float sv_new = fmaxf(sv_old, av * inv_qmax);
      const float sk_eff = fmaxf(sk_new, eps), sv_eff = fmaxf(sv_new, eps);
      // re-encode the (page, kv) slice; new rows replace their slots.  Where
      // a scale did not grow (and is not below EPS) the re-encode of an old
      // row is the identity, q(bits * s / s) == bits, so only the new rows
      // are encoded
      const bool k_same = sk_new == sk_old && sk_old >= eps;
      const bool v_same = sv_new == sv_old && sv_old >= eps;
      const int t_from = k_same && v_same ? t_lo : 0;
      const int t_to = k_same && v_same ? t_hi : page;
      for (int i = tid; i < (t_to - t_from) * hd; i += kThreads) {
        const int t = t_from + (i >> hd_sh), d = i & (hd - 1);
        const int s = j * page + t - posb;
        const bool fresh = s >= 0 && s < S && wm[(long long)b * S + s];
        const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
        const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
        T* ek = srow<T>(sk, L.pitch, t) + d;
        T* ev = srow<T>(sv, L.pitch, t) + d;
        if (fresh || !k_same) {
          const float kf = fresh ? griffin::to_f32(k_new[n_idx])
                                 : griffin::to_f32(*ek) * sk_old;
          *ek = pool_k[g_idx] = encode(kf / sk_eff, pool_k);
        }
        if (fresh || !v_same) {
          const float vf = fresh ? griffin::to_f32(v_new[n_idx])
                                 : griffin::to_f32(*ev) * sv_old;
          *ev = pool_v[g_idx] = encode(vf / sv_eff, pool_v);
        }
      }
      __syncthreads();  // every thread has read the old scales
      if (tid == 0) {
        scs[2 * st] = sk_new;
        scs[2 * st + 1] = sv_new;
        scale_k[pid * KV + kv] = sk_new;
        scale_v[pid * KV + kv] = sv_new;
      }
    }
  };

  // -- the page walk ---------------------------------------------------------
  for (int rr = 0; rr < n_rounds; ++rr) {
    cp_async_wait<kInFlight - 1>();
    __syncthreads();
    bool merged = false;
    for (int k = 0; k < kRound; ++k) {
      const int u = rr * kRound + k;
      if (u >= units) break;
      const int j = j_lo + u;
      if ((!kQuant || scatter) && j * page < posb + S && (j + 1) * page > posb) {
        merge_new_rows((rr % kInFlight) * kRound + k, j);
        merged = true;
      }
    }
    if (merged) __syncthreads();
    if (page_mode) {
      const int u = rr * kRound + warp;
      if (u < units) attend((rr % kInFlight) * kRound + warp, j_lo + u);
    } else if (nw > 0) {
      for (int k = 0; k < kRound; ++k) {
        const int u = rr * kRound + k;
        if (u >= units) break;
        attend((rr % kInFlight) * kRound + k, j_lo + u);
      }
    }
    __syncthreads();
    issue(rr + kInFlight);
  }
  cp_async_wait<0>();
  __syncthreads();

  // -- per-warp states into shared memory (over the ring) ------------------
  float* macc = reinterpret_cast<float*>(ring);  // [kRows][hd]
  float* mml = macc + kRows * hd;                // [kRows][2]
  if (c4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * kWarpRows + quad + 8 * h;
      mml[2 * row] = m_run[h];
      mml[2 * row + 1] = l_run[h];
    }
  }
  if constexpr (kMma) {
#pragma unroll
    for (int nt = 0; nt < kMaxHd / 8; ++nt) {
      if (nt * 8 < hd) {
        float* dst = macc + (warp * kWarpRows + quad) * hd + nt * 8 + 2 * c4;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + 8 * hd) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  } else if (pv_lane) {
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int row = pg * rpl + i;
      if (i < rpl && row < kWarpRows)
        *reinterpret_cast<float4*>(macc + (warp * kWarpRows + row) * hd + 4 * pc) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();

  // In page mode the four warps' states of the tile's rows are merged in
  // warp order into the row layout of row mode: macc[r], mml[r] for r < nr
  // hold the CTA's unnormalized accumulator, max and sum either way.
  const int nc = hd / 4, nc_sh = hd_sh - 2;
  if (page_mode) {
    float* wf = pw;                       // [kWarpRows][kWarps] warp weights
    float* wM = wf + kWarpRows * kWarps;  // [kWarpRows] max
    float* wL = wM + kWarpRows;           // [kWarpRows] sum
    if (tid < nr) {
      float M = kNegInf;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mml[2 * (w * kWarpRows + tid)]);
      float Lsum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const int rw = w * kWarpRows + tid;
        const float f = expf(mml[2 * rw] - M);
        wf[tid * kWarps + w] = f;
        Lsum += mml[2 * rw + 1] * f;
      }
      wM[tid] = M;
      wL[tid] = Lsum;
    }
    __syncthreads();
    constexpr int kItems = kWarpRows * kMaxHd / 4 / kThreads;
    float4 comb[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = tid + k * kThreads, r = i >> nc_sh, c = i & (nc - 1);
      comb[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        for (int w = 0; w < kWarps; ++w) {
          const float f = wf[r * kWarps + w];
          const float4 v = *reinterpret_cast<const float4*>(macc + (w * kWarpRows + r) * hd + 4 * c);
          comb[k].x += v.x * f;
          comb[k].y += v.y * f;
          comb[k].z += v.z * f;
          comb[k].w += v.w * f;
        }
      }
    }
    __syncthreads();  // every warp state is read before row r is rewritten
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = tid + k * kThreads, r = i >> nc_sh, c = i & (nc - 1);
      if (r < nr) *reinterpret_cast<float4*>(macc + r * hd + 4 * c) = comb[k];
    }
    if (tid < nr) {
      mml[2 * tid] = wM[tid];
      mml[2 * tid + 1] = wL[tid];
    }
    __syncthreads();
  }

  auto ctx_at = [&](int r, int c) {  // ctx[b, s, kv*G + g, 4c..] of tile row r
    const int R = r0 + r, s = div_g(R), g = R - s * G;
    return reinterpret_cast<float4*>(ctx + (((long long)b * S + s) * H + kv * G + g) * hd + 4 * c);
  };
  auto finalize = [](const float4& A, float l) {  // acc / l, or 0 where no key carried weight
    return l > 0.f ? make_float4(A.x / l, A.y / l, A.z / l, A.w / l)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  if (splits == 1) {
    for (int i = tid; i < nr * nc; i += kThreads) {
      const int r = i >> nc_sh, c = i & (nc - 1);
      *ctx_at(r, c) = finalize(*reinterpret_cast<const float4*>(macc + r * hd + 4 * c), mml[2 * r + 1]);
    }
    return;
  }
  // -- the splits of one (b, kv, row tile) are one thread block cluster:
  //    after the cluster barrier, split k merges rows k, k + splits, ...
  //    reading every split's state from its shared memory, in split order
  //    (deterministic whatever order the CTAs finish in); a second barrier
  //    keeps each CTA's shared memory alive until every reader is done
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int mine = split < nr ? (nr - split + splits - 1) / splits : 0;
  for (int i = tid; i < mine * nc; i += kThreads) {
    const int r = split + (i >> nc_sh) * splits, c = i & (nc - 1);
    float m_sp[kMaxSplits], l_sp[kMaxSplits];
    float M = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        const float* rml = cluster.map_shared_rank(mml, sp);
        m_sp[sp] = rml[2 * r];
        l_sp[sp] = rml[2 * r + 1];
        M = fmaxf(M, m_sp[sp]);
      }
    }
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    float Lsum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        const float f = expf(m_sp[sp] - M);
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(macc, sp) + r * hd + 4 * c);
        Lsum += l_sp[sp] * f;
        A.x += v.x * f;
        A.y += v.y * f;
        A.z += v.z * f;
        A.w += v.w * f;
      }
    }
    *ctx_at(r, c) = finalize(A, Lsum);
  }
  cluster.sync();
}

// threads of a scatter CTA: a (page, kv) slice is page * hd elements
// (2048 at Yi-9B shapes), and the few CTAs of a step need many warps each
// to hide the latency of their per-element work
constexpr int kScatterThreads = 512;

// The quantized scatter of a step whose rows span several row tiles: one
// CTA per (b, page j touched this step, kv), grid (touched-page slots,
// KV, B); page j = pos[b] / page + blockIdx.x.
template <typename TIn, typename T>
__global__ void __launch_bounds__(kScatterThreads)
kv_quant_scatter(const TIn* __restrict__ k_new,  // [B, S, KV, hd]
                 const TIn* __restrict__ v_new,
                 T* __restrict__ pool_k,         // [P+1, page, KV, hd]
                 T* __restrict__ pool_v,
                 float* __restrict__ scale_k,    // [P+1, KV]
                 float* __restrict__ scale_v,
                 const int* __restrict__ bt, const int* __restrict__ pos,
                 const unsigned char* __restrict__ wm, int S, int KV, int hd,
                 int page, int W, float inv_qmax, float eps) {
  __shared__ float red[kScatterThreads / 32];
  const int kv = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int posb = pos[b];
  const int j = posb / page + blockIdx.x;
  if (j >= W) return;
  const long long pid = bt[(long long)b * W + j];
  if (pid < 0) return;  // unallocated: the plain version sends these rows to the trash page
  const int t_lo = max(posb - j * page, 0);
  const int t_hi = min(posb + S - j * page, page);
  if (t_lo >= t_hi) return;
  const long long sidx = pid * KV + kv;
  const float sk_old = scale_k[sidx], sv_old = scale_v[sidx];

  float ak = 0.f, av = 0.f;
  int any = 0;
  for (int i = tid; i < (t_hi - t_lo) * hd; i += kScatterThreads) {
    const int t = t_lo + i / hd, d = i % hd;
    const int s = j * page + t - posb;
    if (wm[(long long)b * S + s]) {
      const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
      ak = fmaxf(ak, fabsf(griffin::to_f32(k_new[n_idx])));
      av = fmaxf(av, fabsf(griffin::to_f32(v_new[n_idx])));
      any = 1;
    }
  }
  if (!__syncthreads_or(any)) return;
  ak = block_max(ak, red, kScatterThreads);
  av = block_max(av, red, kScatterThreads);
  const float sk_new = fmaxf(sk_old, ak * inv_qmax);
  const float sv_new = fmaxf(sv_old, av * inv_qmax);
  const float sk_eff = fmaxf(sk_new, eps), sv_eff = fmaxf(sv_new, eps);

  for (int i = tid; i < page * hd; i += kScatterThreads) {
    const int t = i / hd, d = i % hd;
    const int s = j * page + t - posb;
    const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
    float kf, vf;
    if (s >= 0 && s < S && wm[(long long)b * S + s]) {
      const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
      kf = griffin::to_f32(k_new[n_idx]);
      vf = griffin::to_f32(v_new[n_idx]);
    } else {
      kf = griffin::to_f32(pool_k[g_idx]) * sk_old;
      vf = griffin::to_f32(pool_v[g_idx]) * sv_old;
    }
    pool_k[g_idx] = griffin::quantize<T>(kf / sk_eff);
    pool_v[g_idx] = griffin::quantize<T>(vf / sv_eff);
  }
  if (tid == 0) {  // every thread read the old scales before the first barrier
    scale_k[sidx] = sk_new;
    scale_v[sidx] = sv_new;
  }
}

struct Args {
  const void *q, *k_new, *v_new;
  void *pool_k, *pool_v;
  float *scale_k, *scale_v;
  const int *bt, *pos;
  const unsigned char* wm;
  float* ctx;
  int B, S, H, KV, hd, page, W, window;
  float scale;
  int pps, splits;
  float inv_qmax, eps;
};

// largest cp.async size (16, 8 or 4 bytes) that divides a row and both
// pool addresses
inline int copy_bytes(int row_bytes, const void* pk, const void* pv) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(pk) |
                               reinterpret_cast<unsigned long long>(pv);
  for (int c = 16; c > 4; c /= 2)
    if (row_bytes % c == 0 && a % c == 0) return c;
  return 4;
}

template <typename TIn, typename T, bool kMma>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool kQuant =
      std::is_same<T, int8_t>::value || std::is_same<T, __nv_fp8_e4m3>::value;
  const int SG = a.S * (a.H / a.KV);
  const int n_tiles = (SG + kRows - 1) / kRows;
  const int scatter = kQuant && n_tiles == 1;  // re-encode inside the launch
  if constexpr (kQuant) {
    // several row tiles read a page receiving rows: scatter first.  Pages
    // one request's S new rows can touch: at most (S-1)/page + 2
    const int touched = min(a.W, (a.S + a.page - 2) / a.page + 1);
    if (!scatter && touched > 0) {
      dim3 sgrid(touched, a.KV, a.B);
      kv_quant_scatter<TIn, T><<<sgrid, kScatterThreads, 0, stream>>>(
          static_cast<const TIn*>(a.k_new), static_cast<const TIn*>(a.v_new),
          static_cast<T*>(a.pool_k), static_cast<T*>(a.pool_v), a.scale_k,
          a.scale_v, a.bt, a.pos, a.wm, a.S, a.KV, a.hd, a.page, a.W,
          a.inv_qmax, a.eps);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  const int row_bytes = a.hd * (int)sizeof(T);
  if (a.hd < 4 || a.hd > kMaxHd || (a.hd & (a.hd - 1))) return cudaErrorInvalidValue;
  const Layout L = layout(a.page, a.hd, sizeof(T), a.pps);
  auto* kern = paged_attn_kernel<TIn, T, kMma>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (e != cudaSuccess) return e;
  }
  if (a.splits < 1 || a.splits > kMaxSplits) return cudaErrorInvalidValue;
  // the splits of one (b, kv, row tile) run as one thread block cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * a.splits, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TIn*>(a.q), static_cast<const TIn*>(a.k_new),
      static_cast<const TIn*>(a.v_new), static_cast<T*>(a.pool_k),
      static_cast<T*>(a.pool_v), a.scale_k, a.scale_v, a.bt, a.pos, a.wm,
      a.ctx, a.S, a.H, a.KV, a.hd, a.page, a.W, a.window, a.scale, a.pps,
      a.splits, scatter, a.inv_qmax, a.eps,
      copy_bytes(row_bytes, a.pool_k, a.pool_v));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// bf16 queries take the tensor-core QK^T when the pool is bf16 or
// quantized and head_dim is a multiple of the mma depth
template <typename T>
cudaError_t launch_bf16_q(const Args& a, cudaStream_t stream) {
  if (a.hd % 16 == 0) return launch<__nv_bfloat16, T, true>(a, stream);
  return launch<__nv_bfloat16, T, false>(a, stream);
}

Args make_args(const void* q, const void* k_new, const void* v_new,
               void* pool_k, void* pool_v, void* scale_k, void* scale_v,
               const void* bt, const void* pos, const void* wm, void* ctx,
               int B, int S, int H, int KV, int hd, int page, int W,
               int window, float scale, int pps, int splits, float inv_qmax,
               float eps) {
  return Args{q, k_new, v_new, pool_k, pool_v,
              static_cast<float*>(scale_k), static_cast<float*>(scale_v),
              static_cast<const int*>(bt), static_cast<const int*>(pos),
              static_cast<const unsigned char*>(wm), static_cast<float*>(ctx),
              B, S, H, KV, hd, page, W, window, scale, pps, splits, inv_qmax,
              eps};
}

}  // namespace

// q/k_new/v_new in the model dtype (fp32 or bf16), pools fp32 or bf16,
// ctx fp32; block tables, positions int32; write mask one byte per row.
// splits <= 8 (one cluster); rows_per_cta must be the compiled row tile
// (else cudaErrorInvalidValue).
extern "C" int paged_attn(const void* q, const void* k_new, const void* v_new,
                          void* pool_k, void* pool_v, const void* bt,
                          const void* pos, const void* wm, void* ctx, int B,
                          int S, int H, int KV, int hd, int page, int W,
                          int window, float scale, int pages_per_split,
                          int splits, int rows_per_cta, int in_is_bf16,
                          int pool_is_bf16, void* stream) {
  if (rows_per_cta != kRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = make_args(q, k_new, v_new, pool_k, pool_v, nullptr, nullptr,
                           bt, pos, wm, ctx, B, S,
                           H, KV, hd, page, W, window, scale, pages_per_split,
                           splits, 0.f, 0.f);
  cudaError_t e;
  if (in_is_bf16 && pool_is_bf16)
    e = launch_bf16_q<__nv_bfloat16>(a, st);
  else if (in_is_bf16)
    e = launch<__nv_bfloat16, float, false>(a, st);
  else if (pool_is_bf16)
    e = launch<float, __nv_bfloat16, false>(a, st);
  else
    e = launch<float, float, false>(a, st);
  return static_cast<int>(e);
}

// The same over quantized pools: int8 (pool_is_fp8 = 0) or fp8 e4m3 bits,
// scale pools [P+1, 1, KV, 1] fp32 updated in place; inv_qmax = 1/qmax and
// eps = kv_quant.EPS, both already rounded to fp32 by the caller.
extern "C" int paged_attn_quant(const void* q, const void* k_new,
                                const void* v_new, void* pool_k, void* pool_v,
                                void* scale_k, void* scale_v, const void* bt,
                                const void* pos, const void* wm, void* ctx,
                                int B, int S, int H, int KV, int hd, int page,
                                int W, int window, float scale,
                                int pages_per_split, int splits,
                                int rows_per_cta, int in_is_bf16,
                                int pool_is_fp8, float inv_qmax, float eps,
                                void* stream) {
  if (rows_per_cta != kRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = make_args(q, k_new, v_new, pool_k, pool_v, scale_k, scale_v,
                           bt, pos, wm, ctx, B, S,
                           H, KV, hd, page, W, window, scale, pages_per_split,
                           splits, inv_qmax, eps);
  cudaError_t e;
  if (in_is_bf16 && pool_is_fp8)
    e = launch_bf16_q<__nv_fp8_e4m3>(a, st);
  else if (in_is_bf16)
    e = launch_bf16_q<int8_t>(a, st);
  else if (pool_is_fp8)
    e = launch<float, __nv_fp8_e4m3, false>(a, st);
  else
    e = launch<float, int8_t, false>(a, st);
  return static_cast<int>(e);
}
