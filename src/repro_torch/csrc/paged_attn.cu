// Fused paged attention on Hopper: K/V scatter + online-softmax GQA
// attention over the pages each request owns.
//
// Replaces: repro/kernels/paged_attn.py::paged_attn / _kernel (Pallas,
// TPU), fp32 and bf16 pools, and its quantized body (int8 / fp8 e4m3
// pools behind per-(page, kv-head) fp32 scales).  Every attention layer
// of every prefill chunk and decode tick runs it.
//
// Bound on the H100: bytes at decode.  Each (b, kv) reads its live pages
// once, sum_b ceil((pos_b+S)/page) * page * KV * hd * 2 * itemsize per
// layer over 3.35 TB/s; the flops (4 * S*G * context * hd per (b, kv))
// are far below the bf16 ridge until S*G reaches the hundreds.
//
// Design:
// * Grid (row tiles x page splits, KV, B).  The S*G query rows of one
//   (b, kv) are cut into tiles of kRows rows (a prefill chunk at Yi-9B
//   width, S*G = 32*8 = 256 rows, is 16 tiles; a decode step, 8 rows, is
//   one), and the W block-table columns into `splits` ranges of
//   `pages_per_split` pages, chosen by the wrapper so that a decode step
//   at small batch still fills the card.  The TPU grid's sequential page
//   axis becomes a loop inside the CTA over its range, clipped to
//   num_pages[b] = min(ceil((pos+S)/page), allocated pages), which each
//   CTA counts from its block-table row (no host sync).
// * Per page the CTA stages K and V for its kv head in shared memory as
//   fp32, merging the step's new rows: slot t takes new row s iff
//   j*page + t == pos + s and write_mask[b, s].  A merged value is the
//   row rounded to the pool dtype (bf16: round to nearest even) and then
//   upcast, exactly what the TPU kernel attends.  The staging loop only
//   loads, so a thread's loads of one page are in flight together.
// * Scores, the running max/normalizer and the fp32 accumulator follow
//   the TPU kernel's recurrence: NEG_INF = -2e38 is finite, masked
//   entries get probability 0 by an explicit test (a fully masked row
//   keeps m = NEG_INF and exp(0) = 1 must not count), and rows with no
//   weight finalize to 0.  window > 0 skips whole pages below the window.
// * With one split the CTA finalizes ctx itself.  With more, each CTA
//   stores its unnormalized accumulator and (max, sum) per row, and a
//   second kernel merges the splits in split order: deterministic, no
//   atomics.
// * Write-back, the one place the TPU body is not copied: the Pallas
//   kernel rewrites every visited page, which is safe only because TPU
//   grid steps run in order.  Here only the slots that received new rows
//   are written, and only by the row-tile-0 CTA of the split that owns
//   the page; other tiles merge the same rows into their own
//   shared-memory copy and never use those slots' memory, so nothing
//   depends on write order.  By the copy-on-write contract those pages
//   belong to this request alone; shared read-only pages and the trash
//   page are never written.
// * Shared-memory rows of K and Q are padded by one float so the score
//   loop, where a warp walks page slots at a fixed feature, does not hit
//   one bank 16 or 32 times.
// * Quantized pools (int8, fp8) take another order, because a page is
//   re-encoded as a whole when its scale grows: old rows change, and a
//   CTA of another row tile or split reading that page while it is
//   rewritten would see bits and a scale torn between old and new.  So
//   a first launch (kv_quant_scatter), one CTA per (b, page touched this
//   step, kv), does the whole scatter: amax over the page's new rows,
//   s_new = max(s_old, amax * (1/qmax)), every slot re-encoded as
//   q(bits * s_old / max(s_new, EPS)) or, for a new row,
//   q(row / max(s_new, EPS)), then s_new stored.  Pages that receive no
//   row keep bits and scale (the re-encode would be the identity).  The
//   attention launch that follows on the stream reads bits * s_new in
//   fp32 and merges and writes nothing.  IEEE division and no fast math
//   keep the bits those of kernels/kv_quant.py.
// This version uses plain FMA loops, no tensor cores or TMA.

#include "common.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kRows = 16;
constexpr int kThreads = 128;

__host__ __device__ inline int smem_floats(int page, int hd) {
  return page * (hd + 1)      // K page (padded rows)
         + page * hd          // V page
         + kRows * (hd + 1)   // queries (padded rows)
         + kRows * hd         // accumulator
         + kRows * page       // scores / probabilities
         + 3 * kRows;         // running max, normalizer, rescale factor
}

__device__ __forceinline__ bool is_valid(int kpos, int qpos, int window) {
  return kpos <= qpos && (window == 0 || kpos > qpos - window);
}

template <typename TIn, typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TIn* __restrict__ q,      // [B, S, H, hd]
                  const TIn* __restrict__ k_new,  // [B, S, KV, hd]
                  const TIn* __restrict__ v_new,  // [B, S, KV, hd]
                  T* __restrict__ pool_k,         // [P+1, page, KV, hd]
                  T* __restrict__ pool_v,
                  const float* __restrict__ scale_k,  // [P+1, KV] (kQuant)
                  const float* __restrict__ scale_v,
                  const int* __restrict__ bt,     // [B, W]
                  const int* __restrict__ pos,    // [B]
                  const unsigned char* __restrict__ wm,  // [B, S]
                  float* __restrict__ ctx,        // [B, S, H, hd]
                  float* __restrict__ part_acc,   // [B, KV, splits, S*G, hd]
                  float* __restrict__ part_ml,    // [B, KV, splits, S*G, 2]
                  int S, int H, int KV, int hd, int page, int W, int window,
                  float scale, int pages_per_split, int splits) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* ks = smem;
  float* vs = ks + page * hdp;
  float* qs = vs + page * hd;
  float* acc = qs + kRows * hdp;
  float* ps = acc + kRows * hd;
  float* m_run = ps + kRows * page;
  float* l_run = m_run + kRows;
  float* alpha = l_run + kRows;

  const int G = H / KV;
  const int SG = S * G;
  const int n_tiles = (SG + kRows - 1) / kRows;
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r0 = tile * kRows;
  const int nr = min(kRows, SG - r0);
  const int posb = pos[b];
  // owned pages: tables are prefix-allocated, so count the non-negative
  // entries of row b
  int n_alloc = 0;
  for (int j0 = 0; j0 < W; j0 += kThreads) {
    const int j = j0 + tid;
    n_alloc += __syncthreads_count(j < W && bt[(long long)b * W + j] >= 0);
  }
  const int npb = min((posb + S + page - 1) / page, n_alloc);
  const int j_begin = split * pages_per_split;
  const int j_end = min(j_begin + pages_per_split, npb);

  // query rows r0..r0+nr of (b, kv): row R = s*G + g is head kv*G + g
  for (int i = tid; i < nr * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int R = r0 + r, s = R / G, g = R % G;
    qs[r * hdp + d] =
        griffin::to_f32(q[(((long long)b * S + s) * H + kv * G + g) * hd + d]);
    acc[r * hd + d] = 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    // whole pages below every query's window contribute nothing (and no
    // new row lands there: new rows sit at positions >= pos)
    if (window > 0 && j * page + page - 1 <= posb - window) continue;
    const long long pid = bt[(long long)b * W + j];

    // -- stage the page, merging the step's new rows (loads only) ---------
    if constexpr (!kQuant) {
      for (int i = tid; i < page * hd; i += kThreads) {
        const int t = i / hd, d = i % hd;
        const int s = j * page + t - posb;
        float kval, vval;
        if (s >= 0 && s < S && wm[(long long)b * S + s]) {
          const long long n_idx = (((long long)b * S + s) * KV + kv) * hd + d;
          kval = griffin::to_f32(
              griffin::from_f32<T>(griffin::to_f32(k_new[n_idx])));
          vval = griffin::to_f32(
              griffin::from_f32<T>(griffin::to_f32(v_new[n_idx])));
        } else {
          const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
          kval = griffin::to_f32(pool_k[g_idx]);
          vval = griffin::to_f32(pool_v[g_idx]);
        }
        ks[t * hdp + d] = kval;
        vs[t * hd + d] = vval;
      }
    } else {
      // kv_quant_scatter already wrote this step's rows and scales
      const float sk = scale_k[pid * KV + kv], sv = scale_v[pid * KV + kv];
      for (int i = tid; i < page * hd; i += kThreads) {
        const int t = i / hd, d = i % hd;
        const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
        ks[t * hdp + d] = griffin::to_f32(pool_k[g_idx]) * sk;
        vs[t * hd + d] = griffin::to_f32(pool_v[g_idx]) * sv;
      }
    }
    __syncthreads();

    // -- write the new rows of this page back (one CTA per page) ----------
    // ks/vs hold them rounded to T, so the casts back are exact
    if constexpr (!kQuant) {
      if (tile == 0) {
        const int t_lo = max(posb - j * page, 0);
        const int t_hi = min(posb + S - j * page, page);
        for (int i = tid; i < (t_hi - t_lo) * hd; i += kThreads) {
          const int t = t_lo + i / hd, d = i % hd;
          if (wm[(long long)b * S + j * page + t - posb]) {
            const long long g_idx = ((pid * page + t) * KV + kv) * hd + d;
            pool_k[g_idx] = griffin::from_f32<T>(ks[t * hdp + d]);
            pool_v[g_idx] = griffin::from_f32<T>(vs[t * hd + d]);
          }
        }
      }
    }

    // -- scores -----------------------------------------------------------
    for (int i = tid; i < nr * page; i += kThreads) {
      const int r = i / page, t = i % page;
      const int qpos = posb + (r0 + r) / G;
      const int kpos = j * page + t;
      float sc = kNegInf;
      if (is_valid(kpos, qpos, window)) {
        const float* qr = qs + r * hdp;
        const float* kr = ks + t * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        sc = dot * scale;
      }
      ps[r * page + t] = sc;
    }
    __syncthreads();

    // -- online softmax, one thread per row ----------------------------
    for (int r = tid; r < nr; r += kThreads) {
      const int qpos = posb + (r0 + r) / G;
      const float m_prev = m_run[r];
      float m_new = m_prev;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, ps[r * page + t]);
      const float a = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = is_valid(j * page + t, qpos, window)
                            ? expf(ps[r * page + t] - m_new)
                            : 0.f;
        ps[r * page + t] = p;
        sum += p;
      }
      l_run[r] = l_run[r] * a + sum;
      m_run[r] = m_new;
      alpha[r] = a;
    }
    __syncthreads();

    // -- acc = acc * alpha + p @ V --------------------------------------
    for (int i = tid; i < nr * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float v = acc[i] * alpha[r];
      const float* pr = ps + r * page;
      for (int t = 0; t < page; ++t) v += pr[t] * vs[t * hd + d];
      acc[i] = v;
    }
    __syncthreads();
  }

  if (splits == 1) {
    // -- finalize: acc / l, or 0 where no key carried weight -------------
    for (int i = tid; i < nr * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const int R = r0 + r, s = R / G, g = R % G;
      const float l = l_run[r];
      ctx[(((long long)b * S + s) * H + kv * G + g) * hd + d] =
          l > 0.f ? acc[i] / l : 0.f;
    }
    return;
  }
  // -- partial result of this split (an empty range stores m = NEG_INF,
  //    l = 0, acc = 0, which the merge weighs by 0) ----------------------
  const long long row0 = (((long long)b * KV + kv) * splits + split) * SG + r0;
  for (int i = tid; i < nr * hd; i += kThreads) part_acc[row0 * hd + i] = acc[i];
  for (int r = tid; r < nr; r += kThreads) {
    part_ml[(row0 + r) * 2] = m_run[r];
    part_ml[(row0 + r) * 2 + 1] = l_run[r];
  }
}

// threads of a scatter CTA: a (page, kv) slice is page * hd elements
// (2048 at Yi-9B shapes), and the few CTAs of a decode step need many
// warps each to hide the latency of their per-element work
constexpr int kScatterThreads = 512;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kScatterThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// The quantized scatter: one CTA per (b, page j touched this step, kv),
// grid (touched-page slots, KV, B); page j = pos[b] / page + blockIdx.x.
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

  // amax of the page's new rows (rows with write_mask unset are not written)
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
  if (!__syncthreads_or(any)) return;  // no row: scale and bits unchanged
  ak = block_max(ak, red);
  av = block_max(av, red);
  const float sk_new = fmaxf(sk_old, ak * inv_qmax);
  const float sv_new = fmaxf(sv_old, av * inv_qmax);
  const float sk_eff = fmaxf(sk_new, eps), sv_eff = fmaxf(sv_new, eps);

  // re-encode the whole (page, kv) slice; new rows replace their slots
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

// ctx[b, s, kv*G + g, d] from the splits of row R = s*G + g, in split order
__global__ void __launch_bounds__(kThreads)
paged_attn_merge(const float* __restrict__ part_acc,
                 const float* __restrict__ part_ml, float* __restrict__ ctx,
                 int S, int H, int KV, int hd, int splits) {
  const int G = H / KV, SG = S * G;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= SG * hd) return;
  const int R = i / hd, d = i % hd;
  const long long row0 = ((long long)b * KV + kv) * splits * SG + R;
  float m = kNegInf;
  for (int sp = 0; sp < splits; ++sp)
    m = fmaxf(m, part_ml[(row0 + (long long)sp * SG) * 2]);
  float l = 0.f, a = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const long long row = row0 + (long long)sp * SG;
    const float f = expf(part_ml[row * 2] - m);
    l += part_ml[row * 2 + 1] * f;
    a += part_acc[row * hd + d] * f;
  }
  const int s = R / G, g = R % G;
  ctx[(((long long)b * S + s) * H + kv * G + g) * hd + d] = l > 0.f ? a / l : 0.f;
}

template <typename TIn, typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* pool_k, void* pool_v, float* scale_k, float* scale_v,
                   const int* bt, const int* pos, const unsigned char* wm,
                   float* ctx, float* part_acc, float* part_ml, int B, int S,
                   int H, int KV, int hd, int page, int W, int window,
                   float scale, int pages_per_split, int splits,
                   float inv_qmax, float eps, cudaStream_t stream) {
  if constexpr (kQuant) {
    // pages one request's S new rows can touch: at most (S-1)/page + 2
    const int touched = min(W, (S + page - 2) / page + 1);
    if (touched > 0) {
      dim3 sgrid(touched, KV, B);
      kv_quant_scatter<TIn, T><<<sgrid, kScatterThreads, 0, stream>>>(
          static_cast<const TIn*>(k_new), static_cast<const TIn*>(v_new),
          static_cast<T*>(pool_k), static_cast<T*>(pool_v), scale_k, scale_v,
          bt, pos, wm, S, KV, hd, page, W, inv_qmax, eps);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  const size_t smem = sizeof(float) * smem_floats(page, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<TIn, T, kQuant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int SG = S * (H / KV);
  dim3 grid(((SG + kRows - 1) / kRows) * splits, KV, B);
  paged_attn_kernel<TIn, T, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k_new),
      static_cast<const TIn*>(v_new), static_cast<T*>(pool_k),
      static_cast<T*>(pool_v), scale_k, scale_v, bt, pos, wm, ctx, part_acc,
      part_ml, S, H, KV, hd, page, W, window, scale, pages_per_split, splits);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 mgrid((SG * hd + kThreads - 1) / kThreads, KV, B);
    paged_attn_merge<<<mgrid, kThreads, 0, stream>>>(part_acc, part_ml, ctx, S,
                                                     H, KV, hd, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// q/k_new/v_new in the model dtype (fp32 or bf16), pools fp32 or bf16,
// ctx fp32; block tables, positions int32; write mask one byte per row.
// part_acc [B, KV, splits, S*G, hd] and part_ml [B, KV, splits, S*G, 2]
// are fp32 scratch, unused (may be null) when splits == 1.
extern "C" int paged_attn(const void* q, const void* k_new, const void* v_new,
                          void* pool_k, void* pool_v, const void* bt,
                          const void* pos, const void* wm, void* ctx,
                          void* part_acc, void* part_ml, int B, int S, int H,
                          int KV, int hd, int page, int W, int window,
                          float scale, int pages_per_split, int splits,
                          int in_is_bf16, int pool_is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* btp = static_cast<const int*>(bt);
  auto* posp = static_cast<const int*>(pos);
  auto* wmp = static_cast<const unsigned char*>(wm);
  auto* out = static_cast<float*>(ctx);
  auto* pa = static_cast<float*>(part_acc);
  auto* pml = static_cast<float*>(part_ml);
  cudaError_t e;
#define PAGED_ATTN_LAUNCH(TIn, T)                                              \
  launch<TIn, T, false>(q, k_new, v_new, pool_k, pool_v, nullptr, nullptr,    \
                        btp, posp, wmp, out, pa, pml, B, S, H, KV, hd, page, \
                        W, window, scale, pages_per_split, splits, 0.f, 0.f, \
                        st)
  if (in_is_bf16 && pool_is_bf16)
    e = PAGED_ATTN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (in_is_bf16)
    e = PAGED_ATTN_LAUNCH(__nv_bfloat16, float);
  else if (pool_is_bf16)
    e = PAGED_ATTN_LAUNCH(float, __nv_bfloat16);
  else
    e = PAGED_ATTN_LAUNCH(float, float);
#undef PAGED_ATTN_LAUNCH
  return static_cast<int>(e);
}

// The same over quantized pools: int8 (pool_is_fp8 = 0) or fp8 e4m3 bits,
// scale pools [P+1, 1, KV, 1] fp32 updated in place; inv_qmax = 1/qmax and
// eps = kv_quant.EPS, both already rounded to fp32 by the caller.
extern "C" int paged_attn_quant(const void* q, const void* k_new,
                                const void* v_new, void* pool_k, void* pool_v,
                                void* scale_k, void* scale_v, const void* bt,
                                const void* pos, const void* wm, void* ctx,
                                void* part_acc, void* part_ml, int B, int S,
                                int H, int KV, int hd, int page, int W,
                                int window, float scale, int pages_per_split,
                                int splits, int in_is_bf16, int pool_is_fp8,
                                float inv_qmax, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* sk = static_cast<float*>(scale_k);
  auto* sv = static_cast<float*>(scale_v);
  auto* btp = static_cast<const int*>(bt);
  auto* posp = static_cast<const int*>(pos);
  auto* wmp = static_cast<const unsigned char*>(wm);
  auto* out = static_cast<float*>(ctx);
  auto* pa = static_cast<float*>(part_acc);
  auto* pml = static_cast<float*>(part_ml);
  cudaError_t e;
#define PAGED_ATTN_LAUNCH(TIn, T)                                             \
  launch<TIn, T, true>(q, k_new, v_new, pool_k, pool_v, sk, sv, btp, posp,   \
                       wmp, out, pa, pml, B, S, H, KV, hd, page, W, window, \
                       scale, pages_per_split, splits, inv_qmax, eps, st)
  if (in_is_bf16 && pool_is_fp8)
    e = PAGED_ATTN_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3);
  else if (in_is_bf16)
    e = PAGED_ATTN_LAUNCH(__nv_bfloat16, int8_t);
  else if (pool_is_fp8)
    e = PAGED_ATTN_LAUNCH(float, __nv_fp8_e4m3);
  else
    e = PAGED_ATTN_LAUNCH(float, int8_t);
#undef PAGED_ATTN_LAUNCH
  return static_cast<int>(e);
}
