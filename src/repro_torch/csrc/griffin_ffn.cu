// GRIFFIN's zero-copy pruned decode FF on Hopper:
//   y = (act(x . Wg_sel^T) * (x . W1_sel^T)) . W2_sel,  fp32 out,
// over the selected blocks of `bs` neuron rows of the [F, D] weights.
//
// Replaces: repro/kernels/griffin_ffn.py::griffin_ffn / _kernel (Pallas,
// TPU), entry point ops.griffin_ffn_decode.
//
// Bound on the H100: bytes.  At decode (B rows of x, B small) every
// selected weight element is read once and used B times, so the
// 3 * n_sel * D * itemsize weight bytes over 3.35 TB/s bound the call; the
// operations (6 * B * n_sel * D) are far below the bf16 ridge.
//
// Design (two launches plus the split reduction, no library call):
// * Pass 1 (griffin_ffn_up): one warp per selected neuron, 8 per CTA.  The
//   neuron's Wg and W1 rows (block_ids[n / bs] * bs + n % bs, read in
//   place: no compacted copy) stream through the warp in 16-byte vectors,
//   each lane accumulating the dot products of up to MT rows of x in fp32;
//   x is small and stays in L1.  A warp reduction finishes g and h; lane 0
//   stores z = act(g) * h rounded to x's dtype, as the TPU kernel rounds
//   before its second dot.  Rows of x beyond MT go to further grid rows.
// * Pass 2 (ffn_common.cuh): y = z . W2_sel with one thread per output
//   column, the selected rows split over CTAs and the splits summed in
//   order, so the result is the same from run to run.
// This version uses plain FMA loops, no tensor cores or TMA.

#include "ffn_common.cuh"

namespace {

constexpr int kWarps = 8;  // neurons (warps) per CTA of pass 1

template <typename T>
struct Vec;  // 16 bytes of T as floats

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int MT>
__global__ void __launch_bounds__(kWarps * 32)
griffin_ffn_up(const T* __restrict__ x,            // [M, D]
               const T* __restrict__ wg,           // [F, D]
               const T* __restrict__ w1,           // [F, D]
               const int* __restrict__ block_ids,  // [n_sel / bs]
               T* __restrict__ z,                  // [M, n_sel]
               int M, int D, int n_sel, int bs, int act, int vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_sel) return;  // no barrier below: whole warps leave
  const int m0 = blockIdx.y * MT;
  const int mc = min(MT, M - m0);
  const long long r = (long long)block_ids[n / bs] * bs + n % bs;
  const T* wgr = wg + r * D;
  const T* w1r = w1 + r * D;
  const T* xr = x + (long long)m0 * D;
  float ag[MT], ah[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) ag[m] = ah[m] = 0.f;

  constexpr int V = Vec<T>::N;
  int d_tail = 0;
  if (vec) {  // D % V == 0 and 16-byte aligned rows
    for (int d0 = lane * V; d0 < D; d0 += 32 * V) {
      float a[V], c[V];
      Vec<T>::load(wgr + d0, a);
      Vec<T>::load(w1r + d0, c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mc) {
          float xv[V];
          Vec<T>::load(xr + (long long)m * D + d0, xv);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            ag[m] += xv[k] * a[k];
            ah[m] += xv[k] * c[k];
          }
        }
      }
    }
    d_tail = D;
  }
  for (int d = d_tail + lane; d < D; d += 32) {
    const float a = griffin::to_f32(wgr[d]), c = griffin::to_f32(w1r[d]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mc) {
        const float xv = griffin::to_f32(xr[(long long)m * D + d]);
        ag[m] += xv * a;
        ah[m] += xv * c;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ag[m] += __shfl_xor_sync(0xffffffffu, ag[m], o);
      ah[m] += __shfl_xor_sync(0xffffffffu, ah[m], o);
    }
  }
  if (lane == 0) {
    for (int m = 0; m < mc; ++m)
      z[(long long)(m0 + m) * n_sel + n] =
          griffin::from_f32<T>(griffin::glu_act(ag[m], act) * ah[m]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* w1,
                   const void* w2, const int* block_ids, void* z, float* part,
                   float* y, int M, int D, int n_sel, int bs, int act, int vec,
                   int n_sm, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* zp = static_cast<T*>(z);
  if (M <= 4) {
    dim3 grid((n_sel + kWarps - 1) / kWarps, (M + 3) / 4);
    griffin_ffn_up<T, 4><<<grid, kWarps * 32, 0, stream>>>(
        xp, static_cast<const T*>(wg), static_cast<const T*>(w1), block_ids,
        zp, M, D, n_sel, bs, act, vec);
  } else {
    dim3 grid((n_sel + kWarps - 1) / kWarps, (M + 7) / 8);
    griffin_ffn_up<T, 8><<<grid, kWarps * 32, 0, stream>>>(
        xp, static_cast<const T*>(wg), static_cast<const T*>(w1), block_ids,
        zp, M, D, n_sel, bs, act, vec);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return griffin::launch_down<T>(zp, static_cast<const T*>(w2), block_ids,
                                 part, y, M, n_sel, D, bs, n_sm, stream);
}

}  // namespace

// x [M, D], wg/w1/w2 [F, D] in one dtype (fp32 or bf16); block_ids
// [n_sel / bs] int32; z [M, n_sel] scratch in x's dtype; part [splits, M,
// D] fp32 scratch, splits = ffn_down_splits(M, n_sel, D, n_sm) (may be
// null when that is 1); y [M, D] fp32.  act: 0 swiglu, 1 geglu (tanh), 2
// reglu.  vec: rows may be read as 16-byte vectors (D a multiple of 16
// bytes, aligned pointers).  n_sm: the card's SM count.
extern "C" int griffin_ffn(const void* x, const void* wg, const void* w1,
                           const void* w2, const void* block_ids, void* z,
                           void* part, void* y, int M, int D, int n_sel,
                           int bs, int act, int vec, int n_sm, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ids = static_cast<const int*>(block_ids);
  auto* pp = static_cast<float*>(part);
  auto* yp = static_cast<float*>(y);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(x, wg, w1, w2, ids, z, pp, yp, M, D,
                                      n_sel, bs, act, vec, n_sm, st)
              : launch<float>(x, wg, w1, w2, ids, z, pp, yp, M, D, n_sel, bs,
                              act, vec, n_sm, st);
  return static_cast<int>(e);
}
