// Dense GLU FF forward on Hopper:
//   y = (act(x . Wg) * (x . W1)) . W2,  fp32 out,
// x [M, D], Wg/W1 [D, F], W2 [F, D].
//
// Replaces: repro/kernels/glu_ffn.py::glu_ffn / _kernel (Pallas, TPU),
// entry point ops.glu_ffn_forward.  Unlike the TPU kernel it takes any F
// (no F % 512 tile constraint: Yi-9B's F = 11008 is not a multiple of 512).
//
// Bound on the H100: at a prefill chunk of M = 32 rows the weight bytes
// (3 * D * F * itemsize over 3.35 TB/s) dominate the operations
// (6 * M * D * F) at the bf16 tensor-core rate; with plain fp32 FMA, as
// here, the operations are what the kernel actually runs into.
//
// Design (two launches plus the split reduction, no library call):
// * Pass 1 (glu_ffn_up): one thread per neuron (a column of Wg and W1, so
//   a warp reads 32 neighbouring elements of a weight row), 64 neurons
//   per CTA, MT rows of x per CTA staged in shared memory kChunk features
//   at a time; fp32 accumulators for g and h of every row; z = act(g) * h
//   rounded to x's dtype, as the TPU kernel rounds before its second dot.
// * Pass 2 (ffn_common.cuh): y = z . W2 with one thread per output column,
//   the F rows split over CTAs and the splits summed in order, so the
//   result is the same from run to run.
// This version uses plain FMA loops, no tensor cores or TMA.

#include "ffn_common.cuh"

namespace {

constexpr int kNeurons = 64;  // threads (neurons) of a pass-1 CTA
constexpr int kChunk = 64;    // features of x staged per step

template <typename T, int MT>
__global__ void __launch_bounds__(kNeurons)
glu_ffn_up(const T* __restrict__ x,   // [M, D]
           const T* __restrict__ wg,  // [D, F]
           const T* __restrict__ w1,  // [D, F]
           T* __restrict__ z,         // [M, F]
           int M, int D, int F, int act) {
  __shared__ float xs[MT][kChunk];
  const int tid = threadIdx.x;
  const int f = blockIdx.x * kNeurons + tid;
  const int m0 = blockIdx.y * MT;
  const int mc = min(MT, M - m0);
  float ag[MT], ah[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) ag[m] = ah[m] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int dk = min(kChunk, D - d0);
    __syncthreads();  // the previous step's xs is consumed
    for (int i = tid; i < MT * kChunk; i += kNeurons) {
      const int m = i / kChunk, k = i % kChunk;
      xs[m][k] = (m < mc && k < dk)
                     ? griffin::to_f32(x[(long long)(m0 + m) * D + d0 + k])
                     : 0.f;
    }
    __syncthreads();
    if (f < F) {
#pragma unroll 4
      for (int k = 0; k < dk; ++k) {
        const long long w_idx = (long long)(d0 + k) * F + f;
        const float a = griffin::to_f32(wg[w_idx]);
        const float c = griffin::to_f32(w1[w_idx]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ag[m] += xs[m][k] * a;
          ah[m] += xs[m][k] * c;
        }
      }
    }
  }
  if (f < F) {
    for (int m = 0; m < mc; ++m)
      z[(long long)(m0 + m) * F + f] =
          griffin::from_f32<T>(griffin::glu_act(ag[m], act) * ah[m]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* w1,
                   const void* w2, void* z, float* part, float* y, int M,
                   int D, int F, int act, int n_sm, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* zp = static_cast<T*>(z);
  if (M <= 4) {
    dim3 grid((F + kNeurons - 1) / kNeurons, (M + 3) / 4);
    glu_ffn_up<T, 4><<<grid, kNeurons, 0, stream>>>(
        xp, static_cast<const T*>(wg), static_cast<const T*>(w1), zp, M, D,
        F, act);
  } else {
    dim3 grid((F + kNeurons - 1) / kNeurons, (M + 15) / 16);
    glu_ffn_up<T, 16><<<grid, kNeurons, 0, stream>>>(
        xp, static_cast<const T*>(wg), static_cast<const T*>(w1), zp, M, D,
        F, act);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return griffin::launch_down<T>(zp, static_cast<const T*>(w2), nullptr, part,
                                 y, M, F, D, 1, n_sm, stream);
}

}  // namespace

// x [M, D], wg/w1 [D, F], w2 [F, D] in one dtype (fp32 or bf16); z [M, F]
// scratch in x's dtype; part [splits, M, D] fp32 scratch, splits =
// ffn_down_splits(M, F, D, n_sm) (may be null when that is 1); y [M, D]
// fp32.  act: 0 swiglu, 1 geglu (tanh), 2 reglu.  n_sm: the card's SM
// count.
extern "C" int glu_ffn(const void* x, const void* wg, const void* w1,
                       const void* w2, void* z, void* part, void* y, int M,
                       int D, int F, int act, int n_sm, int is_bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(part);
  auto* yp = static_cast<float*>(y);
  cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(x, wg, w1, w2, z, pp, yp, M, D, F, act,
                                      n_sm, st)
              : launch<float>(x, wg, w1, w2, z, pp, yp, M, D, F, act, n_sm,
                              st);
  return static_cast<int>(e);
}
