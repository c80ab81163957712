// GRIFFIN eq. 6 statistic on Hopper.
//
// Replaces: repro/kernels/expert_stat.py::expert_stat (Pallas, TPU),
// the function the reference model computes in ffn.griffin_stat_sq.
//
//   s_sq[b, j] = sum_t z[b,t,j]^2 * inv[b,t],  inv = 1/||z[b,t]||^2 (0 if 0)
//
// Bound on the H100: bytes.  The work is 3 flops per element read once,
// far below the ~20 flop/byte an fp32 pass needs to leave the memory
// bound, so the least time is B*S*F*itemsize / 3.35 TB/s.
//
// Design: two deterministic passes and no atomics, because s_sq feeds a
// top-k and a run-to-run change of sum order could change the selected
// experts and so the tokens.
//   pass 1: one CTA per row (b, t) reduces ||z[b,t]||^2 in a fixed tree
//           and stores inv[b, t];
//   pass 2: one thread per column j walks t = 0..S-1 in order; threads of
//           a warp read neighbouring columns, so every load is coalesced.
// The TPU kernel's 256-token tile loop becomes pass 2's in-thread loop.
// z is read twice; at prefill chunk sizes (S = 32) the second read is an
// L2 hit.

#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_inv_kernel(const T* __restrict__ z, float* __restrict__ inv, int F) {
  const T* row = z + (long long)blockIdx.x * F;
  float acc = 0.f;
  for (int f = threadIdx.x; f < F; f += kRowThreads) {
    const float v = griffin::to_f32(row[f]);
    acc += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kRowThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kRowThreads / 32; ++w) total += warp_sums[w];
    inv[blockIdx.x] = total > 0.f ? 1.f / total : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_sum_kernel(const T* __restrict__ z, const float* __restrict__ inv,
               float* __restrict__ out, int S, int F) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= F) return;
  const T* zb = z + (long long)b * S * F;
  const float* invb = inv + (long long)b * S;
  float acc = 0.f;
  for (int t = 0; t < S; ++t) {
    const float v = griffin::to_f32(zb[(long long)t * F + j]);
    acc += (v * v) * invb[t];
  }
  out[(long long)b * F + j] = acc;
}

template <typename T>
void launch(const void* z, void* inv, void* out, int B, int S, int F,
            cudaStream_t stream) {
  row_inv_kernel<T><<<B * S, kRowThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<float*>(inv), F);
  dim3 grid((F + kColThreads - 1) / kColThreads, B);
  col_sum_kernel<T><<<grid, kColThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(inv),
      static_cast<float*>(out), S, F);
}

}  // namespace

// z [B, S, F] fp32 or bf16, inv [B, S] fp32 scratch, out [B, F] fp32.
extern "C" int expert_stat(const void* z, void* inv, void* out, int B, int S,
                           int F, int z_is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (z_is_bf16)
    launch<__nv_bfloat16>(z, inv, out, B, S, F, st);
  else
    launch<float>(z, inv, out, B, S, F, st);
  return static_cast<int>(cudaGetLastError());
}
