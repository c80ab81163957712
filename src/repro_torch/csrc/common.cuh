// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by repro_torch/kernels/backend.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace griffin {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// quantized KV pages (int8 bits, float8_e4m3fn bits): exact upcasts
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// round to nearest even, as the reference's astype(bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// KV quantization (repro_torch/kernels/kv_quant.py::quantize) of a value
// already divided by its scale: int8 rounds half to even (rintf under the
// default rounding mode) and clips to +-127; fp8 e4m3 rounds to nearest
// even and saturates (the monotone scale keeps |v| <= 448 up to rounding)
template <typename T>
__device__ __forceinline__ T quantize(float v);

template <>
__device__ __forceinline__ int8_t quantize<int8_t>(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

template <>
__device__ __forceinline__ __nv_fp8_e4m3 quantize<__nv_fp8_e4m3>(float v) {
  __nv_fp8_e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return r;
}

// activations of the GLU FF kernels (repro_torch/kernels/ref.py::_act):
// 0 swiglu (silu), 1 geglu (tanh-approximate gelu), 2 reglu (relu)
__device__ __forceinline__ float glu_act(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));
  if (act == 1) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.f);
}

// -- asynchronous copies and tensor-core fragments (paged_attn.cu,
//    glu_ffn.cu) -------------------------------------------------------

// global -> shared copy of 16, 8 or 4 bytes that does not wait
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

// four 8x8 bf16 matrices: the A operand of one m16n8k16 mma (lane l
// points at row l % 16, column (l / 16) * 8 of the 16x16 tile)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// four 8x8 bf16 matrices, transposed: the B operands of two n-tiles
// (lane l points at k row (l % 8) + ((l / 8) % 2) * 8, column (l / 16) * 8
// of a [k][n] tile stored n-contiguous)
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

// c += a . b on the tensor cores: m16n8k16, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace griffin
