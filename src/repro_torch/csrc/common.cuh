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

}  // namespace griffin
