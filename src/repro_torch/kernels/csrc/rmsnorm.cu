// RMSNorm, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (rmsnorm :25). For each row x of length d, with a float32 scale (d,):
//   y = x * rsqrt(mean(x^2) + eps) * scale
// the mean square and the products in f32, y in x's dtype.
//
// Bound on this card: bytes. A (8192, 6144) bf16 call reads and writes
// 201 MB, 60 us at 3.35 TB/s; it does about 4 flops an element.
//
// Design: one warp per row, 8 rows a block; no row padding (the TPU
// kernel pads the rows to a multiple of its block). The warp reads the
// row in 16-byte vectors where d allows (a multiple of 8 bf16 or 4 f32
// values), else element by element, sums the squares in f32 and reduces
// them by shuffles, then reads the row again (from L1/L2: a row is at most
// a few tens of KB) to scale and write it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;  // warps (rows) per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// grid ceil(rows / 8), 256 threads
template <typename T>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const bool vec = d % kVec == 0;

  float ss = 0.0f;
  if (vec) {
    for (int i = lane * kVec; i < d; i += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = lane * kVec; i < d; i += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = from_f<T>(to_f(e[j]) * r * scale[i + j]);
      *reinterpret_cast<uint4*>(orow + i) = res;
    }
  } else {
    for (int i = lane; i < d; i += 32) orow[i] = from_f<T>(to_f(xr[i]) * r * scale[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* out, int64_t rows, int d,
                   float eps, cudaStream_t s) {
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), 32 * kRows, 0, s>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out (rows, d) in one dtype (0: float32, 1: bfloat16, 2: float16),
// scale (d,) float32; contiguous, 16-byte aligned, on the device of
// `stream`. Returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* scale, void* out, int dtype, long long rows,
                       int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, sc, out, rows, d, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, sc, out, rows, d, eps, s));
    case 2: return static_cast<int>(launch<__half>(x, sc, out, rows, d, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
