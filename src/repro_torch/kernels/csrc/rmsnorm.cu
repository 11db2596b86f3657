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
// Two variants, chosen by the wrapper from dtype and d
// (kernels/rmsnorm.py::kernel_variant):
//
// - resident: each row is read once. A block of R threads works on one
//   row at a time; thread t owns the 16-byte vectors t and t + R, so the
//   row's values stay in registers from the sum of squares to the scaled
//   write, and a thread issues both loads before it uses the first. R is
//   the row's vectors over two, rounded up to a warp (one vector a thread
//   was no faster on the H100). A row is thus one round of memory latency,
//   however few rows there are: (16, 6144) bf16 spreads over 16 blocks of
//   384 threads. The grid is persistent (as many blocks as fit on the
//   card, at most one a row) and walks the rows, so each thread loads its
//   slice of the f32 scale once, as float4, and keeps it for every row.
//   The next row's loads are issued before the current row's reduction
//   between warps (one barrier a row, the partial sums double buffered).
//   Rows of up to 2048 vectors (d <= 16384 in bf16 and f16, 8192 in f32)
//   are served; a d that does not split into 16-byte vectors is not.
// - warp (the first design, kept to be timed beside it, and serving every
//   other d): one warp per row, 8 rows a block, no row padding. The warp
//   sums the squares, reading 16-byte vectors where d allows, then reads
//   the row a second time to scale and write it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;     // warps (rows) per block of the warp variant
constexpr int kMaxVecs = 2048;  // 16-byte vectors of a row the resident variant holds

enum Variant { kWarp = 0, kResident = 1 };

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

// ---- warp: the first design ----------------------------------------------

// grid ceil(rows / 8), 256 threads
template <typename T>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_warp(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
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

// ---- resident: read once, scale in registers, persistent grid -------------

constexpr int kMaxThreads = 1024;
constexpr int kPer = 2;  // 16-byte vectors a thread of the resident variant holds

// grid min(rows, blocks that fit), R threads (a multiple of 32, at most
// 1024), d % (16 / sizeof(T)) == 0 and d / (16 / sizeof(T)) <= R * kPer;
// x, out and scale 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_resident(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
                 int64_t rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float partial[2][32];
  const int R = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = R >> 5, nvec = d / kVec;

  bool has[kPer];
  float sc[kPer][kVec];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = tid + j * R;
    has[j] = c < nvec;
#pragma unroll
    for (int q = 0; q < kVec; q += 4) {
      const float4 s4 = has[j] ? __ldg(reinterpret_cast<const float4*>(scale + c * kVec + q))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[j][q] = s4.x;
      sc[j][q + 1] = s4.y;
      sc[j][q + 2] = s4.z;
      sc[j][q + 3] = s4.w;
    }
  }

  int64_t row = blockIdx.x;
  uint4 cur[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    cur[j] = has[j] ? __ldcs(reinterpret_cast<const uint4*>(x + row * d) + tid + j * R)
                    : make_uint4(0u, 0u, 0u, 0u);
  for (int par = 0; row < rows; row += gridDim.x, par ^= 1) {
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const T* e = reinterpret_cast<const T*>(&cur[j]);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float f = to_f(e[q]);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    // the next row's loads go out before the barrier
    const int64_t next = row + gridDim.x;
    uint4 nxt[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      nxt[j] = has[j] && next < rows
                   ? __ldcs(reinterpret_cast<const uint4*>(x + next * d) + tid + j * R)
                   : make_uint4(0u, 0u, 0u, 0u);
    if (lane == 0) partial[par][warp] = ss;
    __syncthreads();
    float tot = 0.0f;
    for (int i = 0; i < nw; ++i) tot += partial[par][i];
    const float r = rsqrtf(tot / static_cast<float>(d) + eps);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!has[j]) continue;
      const T* e = reinterpret_cast<const T*>(&cur[j]);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int q = 0; q < kVec; ++q) o[q] = from_f<T>(to_f(e[q]) * r * sc[j][q]);
      __stcs(reinterpret_cast<uint4*>(out + row * d) + tid + j * R, res);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) cur[j] = nxt[j];
  }
}

template <typename T>
cudaError_t launch_warp(const void* x, const float* scale, void* out, int64_t rows, int d,
                        float eps, cudaStream_t s) {
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  rmsnorm_warp<T><<<static_cast<unsigned>(blocks), 32 * kRows, 0, s>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_resident(const void* x, const float* scale, void* out, int64_t rows, int d,
                            float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(scale)) % 16 == 0;
  if (!aligned || d % kVec || d / kVec > kMaxVecs) return cudaErrorInvalidValue;
  const int threads = ((d / kVec + kPer - 1) / kPer + 31) / 32 * 32;
  const auto kernel = rmsnorm_resident<T>;
  // blocks that fit on the card, by block size (looked up once each)
  static int fit[kMaxThreads / 32 + 1] = {0};
  const int slot = threads / 32;
  if (fit[slot] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return e;
    fit[slot] = sms * (per_sm > 0 ? per_sm : 1);
  }
  int64_t blocks = fit[slot];
  if (blocks > rows) blocks = rows;
  kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int variant, const void* x, const float* scale, void* out, int64_t rows,
                   int d, float eps, cudaStream_t s) {
  if (variant == kWarp) return launch_warp<T>(x, scale, out, rows, d, eps, s);
  if (variant == kResident) return launch_resident<T>(x, scale, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x and out (rows, d) in one dtype (0: float32, 1: bfloat16, 2: float16),
// scale (d,) float32; contiguous, 16-byte aligned, on the device of
// `stream`. variant 0 (warp) or 1 (resident); a variant that cannot serve
// the shape is refused with cudaErrorInvalidValue. Returns
// cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* scale, void* out, int dtype, int variant,
                       long long rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(variant, x, sc, out, rows, d, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(variant, x, sc, out, rows, d, eps, s));
    case 2: return static_cast<int>(launch<__half>(variant, x, sc, out, rows, d, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
