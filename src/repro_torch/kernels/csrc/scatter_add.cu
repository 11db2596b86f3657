// Weighted scatter-add for compressed FedAvg, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/scatter_add.py::_scatter_kernel.
// Per parameter leaf the server decompresses every device's top-k delta
// into one flat accumulator:
//   out[p] = sum over (i, j) with idx[i, j] == p of w[i] * vals[i, j]
// with vals (n, k) f32, idx (n, k) int32 or int64, w (n,) f32 and out
// (size,) f32. A negative index is padding, and an index >= size is dropped
// too (the reference oracle routes both past the end and slices them off).
//
// The TPU kernel tiles the OUTPUT and folds a (BK, BS) one-hot matrix with
// an MXU matmul per program: O(n * k * size) work, there only because the
// TPU has no scatter. Hopper has native float atomics in device memory, so
// this kernel does the O(n * k) scatter directly.
//
// Bound on this card: bytes. The work is n*k reads of a value and an index,
// n weights, and one float atomic per kept entry into an output the wrapper
// zeroes (torch.zeros). At VGG16's fc leaf (size 16,777,216, n = 10,
// k = 167,772, int64 idx) that is n*k*12 + 4n + 4*size = 87 MB, about
// 26 us at 3.35 TB/s, 67 MB of it the output.
//
// Design for that bound:
// - One thread per (i, j) entry and a grid-stride loop: neighbouring
//   threads read neighbouring vals/idx, so those reads are coalesced. The
//   atomics land where the top-k indices fall; within a device's row the
//   indices are distinct, so at most n terms meet at one position and the
//   atomics rarely contend.
// - The weight multiply the JAX wrapper did outside its kernel is fused:
//   w[i] (served from L1/L2, n floats) times vals in f32, then atomicAdd.
// - int64 indices (what torch.topk returns) and int32 are both read as
//   they are, so the wrapper needs no cast pass.
// - Offsets are 64-bit: n*k can pass 2^31 at full-ratio leaves.
//
// Numerics: float atomics sum in an order that changes from run to run,
// so the result is not bitwise reproducible on the card; it agrees with the
// plain version within 1e-5 relative plus absolute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM on the H100's 132

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ vals, const Idx* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out,
                   int64_t total, int64_t k, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += stride) {
    const int64_t p = static_cast<int64_t>(__ldg(idx + t));
    if (p < 0 || p >= size) continue;
    atomicAdd(out + p, __ldg(w + t / k) * __ldg(vals + t));
  }
}

}  // namespace

// vals (n, k) f32, idx (n, k) int32 (idx_bytes = 4) or int64 (8), w (n,)
// f32, all row-major and contiguous; out (size,) f32, zeroed by the caller;
// all on the device of `stream`. Returns cudaGetLastError() after the launch.
extern "C" int fl_scatter_add(const void* vals, const void* idx, int idx_bytes,
                              const void* w, void* out, long long n, long long k,
                              long long size, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * k;
  if (total <= 0) return 0;
  if (idx_bytes != 4 && idx_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (idx_bytes == 8) {
    scatter_add_kernel<int64_t><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        v, static_cast<const int64_t*>(idx), wt, o, total, k, size);
  } else {
    scatter_add_kernel<int32_t><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        v, static_cast<const int32_t*>(idx), wt, o, total, k, size);
  }
  return static_cast<int>(cudaGetLastError());
}
