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
// TPU cannot scatter. Hopper has float atomics in shared and device memory,
// so both variants here do the O(n * k) scatter directly.
//
// Bound on this card: bytes. The work reads n*k values and indices and n
// weights and writes the output once. At VGG16's fc2 leaf (size
// 16,777,216, n = 10, k = 167,772, int64 idx) that is n*k*12 + 4n +
// 4*size = 87 MB, about 26 us at 3.35 TB/s, 67 MB of it the output.
//
// Two variants, chosen by the wrapper from the shape alone
// (kernels/scatter_add.py::kernel_variant):
//
// - tile (an output of at most kTile floats; the wrapper sends streams of
//   at most 1024 entries, one a thread): one block zeroes the output in
//   shared memory, adds the whole stream with shared-memory atomics and
//   writes it with 16-byte stores. One launch, no fill: VGG16's biases and
//   first conv, LeNet-5's small leaves.
// - atomic (the first design, every other output): float atomics into
//   device memory, into an output the caller zeroed, one per entry; a warp
//   (and then a block) whose entries all hold one position sums them first
//   in a fixed tree and issues one. At fc2 on random top-k streams the atomics land on about 1.68 M
//   distinct sectors of a 67 MB output that the 50 MB L2 cannot hold; a
//   trained cohort's stream finds far more of the L2. Sorting the stream
//   by output tile first (no atomics in device memory, no fill) won on the
//   random streams and lost on the trained one, so it is not kept.
//
// The weight multiply is fused (w[i] from L1/L2). int64 indices (what
// torch.topk returns) and int32 are read as they are. Offsets are 64-bit:
// n*k can pass 2^31 at full-ratio leaves.
//
// Numerics: both variants sum with float atomics (in shared memory for
// tile) in an order that changes from run to run, so results are not
// bitwise reproducible; they agree with the plain version within 1e-5
// relative plus absolute. The atomic variant's warp and block sums keep a
// crowded position's rounding walk short (one atomic per 256 entries, not
// per entry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kTile = 16384;            // floats the tile variant holds (64 KB)
constexpr int kTileThreads = 1024;          // the tile variant's one block
constexpr int kAtomicThreads = 256;
constexpr int kMaxAtomicBlocks = 132 * 16;  // 16 blocks per SM on the H100's 132

enum Variant { kAtomic = 0, kTileVariant = 1 };

// The device row of entry e: 32-bit division where the stream allows it
// (a 64-bit division is about a hundred instructions).
__device__ __forceinline__ int64_t row_of(int64_t e, int64_t k, bool narrow) {
  return narrow ? static_cast<int64_t>(static_cast<uint32_t>(e) / static_cast<uint32_t>(k))
                : e / k;
}

// Entries e0, e0 + stride, ... (N of them) of the stream, every load issued
// before any is used, so they are in flight together: p[j] the position
// (-1 where the entry is padding, past `size` or past the stream) and
// v[j] = w[row] * vals[e].
template <typename Idx, int N>
__device__ __forceinline__ void load_entries(const float* __restrict__ vals,
                                             const Idx* __restrict__ idx,
                                             const float* __restrict__ w, int64_t e0, int stride,
                                             int64_t total, int64_t k, int64_t size,
                                             int64_t (&p)[N], float (&v)[N]) {
  const bool narrow = total <= 0xffffffffLL;
  float raw[N], wt[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t e = e0 + static_cast<int64_t>(j) * stride;
    const bool in = e < total;
    p[j] = in ? static_cast<int64_t>(__ldg(idx + e)) : -1;
    raw[j] = in ? __ldg(vals + e) : 0.f;
    wt[j] = in ? __ldg(w + row_of(e, k, narrow)) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (p[j] >= size) p[j] = -1;
    v[j] = wt[j] * raw[j];
  }
}

// Writes len floats of a shared-memory tile to out (16-byte aligned), in
// 16-byte stores where four floats remain.
__device__ __forceinline__ void store_tile(const float* tile, float* out, int64_t len) {
  const int64_t v4 = len >> 2;
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t i = threadIdx.x; i < v4; i += blockDim.x) o4[i] = t4[i];
  for (int64_t i = (v4 << 2) + threadIdx.x; i < len; i += blockDim.x) out[i] = tile[i];
}

__device__ __forceinline__ void zero_tile(float* tile, int64_t len) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  const int64_t v4 = (len + 3) >> 2;
  for (int64_t i = threadIdx.x; i < v4; i += blockDim.x) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- atomic: the first design, with crowded warps and blocks combined ----

// One entry a thread (its index, value and row weight loaded together).
// A warp whose valid entries all hold one position (its lowest and highest
// position agree, __reduce_min_sync and __reduce_max_sync) sums them in a
// fixed shuffle tree in float64; every other warp issues one float atomic
// per entry, as the first design did. Then, where some warp of the block
// was on one position, those warps' sums meet in shared memory: on one
// position they are added in a fixed tree and one lane issues one atomic,
// else each issues its own. A stream that crowds one position (30,000
// entries on one float) so sends one atomic per 256 entries, each a
// float64 sum rounded once, instead of one per entry: its gap to the exact
// sum falls from up to 1e-3 to about 5e-5, and it runs about 12 times
// faster (the queue of atomics on the hot address). Random top-k streams
// pay two warp reductions and one barrier per 256 entries. More entries a
// thread (fewer blocks, a larger block sum) bought no accuracy here and
// cost small streams their spread over the SMs.
constexpr int kAtomicWarps = kAtomicThreads / 32;

template <typename Idx>
__global__ void __launch_bounds__(kAtomicThreads)
atomic_kernel(const float* __restrict__ vals, const Idx* __restrict__ idx,
              const float* __restrict__ w, float* __restrict__ out, int64_t total, int64_t k,
              int64_t size) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int64_t slot_p[kAtomicWarps];  // a warp's one position, or -1
  __shared__ double slot_v[kAtomicWarps];   // and its sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool key32 = size < 0xffffffffLL;   // positions fit the 32-bit reductions
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kAtomicThreads;
  // the loop runs alike for every thread of a block (barriers inside)
  for (int64_t b0 = static_cast<int64_t>(blockIdx.x) * kAtomicThreads; b0 < total;
       b0 += stride) {
    int64_t p[1];
    float v[1];
    load_entries<Idx, 1>(vals, idx, w, b0 + threadIdx.x, 0, total, k, size, p, v);
    const bool valid = p[0] >= 0;
    const unsigned lo = __reduce_min_sync(kAll, valid ? static_cast<unsigned>(p[0]) : kAll);
    const unsigned hi = __reduce_max_sync(kAll, valid ? static_cast<unsigned>(p[0]) : 0u);
    const bool one = key32 && lo == hi;  // lo == hi only where an entry is valid
    double s = valid ? v[0] : 0.0;
    if (one) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kAll, s, off);
    } else if (valid) {
      atomicAdd(out + p[0], v[0]);
    }
    if (lane == 0) {
      slot_p[warp] = one ? static_cast<int64_t>(lo) : -1;
      slot_v[warp] = s;
    }
    if (!__syncthreads_or(one)) continue;  // no warp on one position: done
    if (warp == 0) {
      const int64_t q = lane < kAtomicWarps ? slot_p[lane] : -1;
      double x = q >= 0 ? slot_v[lane] : 0.0;
      const unsigned qlo = __reduce_min_sync(kAll, q >= 0 ? static_cast<unsigned>(q) : kAll);
      const unsigned qhi = __reduce_max_sync(kAll, q >= 0 ? static_cast<unsigned>(q) : 0u);
      if (qlo == qhi) {  // every warp that was on one position, on the same one
#pragma unroll
        for (int off = kAtomicWarps / 2; off > 0; off >>= 1) x += __shfl_down_sync(kAll, x, off);
        if (lane == 0) atomicAdd(out + qlo, static_cast<float>(x));
      } else if (q >= 0) {
        atomicAdd(out + q, static_cast<float>(x));
      }
    }
    __syncthreads();  // the slots are written again next iteration
  }
}

// ---- tile: one block, the whole output in shared memory -------------------

// grid 1, kTileThreads threads, (size rounded up to 4) * 4 bytes of shared memory
template <typename Idx>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* __restrict__ vals, const Idx* __restrict__ idx,
            const float* __restrict__ w, float* __restrict__ out, int64_t total, int64_t k,
            int64_t size) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  zero_tile(tile, size);
  __syncthreads();
  // four entries a thread in flight at a time
  constexpr int kUnroll = 4;
  for (int64_t base = threadIdx.x; base < total; base += kUnroll * kTileThreads) {
    int64_t p[kUnroll];
    float v[kUnroll];
    load_entries<Idx, kUnroll>(vals, idx, w, base, kTileThreads, total, k, size, p, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p[u] >= 0) atomicAdd(tile + p[u], v[u]);
  }
  __syncthreads();
  store_tile(tile, out, size);
}

// Lets `kernel` take up to `bytes` of dynamic shared memory; set once per
// kernel, to the most any launch of it takes.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  *done = e == cudaSuccess;
  return e;
}

template <typename Idx>
cudaError_t launch(int variant, const float* v, const Idx* ix, const float* w, float* o,
                   int64_t total, int64_t k, int64_t size, cudaStream_t s) {
  if (variant == kAtomic) {
    int64_t blocks = (total + kAtomicThreads - 1) / kAtomicThreads;
    if (blocks > kMaxAtomicBlocks) blocks = kMaxAtomicBlocks;
    atomic_kernel<Idx><<<static_cast<unsigned>(blocks), kAtomicThreads, 0, s>>>(v, ix, w, o,
                                                                                total, k, size);
    return cudaGetLastError();
  }
  if (size > kTile) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>((size + 3) & ~int64_t{3}) * sizeof(float);
  static bool tile_smem = false;
  const cudaError_t e = allow_smem(tile_kernel<Idx>, kTile * sizeof(float), &tile_smem);
  if (e != cudaSuccess) return e;
  tile_kernel<Idx><<<1, kTileThreads, bytes, s>>>(v, ix, w, o, total, k, size);
  return cudaGetLastError();
}

}  // namespace

// vals (n, k) f32, idx (n, k) int32 (idx_bytes = 4) or int64 (8), w (n,)
// f32, all row-major and contiguous; out (size,) f32, 16-byte aligned;
// all on the device of `stream`. variant 0 (atomic) adds into an out the
// caller zeroed; 1 (tile) writes every element of out. A variant that
// cannot serve the shape is refused with cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch.
extern "C" int fl_scatter_add(const void* vals, const void* idx, int idx_bytes, const void* w,
                              void* out, int variant, long long n, long long k, long long size,
                              void* stream) {
  const int64_t total = static_cast<int64_t>(n) * k;
  if (idx_bytes != 4 && idx_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  if ((variant != kAtomic && variant != kTileVariant) || size < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const cudaError_t e =
      idx_bytes == 8
          ? launch<int64_t>(variant, v, static_cast<const int64_t*>(idx), wt, o, total, k, size, s)
          : launch<int32_t>(variant, v, static_cast<const int32_t*>(idx), wt, o, total, k, size, s);
  return static_cast<int>(e);
}
