// Plan-scoring statistics for the scheduler core, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sched_score.py::_score_kernel.
// For each of P candidate plans over K devices it writes one row of three
// floats:
//   out[p, 0] = max over selected k of times[k]   (-1e30 for an empty plan)
//   out[p, 1] = number of selected devices        (exact: int32, cast last)
//   out[p, 2] = sum over selected k of weights[k]
//
// Bound on this card: the bytes it reads. Every plan byte is read once
// (P*K int8) plus times and weights (8*K bytes, reused by every row and so
// served from L2), against about three operations per plan byte: far below
// the card's operations-per-byte balance. At P = 4096, K = 1e5 that is
// 410 MB, about 122 us at 3.35 TB/s; at P = 512, K = 1e4 it is 5.1 MB,
// about 1.5 us, where launch overhead is the real limit.
//
// Design for that bound:
// - One block owns one plan row and its threads stride over K, so the
//   reads of a row are coalesced. Where K % 16 == 0 and the plans are
//   16-byte aligned (the wrapper checks both), each thread loads 16 plan
//   bytes at a time and skips a zero vector with one compare: plans select
//   about 1% of devices, so most vectors are all zero and times/weights are
//   read only at selected devices. Otherwise (K = 1001, a row start that is
//   not aligned) threads read single bytes.
// - Selection is a branch, never a product with the mask: crashed devices
//   carry busy_until = inf, so times may hold +inf where 0 * inf is NaN.
// - Row offsets are 64-bit: P*K reaches ~1.07e9 at K = 262,144.
// - The weight sum is accumulated in double and rounded to float once. Two
//   plans that select the same multiset of weights then get the same
//   column 2 wherever those devices sit, so the host searchers' exact-tie
//   comparisons do not depend on device positions. The f32 reference sums
//   in another order and agrees within its stated tolerance.
// - Each thread keeps a running max, an int32 count and the double sum;
//   they are reduced with warp shuffles, then across warps in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void take(int k, const float* __restrict__ times,
                                     const float* __restrict__ weights,
                                     float& m, int& n, double& s) {
  m = fmaxf(m, __ldg(times + k));
  n += 1;
  s += static_cast<double>(__ldg(weights + k));
}

__global__ void __launch_bounds__(kThreads)
plan_stats_kernel(const float* __restrict__ times,
                  const float* __restrict__ weights,
                  const int8_t* __restrict__ plans, float* __restrict__ out,
                  int64_t K, int vec) {
  const int64_t row = blockIdx.x;
  const int8_t* p = plans + row * K;
  float m = kNegInf;
  int n = 0;
  double s = 0.0;

  if (vec) {
    const int4* p16 = reinterpret_cast<const int4*>(p);
    const int64_t nvec = K / 16;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const int4 v = __ldg(p16 + i);
      if ((v.x | v.y | v.z | v.w) == 0) continue;
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (b[j] != 0) take(static_cast<int>(i * 16 + j), times, weights, m, n, s);
      }
    }
  } else {
    for (int64_t k = threadIdx.x; k < K; k += kThreads) {
      if (p[k] != 0) take(static_cast<int>(k), times, weights, m, n, s);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
    n += __shfl_down_sync(0xffffffffu, n, off);
    s += __shfl_down_sync(0xffffffffu, s, off);
  }

  __shared__ float sm[kWarps];
  __shared__ int sn[kWarps];
  __shared__ double ss[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sn[warp] = n;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      m = fmaxf(m, sm[w]);
      n += sn[w];
      s += ss[w];
    }
    float* o = out + row * 3;
    o[0] = m;
    o[1] = static_cast<float>(n);
    o[2] = static_cast<float>(s);
  }
}

}  // namespace

// times (K,) f32, weights (K,) f32, plans (P, K) int8 row-major, out (P, 3)
// f32; all on the device of `stream`. `vec` = 1 only when K % 16 == 0 and
// `plans` is 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int sched_plan_stats(const void* times, const void* weights,
                                const void* plans, void* out, long long P,
                                long long K, int vec, void* stream) {
  if (P <= 0) return 0;
  plan_stats_kernel<<<static_cast<unsigned int>(P), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(times), static_cast<const float*>(weights),
      static_cast<const int8_t*>(plans), static_cast<float*>(out),
      static_cast<int64_t>(K), vec);
  return static_cast<int>(cudaGetLastError());
}
