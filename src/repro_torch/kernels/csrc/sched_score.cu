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
// about 1.5 us, where launch overhead and memory latency are the limit.
//
// Properties both variants keep:
// - Selection is a branch, never a product with the mask: crashed devices
//   carry busy_until = inf, so times may hold +inf where 0 * inf is NaN.
// - Row offsets are 64-bit: P*K reaches ~1.07e9 at K = 262,144. Device
//   indices are int32 (the wrapper checks K < 2^31).
// - The weight sum is accumulated in double and rounded to float once. Two
//   plans that select the same multiset of weights then get the same
//   column 2 wherever those devices sit, so the host searchers' exact-tie
//   comparisons do not depend on device positions. The f32 reference sums
//   in another order and agrees within its stated tolerance.
// - Reductions run in a fixed order (shuffle trees), so a launch gives the
//   same bits every time.
//
// Two variants, chosen by the wrapper from shape and alignment alone:
//
// `row` (the first design) serves every shape. One 256-thread block owns a
// row; where K % 16 == 0 and the plans are 16-byte aligned each thread
// loads one 16-byte vector per iteration and skips a zero vector, else it
// reads single bytes. Each load waits on the test of the one before, and
// times and weights are gathered one selected byte at a time.
//
// `stream` serves K % 16 == 0, K > 0 and 16-byte aligned plans, times and
// weights. It is built for the latency that holds `row` back:
// - A chunk is 12 KB of one row: each thread loads 3 vectors of 16 bytes,
//   unconditionally (a bounds predicate, no test of the data), so all of a
//   chunk is in flight before the first test, and the next chunk's loads
//   (the next row's, at a row's end) are issued before the current one is
//   tested: a register double buffer, 24 KB a block. 63 registers keep 4
//   blocks an SM, so 528 rows are in flight at once.
// - A persistent grid (at most the blocks resident on the card) walks over
//   the rows, a block a row.
// - Each thread packs its plan bytes into 16-bit masks of selected
//   positions (a few integer operations a vector; popc gives the count).
//   A vector with 4 or more selected bytes reads its 16 times and weights
//   as 8 loads of 16 bytes; the selected bytes of the other vectors are
//   taken off the masks 4 at a time and their times and weights loaded
//   together, before any is used.
// - The tail: warp shuffles, then one warp folds the 8 warps' partials
//   (shared memory double-buffered by row, one __syncthreads a row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kUnroll = 3;                    // vectors a thread loads a chunk
constexpr int kChunk = kThreads * kUnroll;    // vectors a chunk: 12 KB
constexpr int kGather = 4;                    // gathers issued together
constexpr int kDense = 4;                     // selected bytes: a dense vector
static_assert(kUnroll * 16 <= 64, "a thread's chunk bytes fill one 64-bit mask");

constexpr int kRow = 0;
constexpr int kStream = 1;

struct Stats {
  float m;
  int n;
  double s;
};

__device__ __forceinline__ Stats empty_stats() { return {kNegInf, 0, 0.0}; }

__device__ __forceinline__ Stats fold(Stats a, const Stats& b) {
  a.m = fmaxf(a.m, b.m);
  a.n += b.n;
  a.s += b.s;
  return a;
}

__device__ __forceinline__ Stats shfl_down(const Stats& x, int off) {
  return {__shfl_down_sync(0xffffffffu, x.m, off),
          __shfl_down_sync(0xffffffffu, x.n, off),
          __shfl_down_sync(0xffffffffu, x.s, off)};
}

__device__ __forceinline__ Stats warp_fold(Stats x, int width) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < width) x = fold(x, shfl_down(x, off));
  }
  return x;
}

__device__ __forceinline__ void store(float* out, int64_t row,
                                      const Stats& x) {
  float* o = out + row * 3;
  o[0] = x.m;
  o[1] = static_cast<float>(x.n);
  o[2] = static_cast<float>(x.s);
}

// ---- `row`: the first design, as it was ------------------------------

__device__ __forceinline__ void take(int k, const float* __restrict__ times,
                                     const float* __restrict__ weights,
                                     float& m, int& n, double& s) {
  m = fmaxf(m, __ldg(times + k));
  n += 1;
  s += static_cast<double>(__ldg(weights + k));
}

__global__ void __launch_bounds__(kThreads)
plan_stats_row_kernel(const float* __restrict__ times,
                      const float* __restrict__ weights,
                      const int8_t* __restrict__ plans,
                      float* __restrict__ out, int64_t K, int vec) {
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
    store(out, row, {m, n, s});
  }
}

// ---- `stream` ----------------------------------------------------------

// Bit 4b + w (b, w < 4) set where byte b of word w of the vector is
// nonzero, i.e. byte 4w + b of the 16: per word, the high bit of each byte
// of ((x & 0x7f..) + 0x7f..) | x is set iff the byte is nonzero (no carry
// crosses a byte); the four words' bits are then packed.
__device__ __forceinline__ unsigned nonzero_mask(const int4& v) {
  auto high = [](int x) {
    const unsigned u = static_cast<unsigned>(x);
    return (((u & 0x7f7f7f7fu) + 0x7f7f7f7fu) | u) & 0x80808080u;
  };
  unsigned c = high(v.x) >> 7 | high(v.y) >> 6 | high(v.z) >> 5 |
               high(v.w) >> 4;             // bit 8b + w
  c = (c | c >> 4) & 0x00ff00ffu;          // bytes 0, 1 in bits 0-7; 2, 3 in 16-23
  return (c | c >> 8) & 0xffffu;           // bit 4b + w
}

// The byte of the vector that bit i of nonzero_mask stands for.
__device__ __forceinline__ int mask_byte(int i) { return 4 * (i & 3) + (i >> 2); }

// A vector with at least kDense selected bytes: its 16 times and weights
// come in as 8 loads of 16 bytes, issued together.
__device__ __forceinline__ void take_dense(
    const float* __restrict__ times, const float* __restrict__ weights,
    int v, unsigned m, Stats& st) {
  const float4* t4 = reinterpret_cast<const float4*>(times) + 4 * v;
  const float4* w4 = reinterpret_cast<const float4*>(weights) + 4 * v;
  float4 t[4], w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    t[q] = __ldg(t4 + q);
    w[q] = __ldg(w4 + q);
  }
  const float* tf = reinterpret_cast<const float*>(t);
  const float* wf = reinterpret_cast<const float*>(w);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (m >> (4 * (j & 3) + (j >> 2)) & 1u) {
      st.m = fmaxf(st.m, tf[j]);
      st.s += static_cast<double>(wf[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
plan_stats_stream_kernel(const float* __restrict__ times,
                         const float* __restrict__ weights,
                         const int8_t* __restrict__ plans,
                         float* __restrict__ out, int64_t P, int64_t K) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nvec = static_cast<int>(K / 16);  // a row's 16-byte vectors
  const int nchunk = (nvec + kChunk - 1) / kChunk;

  // Chunk c of row `row`.
  auto load = [&](int4 (&v)[kUnroll], int64_t row, int c) {
    const int4* p16 = reinterpret_cast<const int4*>(plans + row * K);
    const int v0 = c * kChunk + tid;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = v0 + u * kThreads;
      v[u] = i < nvec ? __ldg(p16 + i) : make_int4(0, 0, 0, 0);
    }
  };

  __shared__ Stats red[2][kWarps];            // double-buffered by row
  int4 cur[kUnroll], nxt[kUnroll];
  Stats st = empty_stats();
  int64_t row = blockIdx.x;
  int c = 0;  // the chunk of `row` being tested
  int parity = 0;
  load(cur, row, 0);

  while (row < P) {
    const bool last = c + 1 == nchunk;  // the row's last chunk
    const int64_t next_row = last ? row + gridDim.x : row;
    const int next_c = last ? 0 : c + 1;
    if (next_row < P) load(nxt, next_row, next_c);

    // Test the chunk. Dense vectors are taken whole; the selected bytes of
    // the others gather below. Slots past the row hold zeros and are
    // skipped (uniformly, but for the one warp on the row's edge).
    const int v0 = c * kChunk + tid;
    unsigned m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      m[u] = v0 + u * kThreads < nvec ? nonzero_mask(cur[u]) : 0u;
      st.n += __popc(m[u]);
    }
    unsigned long long sparse = 0;  // cur is dead from here on
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (__popc(m[u]) >= kDense) {
        take_dense(times, weights, v0 + u * kThreads, m[u], st);
      } else {
        sparse |= static_cast<unsigned long long>(m[u]) << (16 * u);
      }
    }
    while (sparse) {
      int k[kGather];
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        k[g] = -1;
        if (sparse) {
          const int i = __ffsll(static_cast<long long>(sparse)) - 1;
          sparse &= sparse - 1;
          k[g] = (v0 + (i >> 4) * kThreads) * 16 + mask_byte(i & 15);
        }
      }
      float t[kGather], w[kGather];
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        t[g] = kNegInf;
        w[g] = 0.0f;
        if (k[g] >= 0) {
          t[g] = __ldg(times + k[g]);
          w[g] = __ldg(weights + k[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        if (k[g] >= 0) {
          st.m = fmaxf(st.m, t[g]);
          st.s += static_cast<double>(w[g]);
        }
      }
    }

    if (last) {  // reduce the row: warps, then one warp over the warps
      st = warp_fold(st, 32);
      if (lane == 0) red[parity][warp] = st;
      __syncthreads();
      if (warp == 0) {
        st = warp_fold(lane < kWarps ? red[parity][lane] : empty_stats(),
                       kWarps);
        if (lane == 0) store(out, row, st);
      }
      st = empty_stats();
      parity ^= 1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    row = next_row;
    c = next_c;
  }
}

// Blocks of the stream kernel resident on the current card at once (the
// persistent grid's size), queried once per device.
int max_stream_blocks() {
  static int cap[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plan_stats_stream_kernel, kThreads, 0);
    cap[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

}  // namespace

// times (K,) f32, weights (K,) f32, plans (P, K) int8 row-major, out (P, 3)
// f32; all on the device of `stream`. `variant` 0 is `row` (every shape),
// 1 is `stream` (K % 16 == 0, K > 0, `plans`, `times` and `weights`
// 16-byte aligned). Returns cudaErrorInvalidValue for a variant that
// cannot serve the call (nothing is launched), else cudaGetLastError()
// after the launch.
extern "C" int sched_plan_stats(const void* times, const void* weights,
                                const void* plans, void* out, long long P,
                                long long K, int variant, void* stream) {
  if (P < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(plans) % 16 == 0;
  const auto* t = static_cast<const float*>(times);
  const auto* w = static_cast<const float*>(weights);
  const auto* p = static_cast<const int8_t*>(plans);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);

  if (variant == kRow) {
    plan_stats_row_kernel<<<static_cast<unsigned int>(P), kThreads, 0, s>>>(
        t, w, p, o, static_cast<int64_t>(K), aligned && K % 16 == 0);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned_tw = reinterpret_cast<uintptr_t>(times) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  if (variant != kStream || !aligned || !aligned_tw || K == 0 ||
      K % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cap = max_stream_blocks();
  const unsigned int grid = static_cast<unsigned int>(P < cap ? P : cap);
  plan_stats_stream_kernel<<<grid, kThreads, 0, s>>>(
      t, w, p, o, static_cast<int64_t>(P), static_cast<int64_t>(K));
  return static_cast<int>(cudaGetLastError());
}
