// Decode attention (one new query token per sequence against its KV cache),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (decode_attention :60). For every sequence b and query head h:
//   out[b, h] = softmax_t(q[b, h] . k[b, t, h / G] * scale) v[b, t, h / G]
// over the cache rows t < length[b], with q (B, H, D), caches (B, T, KV, D),
// G = H / KV, scale = 1 / sqrt(D), f32 math (f32 logits, running max m,
// normaliser l and accumulator), output in q's dtype. Rows at or past
// length[b] are masked; with length[b] <= 0 every logit is the mask value
// -1e30, so the softmax is uniform over all T rows and the output is the
// mean of v, exactly as the reference oracle and the Pallas kernel give.
//
// Bound on this card: bytes. Every valid cache row of k and v is read once;
// at qwen3-1.7b's 16 slots with a 4096-row cache (KV = 8, D = 128, bf16)
// and lengths spread over [1, T] that is about 134 MB a layer, 40 us at
// 3.35 TB/s. The work is 4 * D flops per (query head, row): far under the
// f32 rate.
//
// Design for that bound:
// - One block per (b, kv-head, split of the valid prefix): the G query
//   heads of a kv-head share every loaded K/V row, so the cache is read
//   once, not G times (the Pallas kernel's GQA tile). Blocks read only the
//   valid prefix [0, length) (all T rows when length <= 0), so the time
//   follows the lengths, not T.
// - Split-K: when B * KV blocks cannot fill the 132 SMs the wrapper splits
//   each prefix into chunks; each block writes a partial (m, l, acc) and a
//   second kernel combines the splits (log-sum-exp rescaling). Blocks past
//   the prefix write an empty partial (m = -1e30, l = 0, acc = 0).
// - Per 64-row tile: K is staged in shared memory as f32 (16-byte loads,
//   rows padded to D + 4 floats so the per-row float4 reads do not collide
//   on banks); each thread computes one row's logits for half the heads; one
//   warp per head takes the tile's max and rescales once per tile, as the
//   Pallas kernel does per block; the PV product reads V straight from
//   device memory (neighbouring threads, neighbouring columns).
// - Any T: the last tile is ragged and masked in place (no block halving).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // cache rows per tile; kThreads / kTile == 2
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Convert 16 bytes of T at src (16-byte aligned) to f32 at dst.
__device__ __forceinline__ int load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  return 4;
}
__device__ __forceinline__ int load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(f0.x, f0.y, f1.x, f1.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  return 8;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (static_cast<size_t>(G) * D + kTile * (D + 4) +
                          static_cast<size_t>(G) * kTile + 3 * G);
}

// grid (nsplit, B * KV); GMAX >= G, a power of two up to 32.
template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ out, float* __restrict__ part, int H, int KV,
              int T_len, int D, int nsplit, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int split = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldk = D + 4;
  float* qs = smem;                 // [G][D]
  float* ks = qs + G * D;           // [kTile][ldk]
  float* ps = ks + kTile * ldk;     // [G][kTile]
  float* ms = ps + G * kTile;       // [G] running max
  float* ls = ms + G;               // [G] running normaliser
  float* al = ls + G;               // [G] this tile's rescale factor

  const int len = length[b];
  const bool all_masked = len <= 0;
  const int n_keys = all_masked ? T_len : min(len, T_len);
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, n_keys);
  const int row0 = b * H + kvh * G;  // first query row (b, h) of this block

  const T* qb = q + static_cast<int64_t>(row0) * D;
  for (int i = tid * (16 / sizeof(T)); i < G * D; i += kThreads * (16 / sizeof(T)))
    load16(qb + i, qs + i);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  // PV mapping: thread owns columns dcol (+ dcols) for heads hg + j * hgroups.
  const int dcols = D < kThreads ? D : kThreads;
  const int hgroups = kThreads / dcols;
  const int dcol = tid % dcols, hg = tid / dcols;
  const int cpt = D / dcols;  // 1 or 2
  float acc[2][GMAX];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < GMAX; ++j) acc[c][j] = 0.0f;

  const int64_t row_stride = static_cast<int64_t>(KV) * D;  // cache row t -> t + 1
  const T* kb = k + (static_cast<int64_t>(b) * T_len * KV + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * T_len * KV + kvh) * D;
  constexpr int kVec = 16 / sizeof(T);
  const int vec_per_row = D / kVec;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int nt = min(kTile, t_end - t0);
    __syncthreads();  // q loaded / previous tile's ks and ps consumed
    for (int i = tid; i < kTile * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, c = (i % vec_per_row) * kVec;
      float* dst = ks + r * ldk + c;
      if (r < nt) {
        load16(kb + (t0 + r) * row_stride + c, dst);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.0f;
      }
    }
    __syncthreads();

    {  // logits: thread (row t, heads hp + 2j)
      const int t = tid % kTile, hp = tid / kTile;
      constexpr int LH = (GMAX + 1) / 2;
      float s[LH];
#pragma unroll
      for (int j = 0; j < LH; ++j) s[j] = 0.0f;
      if (!all_masked && t < nt) {
        const float* kr = ks + t * ldk;
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int j = 0; j < LH; ++j) {
            const int g = hp + 2 * j;
            if (g < G) {
              const float4 qq = *reinterpret_cast<const float4*>(qs + g * D + d);
              s[j] = fmaf(qq.x, kk.x, s[j]);
              s[j] = fmaf(qq.y, kk.y, s[j]);
              s[j] = fmaf(qq.z, kk.z, s[j]);
              s[j] = fmaf(qq.w, kk.w, s[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < LH; ++j) {
        const int g = hp + 2 * j;
        if (g < G)
          ps[g * kTile + t] = t >= nt ? -INFINITY : (all_masked ? kNegInf : s[j] * scale);
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {  // one warp per head
      float* pg = ps + g * kTile;
      const float a = pg[lane], c = pg[lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      pg[lane] = pa;
      pg[lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= cpt) break;
      const int d = dcol + c * dcols;
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        const int g = hg + j * hgroups;
        if (g < G) acc[c][j] *= al[g];
      }
      const T* vcol = vb + static_cast<int64_t>(t0) * row_stride + d;
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float vv = to_f(vcol[t * row_stride]);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          const int g = hg + j * hgroups;
          if (g < G) acc[c][j] = fmaf(ps[g * kTile + t], vv, acc[c][j]);
        }
      }
    }
  }
  __syncthreads();  // ms / ls final (also when this split had no rows)

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= cpt) break;
    const int d = dcol + c * dcols;
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      const int g = hg + j * hgroups;
      if (g >= G) continue;
      const int r = row0 + g;
      if (nsplit == 1) {
        out[static_cast<int64_t>(r) * D + d] = from_f<T>(acc[c][j] / fmaxf(ls[g], 1e-30f));
      } else {
        part[(static_cast<int64_t>(r) * nsplit + split) * (D + 2) + 2 + d] = acc[c][j];
      }
    }
  }
  if (nsplit > 1) {
    for (int g = tid; g < G; g += kThreads) {
      float* pr = part + (static_cast<int64_t>(row0 + g) * nsplit + split) * (D + 2);
      pr[0] = ms[g];
      pr[1] = ls[g];
    }
  }
}

// grid (B * H), block D threads: merge the splits' (m, l, acc) of one row.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                               int nsplit, int D) {
  const int r = blockIdx.x, d = threadIdx.x;
  const float* pr = part + static_cast<int64_t>(r) * nsplit * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pr[s * (D + 2)]);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pr[s * (D + 2)] - m);
    l = fmaf(pr[s * (D + 2) + 1], w, l);
    o = fmaf(pr[s * (D + 2) + 2 + d], w, o);
  }
  out[static_cast<int64_t>(r) * D + d] = from_f<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   void* out, float* part, int B, int H, int KV, int T_len, int D,
                   int nsplit, int chunk, float scale, cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, GMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(GMAX, 256)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(nsplit, B * KV);
  decode_kernel<T, GMAX><<<grid, kThreads, smem_bytes(H / KV, D), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      length, static_cast<T*>(out), part, H, KV, T_len, D, nsplit, chunk, scale);
  if (nsplit > 1) {
    combine_kernel<T><<<B * H, D, 0, s>>>(part, static_cast<T*>(out), nsplit, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int G, const void* q, const void* k, const void* v, const int* len,
                     void* out, float* part, int B, int H, int KV, int T_len, int D,
                     int nsplit, int chunk, float scale, cudaStream_t s) {
  if (G <= 1) return launch<T, 1>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  if (G <= 2) return launch<T, 2>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  if (G <= 4) return launch<T, 4>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  if (G <= 8) return launch<T, 8>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  if (G <= 16) return launch<T, 16>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  if (G <= 32) return launch<T, 32>(q, k, v, len, out, part, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D), k and v (B, T, KV, D), out (B, H, D), all of one dtype
// (dtype 0: float32, 1: bfloat16), row-major, contiguous and 16-byte
// aligned; length (B,) int32; part: nsplit > 1 ? (B * H * nsplit * (D + 2))
// float32 scratch : unused. D in {16, 32, 64, 128, 256}, H % KV == 0,
// H / KV <= 32, chunk a multiple of 64 with nsplit * chunk >= T. All on
// the device of `stream`. Returns cudaGetLastError() after the launches.
extern "C" int attn_decode(const void* q, const void* k, const void* v,
                           const void* length, void* out, void* part, int dtype,
                           int B, int H, int KV, int T_len, int D, int nsplit,
                           int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || T_len <= 0 || nsplit <= 0 || chunk % kTile != 0 ||
      !(D == 16 || D == 32 || D == 64 || D == 128 || D == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* p = static_cast<float*>(part);
  const int G = H / KV;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(G, q, k, v, len, out, p, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(G, q, k, v, len, out, p, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
