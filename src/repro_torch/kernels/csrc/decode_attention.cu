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
// tensor cores' rate, and under the f32 rate at small G.
//
// Both variants: one block per (b, kv-head, split of the valid prefix): the
// G query heads of a kv-head share every loaded K/V row, so the cache is
// read once, not G times (the Pallas kernel's GQA tile). Blocks read only
// the valid prefix [0, length) (all T rows when length <= 0), so the time
// follows the lengths, not T. Split-K: when B * KV blocks cannot fill the
// card the wrapper splits each prefix into chunks (a multiple of 64 rows);
// each block writes a partial (m, l, acc) and a second kernel combines the
// splits (log-sum-exp rescaling). Blocks past the prefix write an empty
// partial (m = -1e30, l = 0, acc = 0). The caller names the variant
// (kernels/decode_attention.py::kernel_variant); one that cannot serve the
// shape is refused, never replaced.
//
// - tma (bf16, G <= 16; every model's decode step): built for the bytes
//   bound. A producer warp streams the K and V tiles of the valid prefix,
//   64 rows a tile, into a ring of 3-4 stages guarded by a full and an
//   empty mbarrier each. A tile is ceil(D / 64) boxes of 64 columns x 64
//   rows from a tensor map over the cache viewed as (D, KV, T, B),
//   128-byte swizzled (the ldmatrix reads below are then free of bank
//   conflicts); D = 112's second box reads columns 112-127 as zeros, which
//   no product touches. Rows past the prefix in a tile's last 63 are read
//   but masked, and their V rows zeroed in shared memory before P V; rows
//   past T arrive as zeros. (One cp.async.bulk copy per cache row, tried
//   first, was far slower than whole boxes.) Four consumer warps each own
//   16 rows of every tile
//   and keep their own online softmax over them: the G query heads, padded
//   to 16, are the A operand of mma.sync.m16n8k16 (Q K^T over D / 16
//   steps), the probabilities go to bf16 fragments in registers (the
//   reference's cast point) for P V with V read by ldmatrix.trans, and a
//   warp frees its stage with one arrival; no __syncthreads inside the loop.
//   The four warps' (m, l, acc) merge once in shared memory at the end.
//   D in {64, 112, 128, 256}. The split plan (wrapper) was tuned for this
//   variant: 4 splits at 16 slots of a 4096-row cache.
// - simt (f32, and bf16 at G > 16 or D < 64): per 64-row tile, K staged in shared
//   memory as f32 (rows padded to D + 4 floats); each thread computes one
//   row's logits for half the heads; one warp per head takes the tile's max
//   and rescales once per tile; the PV product reads V straight from device
//   memory (neighbouring threads, neighbouring columns).
// Any T: the last tile is ragged and masked in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
  // 1 or 2; threads past hgroups * dcols (D = 112) take no columns
  const int cpt = tid < hgroups * dcols ? D / dcols : 0;
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

// ---- bf16: TMA ring + mma.sync ("tma") ------------------------------------

constexpr int kRows = 64;                        // cache rows per tile
constexpr int kConsumers = 4;                    // consumer warps, 16 rows each
constexpr int kRingThreads = 32 * (kConsumers + 1);
constexpr int kHeads = 16;                       // query rows of the mma (G padded)
constexpr float kLog2e = 1.4426950408889634f;

// Each K or V tile is ceil(D / 64) boxes of 64 rows x 128 bytes from a
// tensor map, 128-byte swizzled (1024-byte aligned); q rows sit at a padded
// pitch of 2 D + 16 bytes.
template <int D>
struct Ring {
  static constexpr int kPitch = 2 * D + 16;      // bytes per row of q
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kTile = kBoxes * kRows * 128;  // K or V
  static constexpr int kStages = D <= 64 ? 4 : 3;
  static constexpr int kStage = 2 * kTile;       // K then V
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kStage + static_cast<size_t>(kHeads) * kPitch +
      2 * kStages * sizeof(uint64_t);
  // the consumers' (m, l) and accumulators, merged at the end in the ring
  static_assert(sizeof(float) * kConsumers * kHeads * (D + 2) <=
                    static_cast<size_t>(kStages) * kStage,
                "merge area");
};

// 2^x by the MUFU unit alone (flushes denormal results to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of (row r, 16-byte chunk at byte column cb) in a K or V tile:
// box cb / 128, and the 128-byte swizzle, chunk ^ (row % 8).
__device__ __forceinline__ int tile_off(int r, int cb) {
  const int cc = (cb >> 4) & 7;
  return (cb >> 7) * (kRows * 128) + r * 128 + ((cc ^ (r & 7)) << 4);
}

// grid (nsplit, B * KV), kRingThreads threads: warps 0-3 consume, warp 4
// produces. G <= 16, D >= 64. kmap and vmap: the caches as (D, KV, T, B)
// maps with boxes of 64 columns x 64 rows.
template <int D>
__global__ void __launch_bounds__(kRingThreads)
decode_ring_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const __nv_bfloat16* __restrict__ q,
                   const int* __restrict__ length, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part, int H, int KV, int T_len, int nsplit, int chunk,
                   float scale_log2) {
  using R = Ring<D>;
  constexpr int P = R::kPitch, NS = R::kStages;
  extern __shared__ __align__(16) uint8_t ring_smem[];
  uint8_t* ring = hopper::align1024(ring_smem);             // NS x {K, V} tiles
  uint8_t* qs = ring + NS * R::kStage;                      // [16][P]
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + kHeads * P);
  uint64_t* empty = full + NS;

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int split = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = length[b];
  const bool all_masked = len <= 0;
  const int n_keys = all_masked ? T_len : min(len, T_len);
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, n_keys);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + kRows - 1) / kRows : 0;
  const int row0 = b * H + kvh * G;  // first query row (b, h) of this block

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < kHeads * (D / 8); i += kRingThreads) {
    const int g = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < G) val = *reinterpret_cast<const uint4*>(q + static_cast<int64_t>(row0 + g) * D + c);
    *reinterpret_cast<uint4*>(qs + g * P + 2 * c) = val;
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer: whole boxes; rows past T arrive as zeros
    for (int it = 0; it < ntiles && lane == 0; ++it) {
      const int s = it % NS;
      const int t0 = t_begin + it * kRows;
      if (it >= NS) hopper::mbar_wait(&empty[s], ((it / NS) - 1) & 1);
      uint8_t* ks = ring + s * R::kStage;
      uint8_t* vs = ks + R::kTile;
      hopper::mbar_expect_tx(&full[s], R::kStage);
#pragma unroll
      for (int j = 0; j < R::kBoxes; ++j) {
        hopper::tma_load_4d(ks + j * kRows * 128, &kmap, &full[s], 64 * j, kvh, t0, b);
        hopper::tma_load_4d(vs + j * kRows * 128, &vmap, &full[s], 64 * j, kvh, t0, b);
      }
    }
    return;
  }

  // consumers: warp w owns rows [16 w, 16 w + 16) of every tile; lane (gid,
  // tig) holds heads gid (a) and gid + 8 (b).
  const int gid = lane >> 2, tig = lane & 3, r0 = warp * 16;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  const uint8_t* qa = qs + (lane & 15) * P + (lane >> 4) * 16;  // ldmatrix rows of Q
  const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 16;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3), vcol = (lane >> 4) * 16;

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NS;
    const int t0 = t_begin + it * kRows;
    const int nt = min(kRows, t_end - t0);
    uint8_t* ks = ring + s * R::kStage;
    uint8_t* vs = ks + R::kTile;
    hopper::mbar_wait(&full[s], (it / NS) & 1);
    if (r0 < nt) {
      if (r0 + 16 > nt) {  // ragged tile: zero this warp's V rows past nt (p = 0 there)
        const int zr = r0 + 16 - nt;
        for (int i = lane; i < zr * (D / 8); i += 32)
          *reinterpret_cast<uint4*>(vs + tile_off(nt + i / (D / 8), (i % (D / 8)) * 16)) =
              make_uint4(0u, 0u, 0u, 0u);
        hopper::fence_proxy_async();  // before TMA rewrites the stage
        __syncwarp();
      }
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // S = Q K^T over 16 columns at a time
        uint32_t a[4], kf[4];
        hopper::ldsm_x4(a, qa + kk * 32);
        hopper::ldsm_x4(kf, ks + tile_off(r0 + krow, kk * 32 + kcol));
        hopper::mma_16816(sc[0], a, kf[0], kf[1]);
        hopper::mma_16816(sc[1], a, kf[2], kf[3]);
      }
      // online softmax in base 2 over this warp's 16 keys
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = r0 + 8 * j + 2 * tig + (e & 1) < nt;
          sc[j][e] = ok ? (all_masked ? 0.0f : sc[j][e] * scale_log2) : -INFINITY;
          if (e < 2) mx_a = fmaxf(mx_a, sc[j][e]);
          else mx_b = fmaxf(mx_b, sc[j][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float sa = mn_a == -INFINITY ? 0.0f : mn_a;  // nothing valid yet
      const float sb = mn_b == -INFINITY ? 0.0f : mn_b;
      const float al_a = fast_exp2(m_a - sa), al_b = fast_exp2(m_b - sb);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[j][0] = fast_exp2(sc[j][0] - sa);
        sc[j][1] = fast_exp2(sc[j][1] - sa);
        sc[j][2] = fast_exp2(sc[j][2] - sb);
        sc[j][3] = fast_exp2(sc[j][3] - sb);
        sum_a += sc[j][0] + sc[j][1];
        sum_b += sc[j][2] + sc[j][3];
      }
      l_a = l_a * al_a + sum_a;  // this thread's part; the quad sums at the end
      l_b = l_b * al_b + sum_b;
      const uint32_t pa[4] = {hopper::bf16x2(sc[0][0], sc[0][1]), hopper::bf16x2(sc[0][2], sc[0][3]),
                              hopper::bf16x2(sc[1][0], sc[1][1]), hopper::bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
#pragma unroll
      for (int j2 = 0; j2 < D / 16; ++j2) {  // O += P V over 16 columns at a time
        uint32_t vf[4];
        hopper::ldsm_x4_trans(vf, vs + tile_off(r0 + vrow, j2 * 32 + vcol));
        hopper::mma_16816(o[2 * j2], pa, vf[0], vf[1]);
        hopper::mma_16816(o[2 * j2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // merge the four warps' (m, l, acc) in the ring (every copy has landed:
  // each consumer waited on every stage it read)
  hopper::named_sync<1, 32 * kConsumers>();
  float* cm = reinterpret_cast<float*>(ring);  // [4][16] max (base 2)
  float* cl = cm + kConsumers * kHeads;        // [4][16] normaliser
  float* co = cl + kConsumers * kHeads;        // [4][16][D] accumulator
  if (tig == 0) {
    cm[warp * kHeads + gid] = m_a;
    cm[warp * kHeads + gid + 8] = m_b;
    cl[warp * kHeads + gid] = l_a;
    cl[warp * kHeads + gid + 8] = l_b;
  }
  float* ca = co + (warp * kHeads + gid) * D + 2 * tig;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(ca + 8 * j) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(ca + 8 * D + 8 * j) = make_float2(o[j][2], o[j][3]);
  }
  hopper::named_sync<1, 32 * kConsumers>();
  for (int i = threadIdx.x; i < G * D; i += 32 * kConsumers) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, cm[w * kHeads + g]);
    const float ms = mx == -INFINITY ? 0.0f : mx;
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float f = fast_exp2(cm[w * kHeads + g] - ms);
      l = fmaf(cl[w * kHeads + g], f, l);
      acc = fmaf(co[(w * kHeads + g) * D + d], f, acc);
    }
    const int r = row0 + g;
    if (nsplit == 1) {
      out[static_cast<int64_t>(r) * D + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
    } else {
      float* pr = part + (static_cast<int64_t>(r) * nsplit + split) * (D + 2);
      pr[2 + d] = acc;
      if (d == 0) {  // the combine kernel works in natural-log units
        pr[0] = mx == -INFINITY ? kNegInf : mx / kLog2e;
        pr[1] = l;
      }
    }
  }
}

template <int D>
cudaError_t launch_ring(const void* q, const void* k, const void* v, const int* length,
                        void* out, float* part, int B, int H, int KV, int T_len, int nsplit,
                        int chunk, float scale, cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_ring_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Ring<D>::kSmem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // (D, KV, T, B) maps; boxes of 64 columns x 1 head x 64 rows
  CUtensorMap maps[2];
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(T_len), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(KV) * D * 2,
                                 static_cast<cuuint64_t>(T_len) * KV * D * 2};
  const void* bases[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    const cudaError_t e = hopper::bf16_map(&maps[i], bases[i], 4, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nsplit, B * KV);
  decode_ring_kernel<D><<<grid, kRingThreads, Ring<D>::kSmem, s>>>(
      maps[0], maps[1], static_cast<const __nv_bfloat16*>(q), length, static_cast<__nv_bfloat16*>(out), part, H,
      KV, T_len, nsplit, chunk, scale * kLog2e);
  if (nsplit > 1)
    combine_kernel<__nv_bfloat16><<<B * H, D, 0, s>>>(part, static_cast<__nv_bfloat16*>(out),
                                                      nsplit, D);
  return cudaGetLastError();
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
// float32 scratch : unused. D in {16, 32, 64, 112, 128, 256}, H % KV == 0,
// chunk a multiple of 64 with nsplit * chunk >= T. variant 0 simt (H / KV
// <= 32), 1 tma (bf16, H / KV <= 16, D >= 64). All on the device of
// `stream`.
// Returns cudaErrorInvalidValue for a variant that cannot serve the call,
// else cudaGetLastError() after the launches.
extern "C" int attn_decode(const void* q, const void* k, const void* v,
                           const void* length, void* out, void* part, int dtype,
                           int variant, int B, int H, int KV, int T_len, int D,
                           int nsplit, int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || T_len <= 0 || nsplit <= 0 || chunk % kTile != 0 ||
      !(D == 16 || D == 32 || D == 64 || D == 112 || D == 128 || D == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* p = static_cast<float*>(part);
  const int G = H / KV;
  if (variant == 1) {
    if (dtype != 1 || G > kHeads) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64: return static_cast<int>(launch_ring<64>(q, k, v, len, out, p, B, H, KV, T_len, nsplit, chunk, scale, s));
      case 112: return static_cast<int>(launch_ring<112>(q, k, v, len, out, p, B, H, KV, T_len, nsplit, chunk, scale, s));
      case 128: return static_cast<int>(launch_ring<128>(q, k, v, len, out, p, B, H, KV, T_len, nsplit, chunk, scale, s));
      case 256: return static_cast<int>(launch_ring<256>(q, k, v, len, out, p, B, H, KV, T_len, nsplit, chunk, scale, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(G, q, k, v, len, out, p, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(G, q, k, v, len, out, p, B, H, KV, T_len, D, nsplit, chunk, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
