// Flash attention, forward (GQA, causal and/or sliding-window masks), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention :136, _flash_fwd :78). With q (B, S, H, D), k and v
// (B, S, KV, D), G = H / KV and scale = 1 / sqrt(D):
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale)
//                  v[b, j, h / G]
// over the keys j allowed by the masks (causal: j <= i; window w:
// i - j < w). Masked logits take the value -1e30, as in the reference.
// Logits, the running max m, the normaliser l and the accumulator are f32;
// the output is in q's dtype.
//
// Bound on this card: operations at the prefill shapes. At qwen3-1.7b's
// prefill (B = 2, S = 4096, H = 16, D = 128, causal) the two products are
// 4 * D flops per unmasked (query, key) pair, 137 GFLOP, 0.14 ms at the
// 989 TFLOP/s of the bf16 tensor cores; q, k, v and out are 100 MB, 0.03 ms.
//
// Three variants; the caller names one (kernels/flash_attention.py::
// kernel_variant) and a variant that cannot serve the shape is refused,
// never replaced:
// - wgmma (bf16, D in {64, 112, 128, 256}; every model's prefill):
//   FlashAttention-3 shaped. One block per (128 query rows, head, batch).
//   Q is loaded once and K and V tiles of 128 keys (64 at D = 256) stream
//   through a 2-stage ring with TMA (q a 4-D tensor map (D, H, S, B), k
//   and v (D, KV, S, B); each tile is D / 64 boxes of 64 columns with the
//   128-byte swizzle; each stage has a full mbarrier for K and for V). Two
//   consumer warpgroups each own 64 query rows and take turns at the
//   tensor cores (pingpong, over named barriers), so one's softmax overlaps
//   the other's products. S = Q K^T is a wgmma with both operands in
//   shared memory (K is K-major); the online softmax runs on the f32
//   accumulator in registers, in base 2 (log2(e) folded into the scale,
//   ex2.approx); O += P V is a wgmma with P in registers, converted from
//   the S accumulator to bf16 fragments in place, and V read as an
//   MN-major operand (the transposed form). TMA zero-fills rows past S;
//   keys past S are masked and rows past S not stored. D = 112 (kimi-k2)
//   runs as D = 128: the tensor maps keep D = 112 columns, so the second
//   64-column box of every tile reads columns 112-127 as zeros, Q K^T over
//   128 columns is exact, P V runs at N = 128 and only 112 columns are
//   stored; the scale is 1 / sqrt(112).
//   At D in {112, 128} a producer warpgroup (384 threads a block) streams
//   K and V, waiting on an empty mbarrier per stage that the consumers
//   arrive on. At D = 64 and 256 the block is the two consumer warpgroups
//   alone (below). At D = 64 that ran musicgen-medium's and hymba-1.5b's
//   prefills 12-21% faster than with a producer; at D = 112 and 128 it
//   ran 3-4% slower (PERF.md).
//   ptxas gives a thread at most the register file over the block's
//   threads (168 of 384), and setmaxnreg did not raise that for the code
//   after it: with a producer warpgroup and setmaxnreg 240, the D = 256
//   consumers were compiled to 168 registers, spilled 272-296 bytes and
//   serialized their wgmma (so did a lone producer warp, 288 threads).
//   D = 256 (paligemma-3b) needs about 200: its O (64 x 256 f32) is 128
//   registers a thread, S and P of 64 keys 32 + 16 more. So at D = 256 the
//   block is the two consumer warpgroups alone (256 threads, up to 255
//   registers): thread 0 loads Q and the first two stages, and the second
//   warpgroup to release a stage (a shared-memory count) loads the stage's
//   next tile. Its K / V tiles hold 64 keys: 128 keys would take S and P
//   to 64 + 32 registers, and Q (64 KB) with two stages of 128-key K and V
//   would need 320 KB of the 227 KB of shared memory (with 64 keys, 192
//   KB). S = Q K^T is then a wgmma at N = 64 and O += P V one at N = 256
//   per 16 keys.
// - mma (bf16, D in {16, 32, 256}; 64, 112 and 128 are the wgmma variant's
//   alone, so the entry refuses mma there; at D = 256 no model path takes
//   it, and kernels/flash_attention.py::launch_variant runs it beside
//   wgmma): mma.sync.m16n8k16, FlashAttention-2 style: one block of 4
//   warps per (64 query rows, head, batch), 16 rows a warp; K and V tiles
//   of 64 keys staged in shared memory (rows padded by 8 elements against
//   bank conflicts); S, the mask, the online softmax and O = O * alpha + P
//   V in registers.
// - simt (f32, full f32, no TF32): one block per (16 query rows, head,
//   batch), 8 threads a row, each owning D / 8 columns of q and of the
//   accumulator; keys stream through shared memory in tiles of 32 with a
//   per-key online softmax.
// All three keep one numeric contract: logits, m, l and the accumulator in
// f32; masked logits at -1e30; the probabilities enter the PV product in
// q's dtype (bf16 is the reference oracle's cast point), l sums the f32
// probabilities; the output is rounded to q's dtype once. GQA is indexing:
// query head h reads kv-head h / G, with no replication. Only tiles on the
// causal diagonal, at the window's edge or past S evaluate the mask; key
// tiles that every row of the block masks out are skipped, and the causal
// blocks with the most keys are scheduled first. Any S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
enum Variant { kSimt = 0, kMma = 1, kWgmma = 2 };

// ---- bf16: tensor cores (mma.sync) ----------------------------------------

constexpr int kBQ = 64;   // query rows per block (16 per warp)
constexpr int kBK = 64;   // keys per tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 2 * kBK) * (D + 8);
}

// Copy rows [r0, r0 + 64) of a (S, stride) bf16 matrix (row r at
// base + r * stride) into shared memory with row pitch LD, zero past S.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          int64_t stride, int r0, int S) {
  constexpr int LD = D + 8, VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += kMmaThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(base + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// grid (ceil(S / 64), H, B)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int S, int H, int KV, int causal, int window, float scale) {
  constexpr int LD = D + 8;
  constexpr int ND = D / 8;  // accumulator n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * LD;
  __nv_bfloat16* vs = ks + kBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_a = q0 + warp * 16 + gid, row_b = row_a + 8;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(KV) * D;
  load_tile<D>(qs, q + (static_cast<int64_t>(b) * S * H + h) * D, q_stride, q0, S);
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  int k_end = S;
  if (causal) k_end = min(S, q0 + kBQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - (window - 1));
  k_begin = (k_begin / kBK) * kBK;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  const __nv_bfloat16* qw = qs + (warp * 16) * LD;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // previous tile consumed
    load_tile<D>(ks, kb, kv_stride, kt, S);
    load_tile<D>(vs, vb, kv_stride, kt, S);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      const uint32_t a0 = ld32(qw + gid * LD + c);
      const uint32_t a1 = ld32(qw + (gid + 8) * LD + c);
      const uint32_t a2 = ld32(qw + gid * LD + c + 8);
      const uint32_t a3 = ld32(qw + (gid + 8) * LD + c + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + gid) * LD + c;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    const bool edge = (kt + kBK > S) || (causal && kt + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - kt >= window);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int key = kt + n * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool ok = key < S && (!causal || key <= row) &&
                          (window <= 0 || row - key < window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - mn_a);
      s[n][1] = expf(s[n][1] - mn_a);
      s[n][2] = expf(s[n][2] - mn_b);
      s[n][3] = expf(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + sum_a;  // per-thread partial; the row's 4 threads sum at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {  // keys j*16 .. j*16 + 15
      const uint32_t p0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t p1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t p2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = vs + (j * 16 + tig * 2) * LD + gid;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = v0 + n * 8;
        const uint32_t b0 = pack_bf16(vr[0], vr[LD]);
        const uint32_t b1 = pack_bf16(vr[8 * LD], vr[9 * LD]);
        mma_bf16(o[n], p0, p1, p2, p3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f), inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * S * H + h) * D + tig * 2;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + n * 8) =
          pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + n * 8) =
          pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int kWRows = 128;     // query rows per block, 64 per consumer warpgroup
constexpr int kWStages = 2;
constexpr int kWRowBytes = 128;  // a box row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// The tile of head dim D: DP = D rounded up to 64 is the width computed, NB
// boxes of 64 columns; KEYS keys a K / V tile (64 at D = 256, see the top).
// A Q tile is NB boxes of 128 rows (16 KB each), a K or V tile NB boxes of
// KEYS rows. PRODUCER: a producer warpgroup streams K and V (384 threads);
// without one (D = 64 and 256) the block is the two consumer warpgroups
// (256).
template <int D>
struct WTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int NB = DP / 64;
  static constexpr int KEYS = DP > 128 ? 64 : 128;
  static constexpr bool PRODUCER = DP == 128;
  static constexpr int THREADS = PRODUCER ? 384 : 256;
  static constexpr int QBOX = kWRows * kWRowBytes;
  static constexpr int KBOX = KEYS * kWRowBytes;
  static constexpr int QTILE = NB * QBOX;
  static constexpr int KTILE = NB * KBOX;
  static constexpr size_t SMEM = 1024 + QTILE + 2 * kWStages * static_cast<size_t>(KTILE) +
                                 (1 + 4 * kWStages) * sizeof(uint64_t) +
                                 2 * kWStages * sizeof(int);
};

template <int KEYS>
struct QkMma;  // S (64 x KEYS) += Q (64 x 16) K^T (16 x KEYS), both K-major

template <>
struct QkMma<128> {
  static __device__ __forceinline__ void run(float (&s)[64], uint64_t a, uint64_t b, int acc) {
    hopper::wgmma_m64n128k16_ss(s, a, b, acc);
  }
};

template <>
struct QkMma<64> {
  static __device__ __forceinline__ void run(float (&s)[32], uint64_t a, uint64_t b, int acc) {
    hopper::wgmma_m64n64k16_ss(s, a, b, acc);
  }
};

template <int D>
struct PvMma;  // O (64 x D) += P (64 x 16, registers) V (16 x D, MN-major)

template <>
struct PvMma<256> {
  static __device__ __forceinline__ void run(float (&o)[128], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t d) {
    hopper::wgmma_m64n256k16_rs_tb(o, a0, a1, a2, a3, d, 1);
  }
};

template <>
struct PvMma<128> {
  static __device__ __forceinline__ void run(float (&o)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t d) {
    hopper::wgmma_m64n128k16_rs_tb(o, a0, a1, a2, a3, d, 1);
  }
};

template <>
struct PvMma<64> {
  static __device__ __forceinline__ void run(float (&o)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t d) {
    hopper::wgmma_m64n64k16_rs_tb(o, a0, a1, a2, a3, d, 1);
  }
};

// S = Q K^T for one key tile (64 x KEYS per warpgroup), both operands
// K-major in shared memory; committed as one group.
// Descriptors are a base plus a constant step: the start address moves by
// 32 bytes per 16 values of K inside a box and by a box to the next one.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[WTile<D>::KEYS / 2], uint64_t qd,
                                         uint64_t kd) {
  using T = WTile<D>;
#pragma unroll
  for (int kk = 0; kk < T::DP / 16; ++kk) {
    const int in_box = (kk % 4) * 32;
    QkMma<T::KEYS>::run(sc, qd + (((kk / 4) * T::QBOX + in_box) >> 4),
                        kd + (((kk / 4) * T::KBOX + in_box) >> 4), kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V for one key tile: P from registers, V MN-major in shared
// memory; committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[WTile<D>::DP / 2],
                                         const uint32_t (&p)[WTile<D>::KEYS / 4], uint64_t vd) {
  using T = WTile<D>;
#pragma unroll
  for (int kk = 0; kk < T::KEYS / 16; ++kk)
    PvMma<T::DP>::run(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                      vd + ((kk * 16 * kWRowBytes) >> 4));
  hopper::wgmma_commit();
}

// One thread's two rows (a and b) of the online softmax.
struct RowState {
  float m_a, m_b;    // running max, log2 domain
  float l_a, l_b;    // this thread's part of the running sum
  float al_a, al_b;  // the last tile's rescale factor for O
};

// 2^x by the MUFU unit alone (flushes denormal results to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (one 64 x KEYS tile, in the accumulator layout) -> f32 probabilities
// in place, updating the row state; the max is taken over the scaled
// logits. On an edge tile the logits are scaled first, and each row keeps
// the keys kt + [lo, hi] of the tile while every other logit takes -1e30;
// elsewhere nothing is masked and the scale folds into the exponent's FMA.
template <int KEYS>
__device__ __forceinline__ void softmax_tile(float (&sc)[KEYS / 2], RowState& r,
                                             float scale_log2, bool edge, int kt, int row_a,
                                             int S, int causal, int window, int lane) {
  float mul = scale_log2;  // what the exponent's FMA still applies
  if (edge) {
    int hi_a = S - 1 - kt, hi_b = hi_a, lo_a = -KEYS, lo_b = -KEYS;
    if (causal) {
      hi_a = min(hi_a, row_a - kt);
      hi_b = min(hi_b, row_a + 8 - kt);
    }
    if (window > 0) {
      lo_a = row_a - (window - 1) - kt;
      lo_b = lo_a + 8;
    }
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * (lane % 4) + 8 * j + (e & 1);
        const bool ok = e < 2 ? (col <= hi_a && col >= lo_a) : (col <= hi_b && col >= lo_b);
        sc[4 * j + e] = ok ? sc[4 * j + e] * scale_log2 : kNegInf;
      }
    }
    mul = 1.0f;
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(r.m_a, mx_a * mul), mn_b = fmaxf(r.m_b, mx_b * mul);
  r.al_a = fast_exp2(r.m_a - mn_a);
  r.al_b = fast_exp2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], mul, -mn_a));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], mul, -mn_a));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], mul, -mn_b));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], mul, -mn_b));
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l_a = r.l_a * r.al_a + sum_a;  // the row's 4 threads sum at the end
  r.l_b = r.l_b * r.al_b + sum_b;
}

// Whether some (row, key) pair of a warpgroup's 64 rows from qw0 and the
// KEYS keys from kt is masked (or past S).
template <int KEYS>
__device__ __forceinline__ bool edge_tile(int kt, int qw0, int S, int causal, int window) {
  return (kt + KEYS > S) || (causal && kt + KEYS - 1 > qw0) ||
         (window > 0 && qw0 + 63 - kt >= window);
}

// f32 probabilities -> the bf16 A fragments of P (4 registers per 16 keys):
// n-block j of row a lands in p[2j], of row b in p[2j + 1].
template <int KEYS>
__device__ __forceinline__ void to_frags(const float (&sc)[KEYS / 2], uint32_t (&p)[KEYS / 4]) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    p[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float al_a, float al_b) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
}

// Pingpong between the consumer warpgroups over named barriers 1 and 2:
// warpgroup c waits for its turn (barrier 1 + c) before issuing products
// and gives the turn (barrier 2 - c) after.
__device__ __forceinline__ void take_turn(int c) {
  if (c == 0) hopper::named_sync<1, 256>();
  else hopper::named_sync<2, 256>();
}

__device__ __forceinline__ void give_turn(int c) {
  if (c == 0) hopper::named_arrive<2, 256>();
  else hopper::named_arrive<1, 256>();
}

// One K or V tile (keys kt ..) into a stage, its bytes announced on `full`.
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* dst, const CUtensorMap* map, uint64_t* full,
                                        int kvh, int kt, int b) {
  using T = WTile<D>;
  hopper::mbar_expect_tx(full, T::KTILE);
#pragma unroll
  for (int j = 0; j < T::NB; ++j)
    hopper::tma_load_4d(dst + j * T::KBOX, map, full, 64 * j, kvh, kt, b);
}

// Counts a consumer warpgroup's release of a stage (a shared-memory count
// that grows by 2 a tile): true for the second of the two warpgroups, the
// one that refills the stage.
__device__ __forceinline__ bool second_release(int* count) {
  return (atomicAdd(count, 1) & 1) != 0;
}

// grid (ceil(S / 128), H, B)
//
// The two consumer warpgroups take turns at the tensor cores
// (FlashAttention-3's "pingpong", over named barriers 1 and 2): a
// warpgroup issues its S = Q K^T only after the other has issued its own,
// so one's softmax runs while the other's products do. K is released as
// soon as S is computed and V after the PV product, so K's stage refills
// while V is still in use: with a producer, each release is an arrival on
// the stage's empty barrier, which the producer waits for; without one,
// the second warpgroup to release a stage loads the stage's next tile.
// D is the head dim stored; WTile<D>::DP is the width computed.
template <int D>
__global__ void __launch_bounds__(WTile<D>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   int S, int H, int KV, int causal, int window, float scale_log2) {
  using T = WTile<D>;
  constexpr int KEYS = T::KEYS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align1024(smem_raw);
  uint8_t* ks = qs + T::QTILE;                  // kWStages K tiles
  uint8_t* vs = ks + kWStages * T::KTILE;       // kWStages V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kWStages * T::KTILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kWStages;
  uint64_t* k_empty = v_full + kWStages;        // with a producer
  uint64_t* v_empty = k_empty + kWStages;
  int* k_released = reinterpret_cast<int*>(v_empty + kWStages);  // without one
  int* v_released = k_released + kWStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kWRows;
  int k_end = S;
  if (causal) k_end = min(S, q0 + kWRows);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - (window - 1));
  k_begin = (k_begin / KEYS) * KEYS;
  const int ntiles = (k_end - k_begin + KEYS - 1) / KEYS;
  // the warpgroup, made warp-uniform for the compiler by a shuffle
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2);  // one arrival per consumer warpgroup
      hopper::mbar_init(&v_empty[s], 2);
      k_released[s] = v_released[s] = 0;
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // Q, and without a producer the first stages
    hopper::prefetch_map(&qmap);
    hopper::prefetch_map(&kmap);
    hopper::prefetch_map(&vmap);
    hopper::mbar_expect_tx(q_full, T::QTILE);
#pragma unroll
    for (int j = 0; j < T::NB; ++j)
      hopper::tma_load_4d(qs + j * T::QBOX, &qmap, q_full, 64 * j, h, q0, b);
    if constexpr (!T::PRODUCER) {
      for (int it = 0; it < kWStages && it < ntiles; ++it) {
        load_kv<D>(ks + it * T::KTILE, &kmap, &k_full[it], kvh, k_begin + it * KEYS, b);
        load_kv<D>(vs + it * T::KTILE, &vmap, &v_full[it], kvh, k_begin + it * KEYS, b);
      }
    }
  }
  if constexpr (T::PRODUCER) {
    if (wg == 0) {  // the producer warpgroup: thread 0 streams K and V
      if (threadIdx.x == 0) {
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % kWStages;
          const uint32_t parity = ((it / kWStages) - 1) & 1;
          const int kt = k_begin + it * KEYS;
          if (it >= kWStages) hopper::mbar_wait(&k_empty[s], parity);
          load_kv<D>(ks + s * T::KTILE, &kmap, &k_full[s], kvh, kt, b);
          if (it >= kWStages) hopper::mbar_wait(&v_empty[s], parity);
          load_kv<D>(vs + s * T::KTILE, &vmap, &v_full[s], kvh, kt, b);
        }
      }
      return;
    }
  }
  // consumers: query rows q0 + 64 c .. + 63
  const int c = T::PRODUCER ? wg - 1 : wg;
  const bool leader = threadIdx.x % 128 == 0;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qw0 = q0 + 64 * c;
  const int row_a = qw0 + 16 * w + lane / 4, row_b = row_a + 8;
  // this warpgroup's 64 rows of Q; K (K-major) and V (MN-major: LBO the
  // step between 64-column boxes) of stage 0
  const uint64_t qd = hopper::smem_desc(qs + c * 64 * kWRowBytes, 16, 1024);
  const uint64_t kd0 = hopper::smem_desc(ks, 16, 1024);
  const uint64_t vd0 = hopper::smem_desc(vs, T::KBOX, 1024);
  constexpr uint64_t kStageStep = T::KTILE >> 4;

  float o[T::DP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.0f;
  float sc[KEYS / 2];
  uint32_t p[KEYS / 4];
  RowState r{kNegInf, kNegInf, 0.0f, 0.0f, 0.0f, 0.0f};
  if (c == 1) hopper::named_arrive<1, 256>();  // the first turn is warpgroup 0's
  hopper::mbar_wait(q_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int cur = it % kWStages;
    const uint32_t parity = (it / kWStages) & 1;
    const int kt = k_begin + it * KEYS;
    const bool refill = it + kWStages < ntiles;
    hopper::mbar_wait(&k_full[cur], parity);
    take_turn(c);
    hopper::wgmma_fence();
    issue_qk<D>(sc, qd, kd0 + cur * kStageStep);
    if (c == 0 || it + 1 < ntiles) give_turn(c);  // warpgroup 1 gives one turn fewer
    hopper::wgmma_wait<0>();
    hopper::pin(sc);
    if (leader) {
      if constexpr (T::PRODUCER)
        hopper::mbar_arrive(&k_empty[cur]);
      else if (second_release(&k_released[cur]) && refill)
        load_kv<D>(ks + cur * T::KTILE, &kmap, &k_full[cur], kvh, kt + kWStages * KEYS, b);
    }
    softmax_tile<KEYS>(sc, r, scale_log2, edge_tile<KEYS>(kt, qw0, S, causal, window), kt,
                       row_a, S, causal, window, lane);
    to_frags<KEYS>(sc, p);
    rescale(o, r.al_a, r.al_b);
    hopper::mbar_wait(&v_full[cur], parity);
    hopper::pin(o);
    hopper::pin(p);
    hopper::wgmma_fence();
    issue_pv<D>(o, p, vd0 + cur * kStageStep);
    hopper::wgmma_wait<0>();
    hopper::pin(o);
    hopper::pin(p);
    if (leader) {
      if constexpr (T::PRODUCER)
        hopper::mbar_arrive(&v_empty[cur]);
      else if (second_release(&v_released[cur]) && refill)
        load_kv<D>(vs + cur * T::KTILE, &vmap, &v_full[cur], kvh, kt + kWStages * KEYS, b);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, off);
    r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(r.l_a, 1e-30f), inv_b = 1.0f / fmaxf(r.l_b, 1e-30f);
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * S * H + h) * D + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + 8 * j) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + 8 * j) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int H, int KV, int causal, int window, float scale,
                         cudaStream_t s) {
  using T = WTile<D>;
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::SMEM));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // (D, heads, S, B) maps; boxes of 64 columns x 1 head x 128 rows (Q) or
  // KEYS rows (K, V)
  const cuuint32_t boxes[2][4] = {{64, 1, kWRows, 1}, {64, 1, T::KEYS, 1}};
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t heads = i == 0 ? H : KV;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), heads, static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {D * 2, heads * D * 2, static_cast<cuuint64_t>(S) * heads * D * 2};
    const cudaError_t e =
        hopper::bf16_map(&maps[i], bases[i], 4, dims, strides, boxes[i == 0 ? 0 : 1]);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kWRows - 1) / kWRows, H, B);
  flash_wgmma_kernel<D><<<grid, T::THREADS, T::SMEM, s>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), S, H, KV, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

// ---- f32: SIMT, full float32 ----------------------------------------------

constexpr int kRows = 16;     // query rows per block
constexpr int kLanes = 8;     // threads per row
constexpr int kKeys = 32;     // keys per shared-memory tile
constexpr int kSimtThreads = kRows * kLanes;

size_t simt_smem_bytes(int D) { return sizeof(float) * 2 * kKeys * D; }

// grid (ceil(S / 16), H, B); D a multiple of 8, at most 256.
__global__ void __launch_bounds__(kSimtThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int H,
                 int KV, int D, int causal, int window, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;               // [kKeys][D]
  float* vs = fsm + kKeys * D;   // [kKeys][D]
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int r = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
  const int row = q0 + r;
  const int ncol = D / kLanes;  // columns j, j + 8, ... of this thread

  float qv[32], acc[32];
  const float* qr = q + ((static_cast<int64_t>(b) * S + row) * H + h) * D;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qv[i] = (i < ncol && row < S) ? qr[j + kLanes * i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  int k_end = S;
  if (causal) k_end = min(S, q0 + kRows);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - (window - 1));
  const int64_t kv_stride = static_cast<int64_t>(KV) * D;
  const float* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const float* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    const int nk = min(kKeys, k_end - kt);
    __syncthreads();
    for (int i = threadIdx.x; i < kKeys * D; i += kSimtThreads) {
      const int t = i / D, c = i % D;
      ks[i] = t < nk ? kb[(kt + t) * kv_stride + c] : 0.0f;
      vs[i] = t < nk ? vb[(kt + t) * kv_stride + c] : 0.0f;
    }
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      const float* kr = ks + t * D + j;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < ncol) part = fmaf(qv[i], kr[kLanes * i], part);
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = kt + t;
      const bool ok = (!causal || key <= row) && (window <= 0 || row - key < window);
      const float x = ok ? part * scale : kNegInf;
      const float mn = fmaxf(m, x);
      const float alpha = expf(m - mn), p = expf(x - mn);
      l = l * alpha + p;
      m = mn;
      const float* vr = vs + t * D + j;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < ncol) acc[i] = fmaf(p, vr[kLanes * i], acc[i] * alpha);
    }
  }
  if (row < S) {
    float* orow = out + ((static_cast<int64_t>(b) * S + row) * H + h) * D;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < ncol) orow[j + kLanes * i] = acc[i] * inv;
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int KV, int causal, int window, float scale,
                       cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mma_smem_bytes(D)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_mma_kernel<D><<<grid, kMmaThreads, mma_smem_bytes(D), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, KV,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), out (B, S, H, D), one dtype
// (dtype 0: float32, 1: bfloat16), row-major, contiguous, 16-byte aligned,
// on the device of `stream`; H % KV == 0; causal 0/1; window <= 0 for none.
// variant 0 simt (f32, D a multiple of 8 up to 256), 1 mma (bf16, D in
// {16, 32, 256}), 2 wgmma (bf16, D in {64, 112, 128, 256}). Returns
// cudaErrorInvalidValue for a variant that cannot serve the call, else
// cudaGetLastError().
extern "C" int attn_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              int dtype, int variant, int B, int S, int H, int KV, int D,
                              int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 ||
      !(D == 16 || D == 32 || D == 64 || D == 112 || D == 128 || D == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64: return static_cast<int>(launch_wgmma<64>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 112: return static_cast<int>(launch_wgmma<112>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 128: return static_cast<int>(launch_wgmma<128>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 256: return static_cast<int>(launch_wgmma<256>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant == kMma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 16: return static_cast<int>(launch_mma<16>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 32: return static_cast<int>(launch_mma<32>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 256: return static_cast<int>(launch_mma<256>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != kSimt || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(simt_smem_bytes(256)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_f32_kernel<<<grid, kSimtThreads, simt_smem_bytes(D), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV, D, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}
