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
// Design:
// - bf16 inputs (the working type) run on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style:
//   one block of 4 warps per (64 query rows, head, batch), 16 rows a warp;
//   K and V tiles of 64 keys are staged in shared memory (rows padded by 8
//   elements so the fragment loads do not collide on banks); S = Q K^T, the
//   mask, the online softmax (row max and sum across the 4 threads of a
//   row by shuffles) and O = O * alpha + P V all stay in registers. The
//   probabilities enter the PV product rounded to bf16, the cast point of
//   the reference oracle (ref.attention casts p to q's dtype); l sums the
//   f32 probabilities. A later PR can add TMA loads and wgmma.
// - f32 inputs keep full f32 (no TF32): a SIMT kernel, one block per (16
//   query rows, head, batch), 8 threads a row, each owning D / 8 columns of
//   q and of the accumulator; keys stream through shared memory in tiles of
//   32 with a per-key online softmax.
// - GQA is indexing: query head h reads kv-head h / G; no replication.
// - Key tiles that every row of the block masks out (above the causal
//   diagonal, outside the window) are skipped; the causal blocks with the
//   most keys are scheduled first. Any S: the ragged edge is masked in
//   place (zero-filled rows, mask on the key index), with no block halving.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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
// on the device of `stream`. D in {16, 32, 64, 128, 256}, H % KV == 0;
// causal 0/1; window <= 0 for none. Returns cudaGetLastError().
extern "C" int attn_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              int dtype, int B, int S, int H, int KV, int D, int causal,
                              int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 ||
      !(D == 16 || D == 32 || D == 64 || D == 128 || D == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 16: return static_cast<int>(launch_mma<16>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 32: return static_cast<int>(launch_mma<32>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 64: return static_cast<int>(launch_mma<64>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      case 128: return static_cast<int>(launch_mma<128>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
      default: return static_cast<int>(launch_mma<256>(q, k, v, out, B, S, H, KV, causal, window, scale, s));
    }
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
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
