// Gated linear recurrence (Mamba2-SSD heads, xLSTM's mLSTM), prefill, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_scan_kernel
// (linear_scan :75). Per (batch b, head h), from a zero state:
//   S_t = a_t S_{t-1} + k_t v_t^T      (Dk x Dv)
//   n_t = a_t n_{t-1} + k_t            (Dk)
//   y_t = (q_t . S_t) / max(|q_t . n_t|, 1)
// with q, k (B, S, H, Dk), v (B, S, H, Dv), decays a (B, S, H) in (0, 1];
// the math and the state are f32, y is in v's dtype.
//
// Bound on this card: operations. The recurrence does about 4 Dk Dv
// flops a token and head: 34 GFLOP at xlstm-350m's prefill (B = 2, S =
// 4096, 4 heads, Dk = Dv = 512), 0.51 ms at the 67 TFLOP/s of f32 outside
// the tensor cores; its q, k, v and y are 67 MB in bf16, 20 us.
//
// Design (chunked, as the TPU kernel, in chunks of 64 tokens):
//   y_t   = A_t (q_t . S_in) + sum_{i<=t} (A_t / A_i) (q_t . k_i) v_i
//   den_t = A_t (q_t . n_in) + sum_{i<=t} (A_t / A_i) (q_t . k_i)
//   S_out = A_L S_in + sum_i (A_L / A_i) k_i v_i^T       (n_out alike)
// with A the cumulative decay inside the chunk. The TPU kernel takes the
// ratios A_t / A_i as exp of differences of log cumulative sums; those
// sums reach a few hundred at strong decay, and their rounding (1e-5 of
// the ratio) dominates the result's error. Here each ratio is the product
// of the decays between i and t, formed row by row (at most 63 factors,
// each in (0, 1]: no overflow, and a relative error near 1e-6).
// - The state of one (b, h) is Dk x Dv f32: 1 MB at xlstm's 512 x 512,
//   more than a block's shared memory. So one block of 256 threads owns
//   (b, h, a slice of 32 value columns): it keeps its Dk x 32 slice of S
//   and its own copy of n in shared memory (64 KB at Dk = 512) and walks
//   the chunks in order. The chunk's q k^T, decay ratios and denominators
//   do not depend on the slice; every slice block recomputes them, which
//   buys B x H x Dv / 32 blocks (128 at xlstm's B = 2) instead of B x H.
// - Per chunk: the decay ratios (one thread a row); q k^T,
//   q . S_in and q . n_in over the key dimension in tiles of 32 rows; the
//   masked, decay-weighted W = (A_t / A_i) q_t . k_i; y and the
//   denominator; then the slice of S and n updated in place from the
//   decay-weighted keys. All math is SIMT f32.
// - Any S: the last chunk is ragged, its missing rows zero. q, k and v may
//   be strided views (the models slice them out of one projection); the
//   last dimension must be contiguous.
// The final state is not computed here: the wrapper forms it outside the
// kernel when asked, as the TPU kernel's caller does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;      // chunk length
constexpr int kBV = 32;     // value columns per block
constexpr int kTK = 32;     // key-dimension tile
constexpr int kThreads = 256;
constexpr int kLdW = kL + 1;
constexpr int kLdT = kTK + 1;

size_t smem_bytes(int Dk) {
  const size_t floats = static_cast<size_t>(Dk) * kBV + Dk + kL * kLdW + 2 * kL * kLdT +
                        kL * kBV + 3 * kL;  // av, Ae, wl
  return floats * sizeof(float);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
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

struct Strides {
  long long b, s, h;  // elements; the last dimension is contiguous
};

// grid (ceil(Dv / 32), H, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ decay, T* __restrict__ y, int S, int H, int Dk, int Dv,
            Strides qs, Strides ks, Strides vs_) {
  extern __shared__ __align__(16) float sm[];
  float* Ssl = sm;                 // [Dk][kBV]   this block's slice of S
  float* ns = Ssl + Dk * kBV;      // [Dk]        n
  float* W = ns + Dk;              // [kL][kLdW]  decay-weighted q k^T
  float* qt = W + kL * kLdW;       // [kL][kLdT]  q tile
  float* kt = qt + kL * kLdT;      // [kL][kLdT]  k tile
  float* vs = kt + kL * kLdT;      // [kL][kBV]   v slice of the chunk
  float* av = vs + kL * kBV;       // [kL]        decays of the chunk
  float* Ae = av + kL;             // [kL]        A_t
  float* wl = Ae + kL;             // [kL]        A_L / A_t

  const int j0 = blockIdx.x * kBV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs_.b + h * vs_.h + j0;
  const float* ab = decay + static_cast<int64_t>(b) * S * H + h;
  T* yb = y + (static_cast<int64_t>(b) * S * H + h) * Dv + j0;

  // roles: y rows/columns; q k^T entries; state entries
  const int yt = tid >> 2, yj = (tid & 3) * 8;
  const int tq = tid >> 4, ti = tid & 15;
  const int ud = tid >> 3, uj = (tid & 7) * 4;

  for (int i = tid; i < Dk * kBV + Dk; i += kThreads) sm[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int Lc = min(kL, S - c0);
    if (tid < kL) av[tid] = tid < Lc ? ab[static_cast<int64_t>(c0 + tid) * H] : 1.0f;
    for (int i = tid; i < kL * kBV; i += kThreads) {
      const int r = i / kBV, c = i % kBV;
      vs[i] = (r < Lc && j0 + c < Dv) ? to_f(vb[(c0 + r) * vs_.s + c]) : 0.0f;
    }
    __syncthreads();
    if (tid < kL) {  // row t of the ratios: W[t][i] = a_{i+1} ... a_t, i <= t
      float* wr = W + tid * kLdW;
      for (int i = kL - 1; i > tid; --i) wr[i] = 0.0f;
      float r = 1.0f;
      for (int i = tid; i >= 0; --i) {
        wr[i] = r;
        r *= av[i];
      }
      Ae[tid] = r;  // a_0 ... a_t
    }
    __syncthreads();
    if (tid < kL) wl[tid] = W[(Lc - 1) * kLdW + tid];  // A_L / A_t (0 past Lc)

    // q k^T, q . S_in and q . n_in over the key dimension
    float qk[4][4], yc[8], dc = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) qk[r][c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) yc[j] = 0.0f;
    for (int d0 = 0; d0 < Dk; d0 += kTK) {
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < kL * kTK; i += kThreads) {
        const int r = i / kTK, dd = i % kTK;
        const bool ok = r < Lc && d0 + dd < Dk;
        qt[r * kLdT + dd] = ok ? to_f(qb[(c0 + r) * qs.s + d0 + dd]) : 0.0f;
        kt[r * kLdT + dd] = ok ? to_f(kb[(c0 + r) * ks.s + d0 + dd]) : 0.0f;
      }
      __syncthreads();
      const int nd = min(kTK, Dk - d0);
      for (int dd = 0; dd < nd; ++dd) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = qt[(tq + 16 * r) * kLdT + dd];
          bb[r] = kt[(ti + 16 * r) * kLdT + dd];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) qk[r][c] = fmaf(a[r], bb[c], qk[r][c]);
        const float qy = qt[yt * kLdT + dd];
        const float* srow = Ssl + (d0 + dd) * kBV + yj;
#pragma unroll
        for (int j = 0; j < 8; ++j) yc[j] = fmaf(qy, srow[j], yc[j]);
        dc = fmaf(qy, ns[d0 + dd], dc);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = tq + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* w = W + t * kLdW + ti + 16 * c;  // the ratio, 0 above the diagonal
        *w = t < Lc ? *w * qk[r][c] : 0.0f;
      }
    }
    __syncthreads();

    // y and its denominator
    float yi[8], di = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) yi[j] = 0.0f;
    const float* wr = W + yt * kLdW;
    for (int i = 0; i < kL; ++i) {
      const float wv = wr[i];
      const float* vr = vs + i * kBV + yj;
#pragma unroll
      for (int j = 0; j < 8; ++j) yi[j] = fmaf(wv, vr[j], yi[j]);
      di += wv;
    }
    if (yt < Lc) {
      const float At = Ae[yt];
      const float den = fmaxf(fabsf(di + At * dc), 1.0f);
      T* yr = yb + static_cast<int64_t>(c0 + yt) * H * Dv + yj;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j0 + yj + j < Dv) yr[j] = from_f<T>((yi[j] + At * yc[j]) / den);
    }

    // S and n carried to the next chunk, from the decay-weighted keys
    const float AL = Ae[Lc - 1];
    for (int d0 = 0; d0 < Dk; d0 += kTK) {
      __syncthreads();  // k tile and state readers done
      for (int i = tid; i < kL * kTK; i += kThreads) {
        const int r = i / kTK, dd = i % kTK;
        kt[r * kLdT + dd] =
            (r < Lc && d0 + dd < Dk) ? to_f(kb[(c0 + r) * ks.s + d0 + dd]) * wl[r] : 0.0f;
      }
      __syncthreads();
      if (d0 + ud < Dk) {
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < kL; ++i) {
          const float kv = kt[i * kLdT + ud];
          const float* vr = vs + i * kBV + uj;
#pragma unroll
          for (int c = 0; c < 4; ++c) s4[c] = fmaf(kv, vr[c], s4[c]);
        }
        float* srow = Ssl + (d0 + ud) * kBV + uj;
#pragma unroll
        for (int c = 0; c < 4; ++c) srow[c] = AL * srow[c] + s4[c];
      }
      if (tid < kTK && d0 + tid < Dk) {
        float sn = 0.0f;
        for (int i = 0; i < kL; ++i) sn += kt[i * kLdT + tid];
        ns[d0 + tid] = AL * ns[d0 + tid] + sn;
      }
    }
    __syncthreads();  // before the next chunk overwrites av, vs and W
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* decay, void* y,
                   int B, int S, int H, int Dk, int Dv, Strides qs, Strides ks, Strides vs,
                   cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(1024)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Dv + kBV - 1) / kBV, H, B);
  scan_kernel<T><<<grid, kThreads, smem_bytes(Dk), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), decay,
      static_cast<T*>(y), S, H, Dk, Dv, qs, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, S, H, Dk) and v (B, S, H, Dv) in one dtype (0: float32, 1:
// bfloat16), each with element strides (batch, token, head) and a
// contiguous last dimension; decay (B, S, H) float32 and y (B, S, H, Dv)
// in q's dtype, contiguous; all 4-byte aligned on the device of `stream`.
// 1 <= Dk <= 1024. Returns cudaGetLastError().
extern "C" int linear_scan(const void* q, const void* k, const void* v, const void* decay,
                           void* y, int dtype, int B, int S, int H, int Dk, int Dv,
                           long long qsb, long long qss, long long qsh, long long ksb,
                           long long kss, long long ksh, long long vsb, long long vss,
                           long long vsh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > 1024 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float* a = static_cast<const float*>(decay);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, a, y, B, S, H, Dk, Dv, qs, ks, vs, s));
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, a, y, B, S, H, Dk, Dv, qs, ks, vs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
