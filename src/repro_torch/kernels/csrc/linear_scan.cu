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
// 4096, 4 heads, Dk = Dv = 512), 35 us at the 989 TFLOP/s of the bf16
// tensor cores (0.51 ms at the 67 TFLOP/s of f32 outside them); its q, k,
// v and y are 134 MB in bf16, 40 us. The chunked form below also writes and
// reads each chunk's f32 state, B H (S / L) Dk Dv 4 bytes per pass.
//
// The chunked form (L tokens a chunk, A the cumulative decay inside it):
//   y_t   = A_t (q_t . S_in) + sum_{i<=t} (A_t / A_i) (q_t . k_i) v_i
//   den_t = A_t (q_t . n_in) + sum_{i<=t} (A_t / A_i) (q_t . k_i)
//   S_out = A_L S_in + sum_i (A_L / A_i) k_i v_i^T       (n_out alike)
// The TPU kernel takes the ratios A_t / A_i as exp of differences of log
// cumulative sums; those sums reach a few hundred at strong decay, and
// their rounding (1e-5 of the ratio) dominates the result's error. Here
// each ratio is the product of the decays between i and t, formed row by
// row (at most L - 1 factors, each in (0, 1]: no overflow, and a relative
// error near 1e-6). Any S: the last chunk is ragged, its missing rows zero.
// q, k and v may be strided views (the models slice them out of one
// projection); the last dimension must be contiguous. The final state is
// not computed here: the wrapper forms it outside the kernel when asked,
// as the TPU kernel's caller does. The caller names the variant
// (kernels/ssm_scan.py::kernel_variant); one that cannot serve the call is
// refused, never replaced.
//
// - mma (bf16; the models' prefill): the chunks run in parallel, in three
//   launches (the SSD form made parallel over chunks), on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate):
//   1. chunk states: one block per (b, h, chunk, 64 x 128 tile of the
//      state): S_c = sum_i (A_L / A_i) k_i v_i^T as (w K)^T V, with w K
//      split into bf16 hi + lo (two products, 2^-17 of a term), and n_c;
//      written to f32 scratch with each chunk's decay product A_L.
//   2. state passing: S_in[c + 1] = A_L[c] S_in[c] + S_c, sequential over
//      chunks, elementwise over the state, in place (bytes-bound).
//   3. chunk outputs: one block per (b, h, chunk, 64 value columns; 128
//      with a 16-wide key tile where Dk <= 16), one warp per 16 rows: q k^T on the tensor cores (key blocks above the
//      diagonal skipped), W = ratio (.) q k^T in f32 registers, q S_in and
//      q . n_in (n_in as one more column of the state tile) with S_in split
//      hi + lo, scaled by A_t, then W V with W split hi + lo, into the same
//      accumulators; y = that / max(|rowsum W + A_t q . n_in|, 1).
//   Products of bf16 q, k and v accumulate exactly in f32; W, the weighted
//   keys and S_in keep about 16 bits through their hi + lo halves.
// - simt (f32, all math f32; bf16 too, where named): one block of 256
//   threads owns (b, h, a slice of 32 value columns), keeps its Dk x 32
//   slice of S and its own copy of n in shared memory (64 KB at Dk = 512)
//   and walks the chunks of 64 in order. Per chunk: the decay ratios (one
//   thread a row); q k^T, q . S_in and q . n_in over the key dimension in
//   tiles of 32 rows; the masked, decay-weighted W; y and the denominator;
//   then the slice of S and n updated in place from the decay-weighted
//   keys. Every slice block recomputes the chunk's q k^T over all of Dk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---- bf16: chunk-parallel on the tensor cores ("mma") ----------------------

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;         // key-dimension (Dk) tile
constexpr int kStateBN = 128;   // value columns of a chunk-state tile
constexpr int kStateThreads = 128;

// 8 bf16 of row r, columns [c, c + 8) of a strided matrix (row r at base +
// r * rs), zero past nr rows and nc columns; 16-byte loads where `vec`
// says the base and rs allow them.
__device__ __forceinline__ uint4 load8(const bf16* base, long long rs, int r, int c, int nr,
                                       int nc, bool vec) {
  if (r >= nr || c >= nc) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* src = base + r * rs + c;
  if (vec && c + 8 <= nc) return __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = c + j < nc ? s16[j] : 0u;
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                    e[6] | (e[7] << 16));
}

// A bf16 tile of ROWS x (8 GROUPS) elements staged through registers, N
// 16-byte groups a thread (ROWS * GROUPS == N * THREADS): load() issues all
// of a thread's global loads at once, store() writes them to shared memory
// at a pitch of `pitch` elements. Rows >= nr and columns >= nc are zero.
template <int ROWS, int GROUPS, int THREADS>
struct Tile {
  static constexpr int N = ROWS * GROUPS / THREADS;
  static_assert(N * THREADS == ROWS * GROUPS, "tile split");
  uint4 v[N];
  __device__ __forceinline__ void load(const bf16* base, long long rs, int nr, int nc,
                                       bool vec) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      v[u] = load8(base, rs, i / GROUPS, (i % GROUPS) * 8, nr, nc, vec);
    }
  }
  __device__ __forceinline__ void store(bf16* dst, int pitch) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * THREADS;
      *reinterpret_cast<uint4*>(dst + (i / GROUPS) * pitch + (i % GROUPS) * 8) = v[u];
    }
  }
};

// ldmatrix row addresses (element offsets in a tile of pitch `pitch`) for a
// 16 x 16 block at (r0, c0): the A operand stored row-major (rows = M);
// the B operand stored [n][k] (two n-tiles of 8); the B operand stored
// [k][n] (.trans; two n-tiles of 8).
__device__ __forceinline__ int a_addr(int lane, int pitch, int r0, int c0) {
  return (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int bnk_addr(int lane, int pitch, int n0, int k0) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bkn_addr(int lane, int pitch, int k0, int n0) {
  return (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 + (lane >> 4) * 8;
}

template <int L>
struct StateTile {
  static constexpr int kKP = kBK + 8;        // pitch of the weighted keys
  static constexpr int kVP = kStateBN + 8;   // pitch of the values
  static constexpr size_t kSmem = sizeof(bf16) * (2 * L * kKP + L * kVP) + 2 * L * sizeof(float);
};

// Pass 1. grid (ceil(Dk / 64) * ceil(Dv / 128), nC, B * H), 128 threads:
// the state tile S_c[dk0 .. + 64, dv0 .. + 128] of chunk c, n_c (by the
// blocks at dv0 = 0) and A_L (by the block at the first tile).
template <int L>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ decay, float* __restrict__ states,
                   float* __restrict__ al, int S, int H, int Dk, int Dv, Strides ks, Strides vs,
                   int vec) {
  using T = StateTile<L>;
  constexpr int KP = T::kKP, VP = T::kVP;
  extern __shared__ __align__(16) uint8_t state_smem[];
  bf16* kh = reinterpret_cast<bf16*>(state_smem);  // [L][KP] bf16(w_i k_i)
  bf16* kl = kh + L * KP;                           // [L][KP] its residual
  bf16* vt = kl + L * KP;                           // [L][VP]
  float* w = reinterpret_cast<float*>(vt + L * VP);  // [L] A_L / A_i
  float* av = w + L;                                // [L] decays

  const int ndk = (Dk + kBK - 1) / kBK;
  const int dk0 = (blockIdx.x % ndk) * kBK, dv0 = (blockIdx.x / ndk) * kStateBN;
  const int c = blockIdx.y, nC = gridDim.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  {  // every global load of the block in flight at once
    Tile<L, kBK / 8, kStateThreads> kx;
    Tile<L, kStateBN / 8, kStateThreads> vx;
    kx.load(k + b * ks.b + t0 * ks.s + h * ks.h + dk0, ks.s, Lc, Dk - dk0, vec & 2);
    vx.load(v + b * vs.b + t0 * vs.s + h * vs.h + dv0, vs.s, Lc, Dv - dv0, vec & 4);
    if (tid < L) av[tid] = tid < Lc ? decay[(static_cast<int64_t>(b) * S + t0 + tid) * H + h] : 1.0f;
    kx.store(kh, KP);
    vx.store(vt, VP);
  }
  __syncthreads();
  for (int i = tid; i <= L; i += kStateThreads) {  // w_i = a_{i+1} ... a_{Lc-1}, from the top
    float r = 1.0f;
    const int lo = i == L ? 0 : i + 1;  // i == L: A_L = a_0 ... a_{Lc-1}
    for (int j = Lc - 1; j >= lo; --j) r *= av[j];
    if (i < L) w[i] = i < Lc ? r : 0.0f;
    else if (blockIdx.x == 0) al[static_cast<int64_t>(bh) * nC + c] = r;
  }
  __syncthreads();
  for (int i = tid; i < L * kBK / 2; i += kStateThreads) {  // kh, kl = w k, split
    const int r = i / (kBK / 2), cc = (i % (kBK / 2)) * 2;
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kh + r * KP + cc));
    uint32_t hi, lo;
    hopper::split_bf16x2(f.x * w[r], f.y * w[r], hi, lo);
    *reinterpret_cast<uint32_t*>(kh + r * KP + cc) = hi;
    *reinterpret_cast<uint32_t*>(kl + r * KP + cc) = lo;
  }
  __syncthreads();

  const int64_t E = static_cast<int64_t>(Dk) * Dv + Dk;
  float* sb = states + (static_cast<int64_t>(bh) * nC + c) * E;  // S_c (Dk x Dv), then n_c
  if (dv0 == 0 && tid < kBK && dk0 + tid < Dk) {
    float n = 0.0f;
    for (int i = 0; i < Lc; ++i)
      n += __bfloat162float(kh[i * KP + tid]) + __bfloat162float(kl[i * KP + tid]);
    sb[static_cast<int64_t>(Dk) * Dv + dk0 + tid] = n;
  }
  // eight warp tiles of 16 (dk) x 64 (dv), two per warp
  for (int wt = warp; wt < 8; wt += kStateThreads / 32) {
    const int m0 = (wt & 3) * 16, n0 = (wt >> 2) * 64;
    if (dk0 + m0 >= Dk || dv0 + n0 >= Dv) continue;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk * 16 >= Lc) break;
      uint32_t ah[4], alo[4];  // (w K)^T: the [i][dk] tiles read transposed
      const int ao = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + m0 + ((lane >> 3) & 1) * 8;
      hopper::ldsm_x4_trans(ah, kh + ao);
      hopper::ldsm_x4_trans(alo, kl + ao);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bf[4];
        hopper::ldsm_x4_trans(bf, vt + bkn_addr(lane, VP, kk * 16, n0 + 16 * j2));
        hopper::mma_16816(acc[2 * j2], ah, bf[0], bf[1]);
        hopper::mma_16816(acc[2 * j2], alo, bf[0], bf[1]);
        hopper::mma_16816(acc[2 * j2 + 1], ah, bf[2], bf[3]);
        hopper::mma_16816(acc[2 * j2 + 1], alo, bf[2], bf[3]);
      }
    }
    const bool pairs = (Dv % 2 == 0) && (E % 2 == 0);  // 8-byte aligned column pairs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int dk = dk0 + m0 + gid + 8 * hh, dv = dv0 + n0 + 8 * j + 2 * tig;
        if (dk >= Dk || dv >= Dv) continue;
        float* dst = sb + static_cast<int64_t>(dk) * Dv + dv;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
        } else {
          dst[0] = acc[j][2 * hh];
          if (dv + 1 < Dv) dst[1] = acc[j][2 * hh + 1];
        }
      }
  }
}

// Pass 2. grid (ceil(E / (256 V)), B * H), 256 threads: each chunk's
// state slot becomes the state entering it, S_in[c] (zero for c = 0), in
// place; V = 4 (16-byte vectors) where E % 4 == 0, else 1.
template <int V>
__global__ void __launch_bounds__(256)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ al, int nC, int E) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int e = (blockIdx.x * 256 + threadIdx.x) * V;
  if (e >= E) return;
  Vec* p = reinterpret_cast<Vec*>(states + static_cast<int64_t>(blockIdx.y) * nC * E + e);
  const int64_t step = E / V;  // one chunk's state, in vectors
  const float* a = al + static_cast<int64_t>(blockIdx.y) * nC;
  constexpr int U = 16;  // loads in flight ahead of the dependent chain
  float run[V];
#pragma unroll
  for (int j = 0; j < V; ++j) run[j] = 0.0f;
  for (int c0 = 0; c0 < nC; c0 += U) {
    Vec x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nC) x[u] = p[(c0 + u) * step];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nC) break;
      const float au = a[c0 + u];
      float* xs = reinterpret_cast<float*>(&x[u]);
      Vec out;
      float* os = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        os[j] = run[j];
        run[j] = fmaf(au, run[j], xs[j]);
      }
      p[(c0 + u) * step] = out;
    }
  }
}

template <int L, int BN, int BK>
struct OutTile {
  static constexpr int kQP = BK + 8;    // q and k tiles [L][kQP]
  static constexpr int kSP = BN + 24;   // S_in hi / lo [BK][kSP]: BN columns, n_in, zeros
  static constexpr int kVP = BN + 8;    // values [L][kVP]
  static constexpr int kRP = L + 4;     // decay ratios [L][kRP] (f32)
  static constexpr size_t kSmem = sizeof(float) * (L * kRP + 2 * L) +
                                  sizeof(bf16) * (2 * L * kQP + 2 * BK * kSP + L * kVP);
};

// Pass 3. grid (ceil(Dv / BN), nC, B * H), 2 L threads: y of chunk c at
// value columns dv0 .. + BN; warp w owns rows [16 w, 16 w + 16). The key
// dimension streams in tiles of BK (16 where Dk <= 16: hymba's SSD heads).
template <int L, int BN, int BK>
__global__ void __launch_bounds__(2 * L)
chunk_out_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ decay,
                 const float* __restrict__ states, bf16* __restrict__ y, int S, int H, int Dk,
                 int Dv, Strides qs, Strides ks, Strides vs, int vec) {
  using T = OutTile<L, BN, BK>;
  constexpr int QP = T::kQP, SP = T::kSP, VP = T::kVP, RP = T::kRP;
  constexpr int YT = BN / 8 + 2;  // accumulator n-tiles: BN columns, then q . n_in
  constexpr int NT = 2 * L;
  extern __shared__ __align__(16) uint8_t out_smem[];
  float* R = reinterpret_cast<float*>(out_smem);  // [L][RP] a_{i+1} ... a_t
  float* av = R + L * RP;                          // [L]
  float* At = av + L;                              // [L] a_0 ... a_t
  bf16* qt = reinterpret_cast<bf16*>(At + L);      // [L][QP]
  bf16* kt = qt + L * QP;                          // [L][QP]
  bf16* sh = kt + L * QP;                          // [BK][SP]
  bf16* sl = sh + BK * SP;                         // [BK][SP]
  bf16* vt = sl + BK * SP;                         // [L][VP]

  const int dv0 = blockIdx.x * BN, c = blockIdx.y, nC = gridDim.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L, Lc = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wr = warp * 16;
  const int nvt = min(BN, Dv - dv0);  // value columns of this tile
  const int64_t E = static_cast<int64_t>(Dk) * Dv + Dk;
  const float* st = states + (static_cast<int64_t>(bh) * nC + c) * E;  // S_in, then n_in
  const bf16* qb = q + b * qs.b + t0 * qs.s + h * qs.h;
  const bf16* kb = k + b * ks.b + t0 * ks.s + h * ks.h;

  {
    Tile<L, BN / 8, NT> vx;
    vx.load(v + b * vs.b + t0 * vs.s + h * vs.h + dv0, vs.s, Lc, nvt, vec & 4);
    if (tid < L) av[tid] = tid < Lc ? decay[(static_cast<int64_t>(b) * S + t0 + tid) * H + h] : 1.0f;
    vx.store(vt, VP);
  }
  __syncthreads();
  if (tid < L) {  // row t: R[t][i] = a_{i+1} ... a_t for i <= t, 0 above
    float* rr = R + tid * RP;
    for (int i = L - 1; i > tid; --i) rr[i] = 0.0f;
    float r = 1.0f;
    int i = tid;
    for (; i >= 7; i -= 8) {  // eight decays loaded ahead of the chain
      float a8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a8[u] = av[i - u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        rr[i - u] = r;
        r *= a8[u];
      }
    }
    for (; i >= 0; --i) {
      rr[i] = r;
      r *= av[i];
    }
    At[tid] = r;
  }

  float sacc[L / 8][4], yacc[YT][4];
#pragma unroll
  for (int j = 0; j < L / 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < YT; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.0f;
  // one key-dimension tile in flight: q, k and the state rows of the next
  // tile load while this one's products run
  Tile<L, BK / 8, NT> qx, kx;
  constexpr int SQ = (BN + 16) / 4;        // float4 quads of a state row
  constexpr int SN = (BK * SQ + NT - 1) / NT;  // a thread's quads (the last may idle)
  float4 sx[SN];
  const bool s_vec = Dv % 4 == 0 && Dk % 4 == 0;  // 16-byte aligned state rows
  auto load_stage = [&](int d0) {
    qx.load(qb + d0, qs.s, Lc, min(BK, Dk - d0), vec & 1);
    kx.load(kb + d0, ks.s, Lc, min(BK, Dk - d0), vec & 2);
#pragma unroll
    for (int u = 0; u < SN; ++u) {
      const int i = tid + u * NT, r = i / SQ, cc = (i % SQ) * 4, dk = d0 + r;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < BK * SQ && dk < Dk) {
        if (cc < BN) {
          const float* src = st + static_cast<int64_t>(dk) * Dv + dv0 + cc;
          if (s_vec && cc + 4 <= nvt) {
            x = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            if (cc < nvt) x.x = src[0];
            if (cc + 1 < nvt) x.y = src[1];
            if (cc + 2 < nvt) x.z = src[2];
            if (cc + 3 < nvt) x.w = src[3];
          }
        } else if (cc == BN) {
          x.x = st[static_cast<int64_t>(Dk) * Dv + dk];
        }
      }
      sx[u] = x;
    }
  };
  load_stage(0);
  for (int dk0 = 0; dk0 < Dk; dk0 += BK) {
    const int nk = min(BK, Dk - dk0);
    __syncthreads();  // the previous tiles are consumed (and R, At written)
    qx.store(qt, QP);
    kx.store(kt, QP);
#pragma unroll
    for (int u = 0; u < SN; ++u) {  // state rows split hi + lo
      const int i = tid + u * NT, r = i / SQ, cc = (i % SQ) * 4;
      if (i >= BK * SQ) break;
      uint32_t h0, l0, h1, l1;
      hopper::split_bf16x2(sx[u].x, sx[u].y, h0, l0);
      hopper::split_bf16x2(sx[u].z, sx[u].w, h1, l1);
      *reinterpret_cast<uint2*>(sh + r * SP + cc) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(sl + r * SP + cc) = make_uint2(l0, l1);
    }
    if (dk0 + BK < Dk) load_stage(dk0 + BK);
    __syncthreads();
    if (wr >= Lc) continue;  // rows past the chunk
    const int ksteps = (nk + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t a[4];
      hopper::ldsm_x4(a, qt + a_addr(lane, QP, wr, kk * 16));
#pragma unroll
      for (int p = 0; p < L / 16; ++p) {  // S += q k^T; keys past the warp's rows stay 0
        if (p * 16 > wr + 15) break;
        uint32_t kf[4];
        hopper::ldsm_x4(kf, kt + bnk_addr(lane, QP, p * 16, kk * 16));
        hopper::mma_16816(sacc[2 * p], a, kf[0], kf[1]);
        hopper::mma_16816(sacc[2 * p + 1], a, kf[2], kf[3]);
      }
#pragma unroll
      for (int p2 = 0; p2 < YT / 2; ++p2) {  // Y += q S_in (hi + lo); the last pair: n_in
        if (p2 < BN / 16 && p2 * 16 >= nvt) continue;
        uint32_t bh_[4], bl_[4];
        const int off = bkn_addr(lane, SP, kk * 16, p2 * 16);
        hopper::ldsm_x4_trans(bh_, sh + off);
        hopper::ldsm_x4_trans(bl_, sl + off);
        hopper::mma_16816(yacc[2 * p2], a, bh_[0], bh_[1]);
        hopper::mma_16816(yacc[2 * p2], a, bl_[0], bl_[1]);
        hopper::mma_16816(yacc[2 * p2 + 1], a, bh_[2], bh_[3]);
        hopper::mma_16816(yacc[2 * p2 + 1], a, bl_[2], bl_[3]);
      }
    }
  }
  if (wr >= Lc) return;

  const int ra = wr + gid, rb = ra + 8;
  // q . n_in: column 0 of n-tile YT - 2, held by the quad's first lane
  const float qn_a = __shfl_sync(0xffffffffu, yacc[YT - 2][0], lane & ~3);
  const float qn_b = __shfl_sync(0xffffffffu, yacc[YT - 2][2], lane & ~3);
  float ws_a = 0.0f, ws_b = 0.0f;  // W = ratio (.) q k^T and its row sums
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    const float2 fa = *reinterpret_cast<const float2*>(R + ra * RP + 8 * j + 2 * tig);
    const float2 fb = *reinterpret_cast<const float2*>(R + rb * RP + 8 * j + 2 * tig);
    sacc[j][0] *= fa.x;
    sacc[j][1] *= fa.y;
    sacc[j][2] *= fb.x;
    sacc[j][3] *= fb.y;
    ws_a += sacc[j][0] + sacc[j][1];
    ws_b += sacc[j][2] + sacc[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    ws_a += __shfl_xor_sync(0xffffffffu, ws_a, off);
    ws_b += __shfl_xor_sync(0xffffffffu, ws_b, off);
  }
  const float A_a = At[ra], A_b = At[rb];
  const float inv_a = 1.0f / fmaxf(fabsf(ws_a + A_a * qn_a), 1.0f);
  const float inv_b = 1.0f / fmaxf(fabsf(ws_b + A_b * qn_b), 1.0f);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    yacc[j][0] *= A_a;
    yacc[j][1] *= A_a;
    yacc[j][2] *= A_b;
    yacc[j][3] *= A_b;
  }
#pragma unroll
  for (int kb2 = 0; kb2 < L / 16; ++kb2) {  // Y += W V, W split hi + lo
    if (kb2 * 16 > wr + 15) break;
    uint32_t wh[4], wl[4];
    hopper::split_bf16x2(sacc[2 * kb2][0], sacc[2 * kb2][1], wh[0], wl[0]);
    hopper::split_bf16x2(sacc[2 * kb2][2], sacc[2 * kb2][3], wh[1], wl[1]);
    hopper::split_bf16x2(sacc[2 * kb2 + 1][0], sacc[2 * kb2 + 1][1], wh[2], wl[2]);
    hopper::split_bf16x2(sacc[2 * kb2 + 1][2], sacc[2 * kb2 + 1][3], wh[3], wl[3]);
#pragma unroll
    for (int p2 = 0; p2 < BN / 16; ++p2) {
      if (p2 * 16 >= nvt) break;
      uint32_t vf[4];
      hopper::ldsm_x4_trans(vf, vt + bkn_addr(lane, VP, kb2 * 16, p2 * 16));
      hopper::mma_16816(yacc[2 * p2], wh, vf[0], vf[1]);
      hopper::mma_16816(yacc[2 * p2], wl, vf[0], vf[1]);
      hopper::mma_16816(yacc[2 * p2 + 1], wh, vf[2], vf[3]);
      hopper::mma_16816(yacc[2 * p2 + 1], wl, vf[2], vf[3]);
    }
  }
  bf16* yb = y + (static_cast<int64_t>(b) * S + t0) * H * Dv + static_cast<int64_t>(h) * Dv + dv0;
  const int64_t row = static_cast<int64_t>(H) * Dv;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = hh ? rb : ra;
      if (t >= Lc) continue;
      const float inv = hh ? inv_b : inv_a;
      bf16* yr = yb + t * row + col;
      if (col < nvt) yr[0] = __float2bfloat16(yacc[j][2 * hh] * inv);
      if (col + 1 < nvt) yr[1] = __float2bfloat16(yacc[j][2 * hh + 1] * inv);
    }
  }
}

template <int L, int BN, int BK>
cudaError_t launch_chunked(const void* q, const void* k, const void* v, const float* decay,
                           void* y, float* states, float* al, int B, int S, int H, int Dk,
                           int Dv, Strides qs, Strides ks, Strides vs, int vec, cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(chunk_state_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(StateTile<L>::kSmem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(chunk_out_kernel<L, BN, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(OutTile<L, BN, BK>::kSmem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nC = (S + L - 1) / L;
  if (nC > 65535 || B * H > 65535) return cudaErrorInvalidValue;
  const int ndk = (Dk + kBK - 1) / kBK;
  chunk_state_kernel<L><<<dim3(ndk * ((Dv + kStateBN - 1) / kStateBN), nC, B * H),
                          kStateThreads, StateTile<L>::kSmem, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), decay, states, al, S, H, Dk, Dv,
      ks, vs, vec);
  const int E = Dk * Dv + Dk;
  if (E % 4 == 0)
    state_pass_kernel<4><<<dim3((E / 4 + 255) / 256, B * H), 256, 0, s>>>(states, al, nC, E);
  else
    state_pass_kernel<1><<<dim3((E + 255) / 256, B * H), 256, 0, s>>>(states, al, nC, E);
  chunk_out_kernel<L, BN, BK><<<dim3((Dv + BN - 1) / BN, nC, B * H), 2 * L,
                                OutTile<L, BN, BK>::kSmem, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                 static_cast<const bf16*>(v), decay, states,
                                 static_cast<bf16*>(y), S, H, Dk, Dv, qs, ks, vs, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, S, H, Dk) and v (B, S, H, Dv) in one dtype (0: float32, 1:
// bfloat16), each with element strides (batch, token, head) and a
// contiguous last dimension; decay (B, S, H) float32 and y (B, S, H, Dv)
// in q's dtype, contiguous; all 4-byte aligned on the device of `stream`.
// variant 0 simt (1 <= Dk <= 1024; states, al and chunk unused), 1 mma
// (bf16; chunk 64 or 128; states: B H nC (Dk Dv + Dk) and al: B H nC
// float32 scratch, nC = ceil(S / chunk); vec bit 1, 2, 4: q, k, v allow
// 16-byte loads). Returns cudaErrorInvalidValue for a variant that cannot
// serve the call, else cudaGetLastError().
extern "C" int linear_scan(const void* q, const void* k, const void* v, const void* decay,
                           void* y, void* states, void* al, int dtype, int variant, int chunk,
                           int B, int S, int H, int Dk, int Dv, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float* a = static_cast<const float*>(decay);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    float* st = static_cast<float*>(states);
    float* al_ = static_cast<float*>(al);
    if (chunk == 64 && Dk <= 16)  // small state (hymba): one block per chunk
      return static_cast<int>(launch_chunked<64, 128, 16>(q, k, v, a, y, st, al_, B, S, H, Dk,
                                                          Dv, qs, ks, vs, vec, s));
    if (chunk == 64)
      return static_cast<int>(launch_chunked<64, 64, 64>(q, k, v, a, y, st, al_, B, S, H, Dk,
                                                         Dv, qs, ks, vs, vec, s));
    if (chunk == 128)
      return static_cast<int>(launch_chunked<128, 64, 64>(q, k, v, a, y, st, al_, B, S, H, Dk,
                                                          Dv, qs, ks, vs, vec, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0 || Dk > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, a, y, B, S, H, Dk, Dv, qs, ks, vs, s));
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, a, y, B, S, H, Dk, Dv, qs, ks, vs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
