// Grouped expert matmul (MoE), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::_gmm_kernel (moe_gmm
// :44). With xg (E, C, din) bucketed tokens and wg (E, din, dout) expert
// weights:
//   out[e, c, f] = sum_d xg[e, c, d] * wg[e, d, f]
// accumulated in f32, the output in the inputs' dtype.
//
// Bound on this card: at dbrx-132b's prefill (E = 16, C = 2560, din = 6144,
// dout = 10752) a call is 5.41 TFLOP, 5.5 ms at the 989 TFLOP/s of the bf16
// tensor cores (operations); at its decode (C = 5) the 2.1 GB of expert
// weights bound it, 0.63 ms at 3.35 TB/s (bytes).
//
// Three variants; the caller names one (kernels/moe_gmm.py::kernel_variant)
// and a variant that cannot serve the shape is refused, never replaced:
// - wgmma (bf16, din and dout multiples of 8; every model's prefill and
//   decode, where a 128-row tile of 5 real rows still moves the weights
//   at mma's pace or better): one
//   block of three warpgroups per (128 rows of C, 256 columns of dout,
//   expert). A producer warp keeps a 4-stage ring of (A 128 x 64, B 64 x
//   256) tiles in flight with TMA, each stage guarded by a full and an
//   empty mbarrier; two consumer warpgroups each own 64 rows and issue
//   wgmma.m64n256k16 (f32 accumulators in registers, 128 a thread), with
//   setmaxnreg moving registers from the producer to them. xg is a 3-D
//   tensor map (din, C, E), so a row tile past C reads zeros and never the
//   next expert's rows; wg is (dout, din, E) with dout contiguous, read as
//   an MN-major B operand (the transposed form of wgmma) in four 64-wide
//   boxes, so the weights keep the reference's layout. Rows and columns
//   past the edge are zero-filled by TMA and not stored. The row tiles of
//   C run fastest in the grid, so the blocks in flight share each expert's
//   weight panel through L2.
// - mma (bf16, any shape; chosen where din or dout is not a multiple of 8,
//   which TMA cannot describe): mma.sync.m16n8k16, one
//   block of 4 warps per (64 rows of C, 128 columns of dout, expert); din
//   in tiles of 32 through a 3-deep cp.async ring (16-byte copies,
//   zero-filled past the edge; element loads where din or dout is not a
//   multiple of 8). Each warp owns a 32 x 64 piece; B fragments come
//   through ldmatrix.trans; rows padded by 8 elements against bank
//   conflicts.
// - simt (f32, full f32, no TF32): one block of 256 threads per (64 x 64
//   output tile, expert), each thread 4 x 4 outputs, din in tiles of 16
//   through shared memory.
//
// Grouped forms (moe_gmm_grouped; wgmma and simt), for dropless routing,
// where expert e's rows are one segment [off[e], off[e + 1]) of a (R, .)
// buffer, each segment a multiple of 128 rows:
// - rows: out (R, dout) = x (R, din) times the weights of each row tile's
//   expert (a table of R / 128 expert ids): the forward and the input
//   gradient, R / 128 row tiles and no padding to the largest expert.
// - contraction: out[e] (M, N) = a[:, off[e]:off[e + 1]] b[off[e]:off[e + 1]]
//   with a (M, R) and b (R, N): the weight gradient xg^T dout, each expert
//   contracting over its own segment (zeros where it is empty).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum Variant { kSimt = 0, kMma = 1, kWgmma = 2 };
enum Mode { kUniform = 0, kRows = 1, kContraction = 2 };
constexpr int kGroupRows = 128;  // segments of the grouped forms

// The grouped forms' tables (both null: the uniform (E, C, din) form).
struct Groups {
  const int* tile_expert;  // rows: the expert of each 128-row tile
  const int* offsets;      // contraction: E + 1 row offsets
};

// ---- bf16: tensor cores (mma.sync) ----------------------------------------

constexpr int kBM = 64;    // rows of C per block
constexpr int kBN = 128;   // columns of dout per block
constexpr int kBK = 32;    // din per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLdA = kBK + 8;   // 80-byte rows
constexpr int kLdB = kBN + 8;   // 272-byte rows
constexpr int kStageElems = kBM * kLdA + kBK * kLdB;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices, transposed: with lane l addressing row
// (l % 16) and column (l / 16) * 8 of a row-major (k, n) tile, r0/r1 are
// the B fragment (b0, b1) of n-tile 0 and r2/r3 that of n-tile 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage din tile [k0, k0 + 32) of the block's A rows and B columns.
__device__ __forceinline__ void load_stage(__nv_bfloat16* as, __nv_bfloat16* bs,
                                           const __nv_bfloat16* xe, const __nv_bfloat16* we,
                                           int m0, int n0, int k0, int C, int din, int dout,
                                           bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if (vec) {
    // A: 64 rows x 4 chunks of 8; B: 32 rows x 16 chunks of 8.
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < C && k0 + c < din;
      const __nv_bfloat16* src = ok ? xe + static_cast<int64_t>(m0 + r) * din + k0 + c : xe;
      cp_async16(as + r * kLdA + c, src, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < din && n0 + c < dout;
      const __nv_bfloat16* src = ok ? we + static_cast<int64_t>(k0 + r) * dout + n0 + c : we;
      cp_async16(bs + r * kLdB + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      as[r * kLdA + c] = (m0 + r < C && k0 + c < din)
                             ? xe[static_cast<int64_t>(m0 + r) * din + k0 + c]
                             : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      bs[r * kLdB + c] = (k0 + r < din && n0 + c < dout)
                             ? we[static_cast<int64_t>(k0 + r) * dout + n0 + c]
                             : zero;
    }
  }
}

// grid (ceil(C / 64), ceil(dout / 128), E)
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int C, int din, int dout, int vec) {
  __shared__ __align__(16) __nv_bfloat16 smem[kStages * kStageElems];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const __nv_bfloat16* xe = x + static_cast<int64_t>(e) * C * din;
  const __nv_bfloat16* we = w + static_cast<int64_t>(e) * din * dout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;  // the warp's 32 x 64 piece
  const int nk = (din + kBK - 1) / kBK;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      __nv_bfloat16* st = smem + s * kStageElems;
      load_stage(st, st + kBM * kLdA, xe, we, m0, n0, s * kBK, C, din, dout, vec);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; tile kt - 1 is consumed by all warps
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      __nv_bfloat16* st = smem + (nxt % kStages) * kStageElems;
      load_stage(st, st + kBM * kLdA, xe, we, m0, n0, nxt * kBK, C, din, dout, vec);
    }
    cp_async_commit();

    const __nv_bfloat16* as = smem + (kt % kStages) * kStageElems;
    const __nv_bfloat16* bs = as + kBM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* ar = as + (wm + i * 16 + gid) * kLdA + kk + tig * 2;
        a[i][0] = ld32(ar);
        a[i][1] = ld32(ar + 8 * kLdA);
        a[i][2] = ld32(ar + 8);
        a[i][3] = ld32(ar + 8 * kLdA + 8);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // n-tiles 2 jp and 2 jp + 1
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          bs + (kk + (lane & 15)) * kLdB + wn + jp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
          mma_bf16(acc[i][2 * jp + 1], a[i][0], a[i][1], a[i][2], a[i][3], b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* oe = out + static_cast<int64_t>(e) * C * dout;
  const bool pair = (dout % 2) == 0;  // 4-byte stores stay aligned
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + gid + h * 8;
        if (row >= C) continue;
        __nv_bfloat16* o = oe + static_cast<int64_t>(row) * dout + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pair && col + 1 < dout) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < dout) o[0] = __float2bfloat16(v0);
          if (col + 1 < dout) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int kWM = 128;   // rows of C per block (64 per consumer warpgroup)
constexpr int kWN = 256;   // columns of dout per block
constexpr int kWK = 64;    // din per stage: one 128-byte swizzled row
constexpr int kWStages = 4;
constexpr int kWThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kWABytes = kWM * kWK * 2;  // 16 KB
constexpr int kWBBox = kWK * 64 * 2;     // one 64 x 64 box of B, 8 KB
constexpr int kWStageBytes = kWABytes + 4 * kWBBox;  // 48 KB
constexpr size_t kWSmem = 1024 + kWStages * kWStageBytes + 2 * kWStages * sizeof(uint64_t);

// grid (ceil(C / 128), ceil(dout / 256), E), or for the grouped rows
// (R / 128, ceil(dout / 256), 1). The maps' third coordinates: x's block
// ex (0 where grouped), w's block ew (a row tile's expert where grouped by
// rows, 0 where grouped by contraction); din runs over [kbeg, kend).
__global__ void __launch_bounds__(kWThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                 int C, int din, int dout, Groups g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStageBytes);
  uint64_t* empty = full + kWStages;
  const int m0 = blockIdx.x * kWM, n0 = blockIdx.y * kWN, e = blockIdx.z;
  const bool grouped = g.tile_expert != nullptr || g.offsets != nullptr;
  const int ex = grouped ? 0 : e;
  const int ew = g.tile_expert ? __ldg(g.tile_expert + blockIdx.x) : (grouped ? 0 : e);
  const int eo = g.tile_expert ? 0 : e;
  const int kbeg = g.offsets ? __ldg(g.offsets + e) : 0;
  const int kend = g.offsets ? __ldg(g.offsets + e + 1) : din;
  const int nk = (kend - kbeg + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&wmap);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWStages;
        if (kt >= kWStages) hopper::mbar_wait(&empty[s], ((kt / kWStages) - 1) & 1);
        uint8_t* a = smem + s * kWStageBytes;
        hopper::mbar_expect_tx(&full[s], kWStageBytes);
        hopper::tma_load_3d(a, &xmap, &full[s], kbeg + kt * kWK, m0, ex);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hopper::tma_load_3d(a + kWABytes + j * kWBBox, &wmap, &full[s], n0 + 64 * j,
                              kbeg + kt * kWK, ew);
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. + 63 of the tile
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kWStages;
      hopper::mbar_wait(&full[s], (kt / kWStages) & 1);
      const uint8_t* a = smem + s * kWStageBytes + c * 64 * 128;
      const uint8_t* b = smem + s * kWStageBytes + kWABytes;
      hopper::pin(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        hopper::wgmma_m64n256k16_ss_tb(acc, hopper::smem_desc(a + kk * 32, 16, 1024),
                                       hopper::smem_desc(b + kk * 16 * 128, kWBBox, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      hopper::pin(acc);
      if (kt > 0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % kWStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::pin(acc);

    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = m0 + c * 64 + w * 16 + lane / 4;
    __nv_bfloat16* oe = out + static_cast<int64_t>(eo) * C * dout;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= dout) continue;  // dout is even: col + 1 < dout too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < C)
          *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<int64_t>(row) * dout + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// x read as (xe, C, din) blocks and w as (we, din, dout), gz blocks of the
// grid along z.
cudaError_t launch_wgmma(const void* xg, const void* wg, void* out, int xe, int we, int gz, int C,
                         int din, int dout, Groups g, cudaStream_t s) {
  static bool configured = false;  // shared memory above 48 KB is opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kWSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(din), static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(xe)};
  const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(din) * 2,
                                  static_cast<cuuint64_t>(C) * din * 2};
  const cuuint32_t xbox[3] = {kWK, kWM, 1};
  cudaError_t err = hopper::bf16_map(&xmap, xg, 3, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(dout), static_cast<cuuint64_t>(din),
                               static_cast<cuuint64_t>(we)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(dout) * 2,
                                  static_cast<cuuint64_t>(din) * dout * 2};
  const cuuint32_t wbox[3] = {64, kWK, 1};
  err = hopper::bf16_map(&wmap, wg, 3, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kWM - 1) / kWM, (dout + kWN - 1) / kWN, gz);
  gmm_wgmma_kernel<<<grid, kWThreads, kWSmem, s>>>(xmap, wmap, static_cast<__nv_bfloat16*>(out),
                                                   C, din, dout, g);
  return cudaGetLastError();
}

// ---- f32: SIMT, full float32 ----------------------------------------------

constexpr int kFT = 64;    // output tile edge
constexpr int kFK = 16;    // din per tile
constexpr int kFThreads = 256;

// grid (ceil(C / 64), ceil(dout / 64), E); the grouped forms as the wgmma
// kernel's, a row tile's expert read per 128 rows.
__global__ void __launch_bounds__(kFThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int din, int dout, Groups g) {
  __shared__ float as[kFK][kFT + 4];  // transposed: as[k][m]
  __shared__ float bs[kFK][kFT + 4];
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT, e = blockIdx.z;
  const bool grouped = g.tile_expert != nullptr || g.offsets != nullptr;
  const int ew = g.tile_expert ? __ldg(g.tile_expert + m0 / kGroupRows) : (grouped ? 0 : e);
  const float* xe = x + static_cast<int64_t>(grouped ? 0 : e) * C * din;
  const float* we = w + static_cast<int64_t>(ew) * din * dout;
  const int kbeg = g.offsets ? __ldg(g.offsets + e) : 0;
  const int kend = g.offsets ? __ldg(g.offsets + e + 1) : din;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += kFK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFT * kFK; i += kFThreads) {
      const int m = i / kFK, k = i % kFK;
      as[k][m] = (m0 + m < C && k0 + k < kend)
                     ? xe[static_cast<int64_t>(m0 + m) * din + k0 + k]
                     : 0.0f;
      const int kb = i / kFT, n = i % kFT;
      bs[kb][n] = (k0 + kb < kend && n0 + n < dout)
                      ? we[static_cast<int64_t>(k0 + kb) * dout + n0 + n]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[k][ty + 16 * i];
        b[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* oe = out + static_cast<int64_t>(g.tile_expert ? 0 : e) * C * dout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < dout) oe[static_cast<int64_t>(row) * dout + col] = acc[i][j];
    }
  }
}

}  // namespace

// xg (E, C, din), wg (E, din, dout), out (E, C, dout), one dtype (0:
// float32, 1: bfloat16), row-major, contiguous, 16-byte aligned, on the
// device of `stream`; variant 0 simt (f32), 1 mma (bf16), 2 wgmma (bf16, din
// and dout multiples of 8). Returns cudaErrorInvalidValue for a variant
// that cannot serve the call, else cudaGetLastError().
extern "C" int moe_gmm(const void* xg, const void* wg, void* out, int dtype, int variant, int E,
                       int C, int din, int dout, void* stream) {
  if (E <= 0 || C <= 0 || dout <= 0) return 0;
  if (din < 0 || E > 65535 || (C + kBM - 1) / kBM > 65535 || (dout + kFT - 1) / kFT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != 1 || din == 0 || din % 8 != 0 || dout % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma(xg, wg, out, E, E, E, C, din, dout, Groups{}, s));
  }
  if (variant == kMma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = (din % 8 == 0) && (dout % 8 == 0);
    const dim3 grid((C + kBM - 1) / kBM, (dout + kBN - 1) / kBN, E);
    gmm_mma_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(xg),
                                             static_cast<const __nv_bfloat16*>(wg),
                                             static_cast<__nv_bfloat16*>(out), C, din, dout,
                                             vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != kSimt || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kFT - 1) / kFT, (dout + kFT - 1) / kFT, E);
  gmm_f32_kernel<<<grid, kFThreads, 0, s>>>(static_cast<const float*>(xg),
                                            static_cast<const float*>(wg),
                                            static_cast<float*>(out), C, din, dout, Groups{});
  return static_cast<int>(cudaGetLastError());
}

// The grouped forms (see the top of the file); a, b, out one dtype (0:
// float32, 1: bfloat16), contiguous, 16-byte aligned; variant 0 simt
// (f32) or 2 wgmma (bf16, K and N multiples of 8); table on the device,
// int32. mode 1 (rows): a (M, K) with M = R a multiple of 128, b (E, K,
// N), table the M / 128 row tiles' experts, out (M, N). mode 2
// (contraction): a (M, K), b (K, N) with K = R a multiple of 128, table
// the E + 1 offsets (multiples of 128), out (E, M, N). Returns
// cudaErrorInvalidValue for a call the form cannot take.
extern "C" int moe_gmm_grouped(const void* a, const void* b, void* out, int dtype, int variant,
                               int mode, int E, int M, int K, int N, const int* table,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0) return 0;
  const bool rows = mode == kRows;
  if ((!rows && mode != kContraction) || (rows ? M : K) % kGroupRows != 0 || E > 65535 ||
      (M + kFT - 1) / kFT > 65535 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Groups g = rows ? Groups{table, nullptr} : Groups{nullptr, table};
  const int gz = rows ? 1 : E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != 1 || K % 8 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma(a, b, out, 1, rows ? E : 1, gz, M, K, N, g, s));
  }
  if (variant != kSimt || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kFT - 1) / kFT, (N + kFT - 1) / kFT, gz);
  gmm_f32_kernel<<<grid, kFThreads, 0, s>>>(static_cast<const float*>(a),
                                            static_cast<const float*>(b),
                                            static_cast<float*>(out), M, K, N, g);
  return static_cast<int>(cudaGetLastError());
}
