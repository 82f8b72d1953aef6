// The bf16 matrix products of the training backwards, f32 sums, and column
// sums: the weight grads over every token row (dW = A^T B, gemm<false, true>:
// K7's dW1 = dh^T x and dW2 = dy^T a, K9's, K3's dWqkv = dqkv^T x and dWproj =
// g^T acc, K12's), K3's dx = dqkv @ Wqkv and K12's dx = dqkv @ Wqkv + dx1 with
// its f32 addend (gemm<true, true>), and the out-projection of the forward K2
// with its bias (gemm<true, false>, B stored (n, k)). outer_dense.cu runs the
// same device code (wg_gemm_body) in its TAIL mode for the model's Dense
// products at any width, with an f32 bias, under entry points of its own.
//
//   out(m, n) = sum_k A(m, k) B(k, n)  [+ bias(n)]  [+ addend(m, n)]
//   A(m, k) = A[m * lda + k] (A_ROW) or A[k * lda + m] (A stored transposed)
//   B(k, n) = B[k * ldb + n] (B_ROW) or B[n * ldb + k] (B stored transposed)
//
// gemm<> runs on wgmma (wg_gemm_kernel): a persistent CTA of three consumer
// warpgroups and one producer warp computes 192 x 192 output
// tiles, each warpgroup 64 rows with its f32 sums in registers (96 a thread);
// the producer keeps a ring of four 64-deep stages (48 KB each: three 64 x 64
// boxes of A and three of B, 128-byte swizzle) filled by TMA, each stage
// released by the consumers through an mbarrier. A weight grad (K the token
// rows: 535,680 at the outer stage, M x N at most 1536 x 384) is split over
// the rows so that the grid is one wave of the card's SMs; the CTAs sharing a
// slice of rows are adjacent in the grid, run together and share the slice
// through the L2; each writes f32 partials that reduce_partials sums in a
// fixed order: no atomics, the same bits on every run. Rows past the end are
// read as zeros (TMA) and not stored.
//
// What bounds them on an H100: a weight grad moves its two (rows, n) bf16
// operands once (0.82 GB and 0.21 GB for K7's dW2 at the outer stage) for
// ~2 rows M N FLOP, ~150 FLOP per byte, under the card's ~295 FLOP/B ridge:
// bytes. The design reads each operand once from device memory and keeps the
// tensor cores fed from TMA stages, so it is held by the L2 and memory feed.
// K2's projection moves 2 rows C bf16 bytes for 2 rows C^2 FLOP: bytes.

#pragma once

#include "hopper.cuh"

namespace {

// The token-row multiple of the attention kernels' grids (K2, K3, K11, K12 and
// the A/B kernels): one wgmma row block.
constexpr int ROW_TILE = 64;

// ---- the wgmma products ------------------------------------------------------------
constexpr int WG_CONSUMERS = 3;                       // warpgroups, 64 output rows each
constexpr int WG_BM = 64 * WG_CONSUMERS;              // 192 output rows per tile
constexpr int WG_BN = 192;                            // output columns per tile
constexpr int WG_BK = 64;                             // depth per stage
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;   // + the producer warp
constexpr int WG_BOX = 64 * 64 * 2;                   // one 64 x 64 bf16 box
constexpr int WG_STAGE_BYTES = (WG_BM / 64 + WG_BN / 64) * WG_BOX;  // 48 KB
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;

struct WgMaps {
  CUtensorMap a, b;
};

// Two adjacent bias values as f32.
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ROWSPLIT: part[split] (M x N f32) = A^T B over the split's rows [split *
// kchunk, +kchunk) of A (K, M) and B (K, N), both MN-major; units = tiles x
// splits, split-major. Otherwise out (M x N bf16) = A B (+ bias) with A (M, K)
// K-major and B (K, N) MN-major, or with BT stored (N, K) (nn.Linear's
// weight, K-major), plus the f32 addend (M x N, row stride N) where it is
// given, rows >= M not stored; units = tiles. A unit is one 192 x
// 192 output tile (with its row slice); CTA i takes units i, i + grid, ... The
// maps read 64 x 64 boxes, 128-byte swizzle. TAIL takes any M, N and K: the
// maps read zeros past every end, so a tile's sums past M or N are zero and
// are not stored, and depth past K adds nothing; without it N is a multiple of
// 192 and (not ROWSPLIT) K of 64. BiasT is the bias's type (bf16 or f32).
template <bool ROWSPLIT, bool BT, bool TAIL, typename BiasT>
__device__ __forceinline__ void wg_gemm_body(const WgMaps& maps, int M, int N, long long K,
                                             long long kchunk, int units,
                                             const BiasT* __restrict__ bias,
                                             const float* __restrict__ addend,
                                             float* __restrict__ part, bf16* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = TAIL ? (N + WG_BN - 1) / WG_BN : N / WG_BN;
  const int tiles = (M + WG_BM - 1) / WG_BM * tiles_n;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled boxes need 1024-byte alignment
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG_CONSUMERS);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto unit = [&](int u, int& m0, int& n0, long long& kbeg, long long& kend) {
    const int t = ROWSPLIT ? u % tiles : u;
    m0 = t / tiles_n * WG_BM;
    n0 = t % tiles_n * WG_BN;
    kbeg = ROWSPLIT ? (long long)(u / tiles) * kchunk : 0;
    kend = ROWSPLIT && kbeg + kchunk < K ? kbeg + kchunk : K;
  };

  if (warp == 4 * WG_CONSUMERS) {  // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0;
        long long kbeg, kend;
        unit(u, m0, n0, kbeg, kend);
        for (long long k0 = kbeg; k0 < kend; k0 += WG_BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * WG_STAGE_BYTES;
          mbar_expect_tx(&full[stage], WG_STAGE_BYTES);
          for (int b = 0; b < WG_BM / 64; ++b) {
            if (ROWSPLIT)
              tma_load(st + b * WG_BOX, &maps.a, &full[stage], m0 + 64 * b, (int)k0);
            else
              tma_load(st + b * WG_BOX, &maps.a, &full[stage], (int)k0, m0 + 64 * b);
          }
          for (int b = 0; b < WG_BN / 64; ++b) {
            if (BT)
              tma_load(st + (WG_BM / 64 + b) * WG_BOX, &maps.b, &full[stage], (int)k0,
                       n0 + 64 * b);
            else
              tma_load(st + (WG_BM / 64 + b) * WG_BOX, &maps.b, &full[stage], n0 + 64 * b,
                       (int)k0);
          }
          if (++stage == WG_STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. of each tile
  const int wg = warp >> 2;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0;
    long long kbeg, kend;
    unit(u, m0, n0, kbeg, kend);
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    int prev = -1;
    for (long long k0 = kbeg; k0 < kend; k0 += WG_BK) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = smem + stage * WG_STAGE_BYTES + wg * WG_BOX;
      const unsigned char* b = smem + stage * WG_STAGE_BYTES + (WG_BM / 64) * WG_BOX;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // A: MN-major rows kk*16.. of the box, or K-major columns kk*16..
        const uint64_t da = ROWSPLIT ? gmma_desc(a + kk * 2048, WG_BOX, 1024, SW128)
                                     : gmma_desc(a + kk * 32, 16, 1024, SW128);
        // B: MN-major rows kk*16.., or (BT) K-major columns kk*16.. of 192 rows
        const uint64_t db = BT ? gmma_desc(b + kk * 32, 16, 1024, SW128)
                               : gmma_desc(b + kk * 2048, WG_BOX, 1024, SW128);
        wgmma_m64n192<ROWSPLIT ? 1 : 0, BT ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == WG_STAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    const int r0 = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int c0 = n0 + 2 * (lane & 3);
    if (ROWSPLIT) {
      float* p = part + (long long)(u / tiles) * M * N;
#pragma unroll
      for (int g = 0; g < 24; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (TAIL && (r0 + 8 * h >= M || c0 + 8 * g >= N)) continue;
          *reinterpret_cast<float2*>(p + (long long)(r0 + 8 * h) * N + c0 + 8 * g) =
              make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
        }
    } else {
      if (bias) {
#pragma unroll
        for (int g = 0; g < 24; ++g) {
          if (TAIL && c0 + 8 * g >= N) continue;
          const float2 bb = load_pair(bias + c0 + 8 * g);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[4 * g + 2 * h] += bb.x;
            acc[4 * g + 2 * h + 1] += bb.y;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + 8 * h >= M) continue;
        bf16* o = out + (long long)(r0 + 8 * h) * N + c0;
        if (addend) {
          const float* ad = addend + (long long)(r0 + 8 * h) * N + c0;
#pragma unroll
          for (int g = 0; g < 24; ++g) {
            if (TAIL && c0 + 8 * g >= N) continue;
            const float2 t = *reinterpret_cast<const float2*>(ad + 8 * g);
            acc[4 * g + 2 * h] += t.x;
            acc[4 * g + 2 * h + 1] += t.y;
          }
        }
#pragma unroll
        for (int g = 0; g < 24; ++g) {
          if (TAIL && c0 + 8 * g >= N) continue;
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * g) =
              __floats2bfloat162_rn(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
        }
      }
    }
  }
}

template <bool ROWSPLIT, bool BT = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_gemm_kernel(const __grid_constant__ WgMaps maps, int M, int N, long long K, long long kchunk,
               int units, const bf16* __restrict__ bias, const float* __restrict__ addend,
               float* __restrict__ part, bf16* __restrict__ out) {
  wg_gemm_body<ROWSPLIT, BT, false>(maps, M, N, K, kchunk, units, bias, addend, part, out);
}

// Row slices of a weight-grad product: one wave of the card's SMs, each CTA
// one 192 x 192 tile of one slice.
inline int weight_grad_splits(int M, int N, long long K) {
  const int tiles = (M + WG_BM - 1) / WG_BM * ((N + WG_BN - 1) / WG_BN), sms = sm_count();
  long long s = tiles > 0 && sms / tiles > 1 ? sms / tiles : 1;
  const long long kt = (K + WG_BK - 1) / WG_BK;
  if (s > kt) s = kt;
  return (int)s;
}

// The launch of one product (see gemm) through `kernel`, an entry point that
// runs wg_gemm_body<!A_ROW, !B_ROW, TAIL, BiasT>: the maps, the row slices
// and the grid. A weight grad leaves its f32 partials in `part` and their
// count in *parts, for the caller to sum.
template <bool A_ROW, bool B_ROW, bool TAIL, typename BiasT, typename Kernel>
cudaError_t wg_gemm_launch(Kernel kernel, const bf16* A, long long lda, const bf16* B,
                           long long ldb, int M, int N, long long K, int splits,
                           const BiasT* bias, bf16* out_bf16, float* part, cudaStream_t stream,
                           const float* addend, int* parts) {
  static_assert(A_ROW || B_ROW, "a weight-grad product takes B stored (K, N)");
  if (splits < 1) return cudaErrorInvalidValue;
  constexpr bool ROWSPLIT = !A_ROW, BT = !B_ROW;
  const bool shape_ok =
      TAIL ? (M > 0 && N > 0 && K > 0 && N % 2 == 0 && (ROWSPLIT || splits == 1))
           : (ROWSPLIT ? M % WG_BM == 0 : (K % WG_BK == 0 && splits == 1)) && N % WG_BN == 0;
  if ((bias && B_ROW) || (addend && ROWSPLIT) || !shape_ok) return cudaErrorInvalidValue;
  WgMaps maps;
  const bool ok = (ROWSPLIT ? tensor_map(&maps.a, A, M, K, lda, 64, 64,
                                         CU_TENSOR_MAP_SWIZZLE_128B)
                            : tensor_map(&maps.a, A, K, M, lda, 64, 64,
                                         CU_TENSOR_MAP_SWIZZLE_128B)) &&
                  (BT ? tensor_map(&maps.b, B, K, N, ldb, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B)
                      : tensor_map(&maps.b, B, N, K, ldb, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return cudaErrorInvalidValue;
  long long kchunk = K;
  *parts = 1;
  if (ROWSPLIT) {
    kchunk = ((K + WG_BK - 1) / WG_BK + splits - 1) / splits * WG_BK;
    *parts = (int)((K + kchunk - 1) / kchunk);
  }
  const int units = (M + WG_BM - 1) / WG_BM * ((N + WG_BN - 1) / WG_BN) * *parts;
  const int sms = sm_count();
  const int grid = sms > 0 && sms < units ? sms : units;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(maps, M, N, K, kchunk, units, bias, addend, part,
                                                out_bf16);
  return cudaGetLastError();
}

// One product on wgmma, M x N, depth K, bf16 out_bf16.
//  * gemm<false, true>: out = bf16(A^T B) over the K token rows, split over
//    at most `splits` row slices with f32 partials in `part` (splits x M x N),
//    summed in order; M and N multiples of 192, K any.
//  * gemm<true, true>: out = bf16(A B + addend) (the f32 addend, M x N, may
//    be null); M any, N a multiple of 192, K of 64; splits 1, no bias.
//  * gemm<true, false>: out = bf16(A B + bias) with B stored (N, K)
//    (nn.Linear's weight: x W^T + b, K2's out-projection); the bias (N bf16)
//    may be null; M any, N a multiple of 192, K of 64; splits 1.
// lda, ldb multiples of 8 and 16-byte aligned bases (checked by the caller).
template <bool A_ROW, bool B_ROW>
cudaError_t gemm(const bf16* A, long long lda, const bf16* B, long long ldb, int M, int N,
                 long long K, int splits, const bf16* bias, bf16* out_bf16, float* part,
                 cudaStream_t stream, const float* addend = nullptr) {
  int parts = 1;
  cudaError_t err = wg_gemm_launch<A_ROW, B_ROW, false>(wg_gemm_kernel<!A_ROW, !B_ROW>, A, lda,
                                                        B, ldb, M, N, K, splits, bias, out_bf16,
                                                        part, stream, addend, &parts);
  if (err != cudaSuccess || A_ROW) return err;
  return reduce_partials(part, parts, (long long)M * N, out_bf16, nullptr, stream);
}

// part[b * C + c] = sum of column c of x over rows [b * rpb, (b + 1) * rpb).
__global__ void colsum_kernel(const bf16* __restrict__ x, long long rows, int C, long long rpb,
                              float* __restrict__ part) {
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (long long r = r0; r < r1; ++r) s += __bfloat162float(x[r * C + c]);
    part[(long long)blockIdx.x * C + c] = s;
  }
}

constexpr int COLSUM_BLOCKS = 528;

// bf16 column sums of a (rows, C) bf16 matrix; part holds COLSUM_BLOCKS x C floats.
cudaError_t colsum(const bf16* x, long long rows, int C, float* part, bf16* out,
                   cudaStream_t stream) {
  const long long rpb = (rows + COLSUM_BLOCKS - 1) / COLSUM_BLOCKS;
  colsum_kernel<<<COLSUM_BLOCKS, 128, 0, stream>>>(x, rows, C, rpb, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, COLSUM_BLOCKS, C, out, nullptr, stream);
}

}  // namespace
