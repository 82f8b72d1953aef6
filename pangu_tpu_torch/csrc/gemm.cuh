// A tiled bf16 matrix product with f32 accumulation, and column sums, for the
// training attention (block_attention.cu): the out-projection of the forward
// (K2) and, in the backward (K3), dx = dqkv @ Wqkv and the deep weight-grad
// products dWqkv = dqkv^T @ x and dWproj = g^T @ acc over every token row;
// the weight grads of the MLP backwards (fused_mlp.cu), and the products of
// the training block backward K12 (fused_block_train.cu), whose dx is the sum
// of two products and an addend (gemm_sum).
//
//   out(m, n) = sum_k A(m, k) B(k, n)  [+ sum_k A2(m, k) B2(k, n) + addend(m, n)]
//   A(m, k) = A[m * lda + k] (A_ROW) or A[k * lda + m] (A stored transposed)
//   B(k, n) = B[k * ldb + n] (B_ROW) or B[n * ldb + k] (B stored transposed)
//
// One CTA of 4 warps computes a 64 x 64 tile, each warp 32 x 32 as 2 x 2 wmma
// 16x16x16 fragments; A and B tiles of depth 32 are staged in shared memory
// by cp.async through the two-stage ring of common.cuh, in the layout they
// have in memory (a transposed operand is read as a col-major fragment). A
// product over the token rows (K = 535,680 at the outer stage, M x N only
// 576 x 192) is split over gridDim.z slices of K, each writing f32 partials
// that reduce_partials sums in a fixed order: no atomics, the same result on
// every run.
//
// What bounds it: for the weight grads, ~2 x rows x C x 3C FLOP against one
// read of the two bf16 operands (rows x 4C x 2 B), ~200 FLOP per byte, near
// the H100's ~295 FLOP/B ridge; the wmma path reaches a fraction of the
// tensor-core peak, so it is bound by shared-memory fragment loads, as K1's
// tail kernel is. wgmma is later work.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GM = 64, GN = 64, GK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int G_A_ELEMS = GM * (GK + 8) > GK * (GM + 8) ? GM * (GK + 8) : GK * (GM + 8);
constexpr int G_B_ELEMS = GK * (GN + 8) > GN * (GK + 8) ? GK * (GN + 8) : GN * (GK + 8);
constexpr int G_STAGE_ELEMS = G_A_ELEMS + G_B_ELEMS;
constexpr int G_C_LD = GN + 4;
constexpr int G_SMEM = 2 * G_STAGE_ELEMS * 2 > GM * G_C_LD * 4 ? 2 * G_STAGE_ELEMS * 2
                                                               : GM * G_C_LD * 4;
static_assert((G_A_ELEMS * 2) % 32 == 0 && (G_STAGE_ELEMS * 2) % 32 == 0,
              "wmma needs 256-bit aligned tiles");

template <bool A_ROW, bool B_ROW>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, long long lda, const bf16* __restrict__ B,
            long long ldb, int M, int N, long long kchunk, long long K,
            const bf16* __restrict__ A2, long long lda2, const bf16* __restrict__ B2,
            long long ldb2, long long K2, const bf16* __restrict__ bias,
            const bf16* __restrict__ addend, bf16* __restrict__ out_bf16,
            float* __restrict__ out_f32) {
  __shared__ __align__(128) unsigned char smem[G_SMEM];
  bf16* st0 = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.x * GM;  // x: up to 2^31 - 1 row tiles
  const int n0 = blockIdx.y * GN;
  const long long kbeg = (long long)blockIdx.z * kchunk;
  const long long kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  constexpr int A_LD = A_ROW ? GK + 8 : GM + 8;
  constexpr int B_LD = B_ROW ? GN + 8 : GK + 8;

  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int nk = kend > kbeg ? (int)((kend - kbeg) / GK) : 0;
  const int nk2 = (int)(K2 / GK);  // the second product (one K slice only)
  if (nk + nk2 > 0)
    pipelined(
        nk + nk2, st0, st0 + G_STAGE_ELEMS,
        [&](int i, bf16* st) {
          const bool first = i < nk;
          const bf16* a = first ? A : A2;
          const bf16* b = first ? B : B2;
          const long long la = first ? lda : lda2, lb = first ? ldb : ldb2;
          const long long k0 = first ? kbeg + (long long)i * GK : (long long)(i - nk) * GK;
          if (A_ROW)
            stage_tile(st, A_LD, a + m0 * la + k0, la, GM, GK);
          else
            stage_tile(st, A_LD, a + k0 * la + m0, la, GK, GM);
          if (B_ROW)
            stage_tile(st + G_A_ELEMS, B_LD, b + k0 * lb + n0, lb, GK, GN);
          else
            stage_tile(st + G_A_ELEMS, B_LD, b + (long long)n0 * lb + k0, lb, GN, GK);
        },
        [&](int, bf16* st) {
          const bf16* As = st;
          const bf16* Bs = st + G_A_ELEMS;
          for (int kk = 0; kk < GK; kk += 16) {
            for (int i = 0; i < 2; ++i) {
              const int mr = wm * 32 + i * 16;
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             typename std::conditional<A_ROW, wmma::row_major,
                                                       wmma::col_major>::type>
                  a;
              wmma::load_matrix_sync(a, A_ROW ? As + mr * A_LD + kk : As + kk * A_LD + mr, A_LD);
              for (int j = 0; j < 2; ++j) {
                const int nc = wn * 32 + j * 16;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<B_ROW, wmma::row_major,
                                                         wmma::col_major>::type>
                    b;
                wmma::load_matrix_sync(b, B_ROW ? Bs + kk * B_LD + nc : Bs + nc * B_LD + kk,
                                       B_LD);
                wmma::mma_sync(acc[i][j], a, b, acc[i][j]);
              }
            }
          }
        });
  // the stages are dead (pipelined ends with a barrier): the f32 tile goes there
  float* Cs = reinterpret_cast<float*>(smem);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * G_C_LD + wn * 32 + j * 16, acc[i][j],
                              G_C_LD, wmma::mem_row_major);
  __syncthreads();
  if (out_bf16) {
    for (int v = threadIdx.x; v < GM * GN / 8; v += GEMM_THREADS) {
      const int r = v / (GN / 8), c = (v - r * (GN / 8)) * 8;
      __align__(16) bf16 tmp[8];
      for (int e = 0; e < 8; ++e) {
        float y = Cs[r * G_C_LD + c + e];
        if (bias) y += __bfloat162float(bias[n0 + c + e]);
        if (addend) y += __bfloat162float(addend[(m0 + r) * N + n0 + c + e]);
        tmp[e] = __float2bfloat16(y);
      }
      *reinterpret_cast<uint4*>(out_bf16 + (m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(tmp);
    }
  } else {
    float* part = out_f32 + (long long)blockIdx.z * M * N;
    for (int v = threadIdx.x; v < GM * GN; v += GEMM_THREADS) {
      const int r = v / GN, c = v - r * GN;
      part[(m0 + r) * N + n0 + c] = Cs[r * G_C_LD + c];
    }
  }
}

// One product, M x N, depth K. splits == 1: out_bf16 = bf16(A B (+ bias)).
// splits > 1: f32 partials of `splits` K-slices in `part` (splits x M x N), then
// out_bf16 = bf16(their sum). M, N multiples of 64, K of 32; lda, ldb multiples
// of 8 and 16-byte aligned bases (checked by the caller).
template <bool A_ROW, bool B_ROW>
cudaError_t gemm(const bf16* A, long long lda, const bf16* B, long long ldb, int M, int N,
                 long long K, int splits, const bf16* bias, bf16* out_bf16, float* part,
                 cudaStream_t stream) {
  if (M % GM || N % GN || K % GK || splits < 1) return cudaErrorInvalidValue;
  long long kchunk = (K / GK + splits - 1) / splits * GK;
  const dim3 grid(M / GM, N / GN, splits);
  gemm_kernel<A_ROW, B_ROW><<<grid, GEMM_THREADS, 0, stream>>>(
      A, lda, B, ldb, M, N, kchunk, K, nullptr, 0, nullptr, 0, 0, splits == 1 ? bias : nullptr,
      nullptr, splits == 1 ? out_bf16 : nullptr, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_partials(part, splits, (long long)M * N, out_bf16, nullptr, stream);
}

// out_bf16 = bf16(A B + A2 B2 (+ addend)), M x N, depths K and K2 (multiples
// of 32), both products in the layouts A_ROW, B_ROW; addend (M x N bf16, row
// stride N) may be null. The constraints of gemm, one K slice.
template <bool A_ROW, bool B_ROW>
cudaError_t gemm_sum(const bf16* A, long long lda, const bf16* B, long long ldb, long long K,
                     const bf16* A2, long long lda2, const bf16* B2, long long ldb2, long long K2,
                     int M, int N, const bf16* addend, bf16* out_bf16, cudaStream_t stream) {
  if (M % GM || N % GN || K % GK || K2 % GK) return cudaErrorInvalidValue;
  const dim3 grid(M / GM, N / GN, 1);
  gemm_kernel<A_ROW, B_ROW><<<grid, GEMM_THREADS, 0, stream>>>(
      A, lda, B, ldb, M, N, K, K, A2, lda2, B2, ldb2, K2, nullptr, addend, out_bf16, nullptr);
  return cudaGetLastError();
}

// Split count of a weight-grad product: about eight CTAs per SM in all.
inline int weight_grad_splits(int M, int N, long long K) {
  const long long tiles = (long long)(M / GM) * (N / GN);
  long long s = (132 * 8 + tiles - 1) / tiles;
  const long long kt = K / GK;
  if (s > kt) s = kt;
  return s < 1 ? 1 : (int)s;
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
