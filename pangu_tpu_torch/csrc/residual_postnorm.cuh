// The post-norm residual row kernels (sm_90a): K4's forward and K5's backward
// (fused_epilogue.cu), the backward also K12's LayerNorm-1 backward
// (fused_block_train.cu). Per token row of (rows, C), C = 64 NP:
//
//   forward   out = bf16(shortcut + s * LN(a))          (f32 inside, one rounding)
//   backward  da, dgamma, dbeta, ds from g = dL/dout     (LN statistics recomputed)
//
// with LN(a) = (a - mu) rsqrt(E[a^2] - mu^2 + 1e-5) gamma + beta and s an f32
// branch scale, one per `rows_per_scale` rows (K5: per row; K12: per sample).
// The backward reads g as bf16 (K5) or f32 (K12's dx1, unrounded).
//
// What bounds it on an H100: ~10 FLOP per element against 6 bytes per element
// each way (two bf16 reads, one bf16 write): memory. One warp per row keeps
// the row in registers (C/64 pairs per lane, 3 at C = 192, 6 at C = 384) and
// sums its statistics with shuffles, so each tensor is read once and written
// once. The backward's dgamma and dbeta are per-CTA partial sums (lane
// registers, then shared memory across the warps), summed over the CTAs by
// reduce_partials in a fixed order: deterministic.

#pragma once

#include "common.cuh"

namespace {

constexpr int EPI_WARPS = 8;
constexpr int EPI_THREADS = EPI_WARPS * 32;
constexpr int EPI_BWD_BLOCKS = 132 * 4;

template <int NP>
__device__ __forceinline__ void epi_load_row(const bf16* __restrict__ p, int lane,
                                             float (&v)[2 * NP]) {
  for (int j = 0; j < NP; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + 64 * j + 2 * lane));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <int NP>
__device__ __forceinline__ void epi_load_row(const float* __restrict__ p, int lane,
                                             float (&v)[2 * NP]) {
  for (int j = 0; j < NP; ++j) {
    const float2 f = *reinterpret_cast<const float2*>(p + 64 * j + 2 * lane);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// column of value i of a lane
__device__ __forceinline__ int epi_col(int i, int lane) {
  return 64 * (i >> 1) + 2 * lane + (i & 1);
}

template <int NP>
__device__ __forceinline__ void epi_row_stats(const float (&a)[2 * NP], float& mu, float& r) {
  constexpr int C = 64 * NP;
  float sum = 0.f, sq = 0.f;
  for (int i = 0; i < 2 * NP; ++i) {
    sum += a[i];
    sq += a[i] * a[i];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mu = sum / C;
  r = rsqrtf(sq / C - mu * mu + kLnEps);
}

template <int NP>
__global__ void __launch_bounds__(EPI_THREADS)
residual_postnorm_fwd_kernel(const bf16* __restrict__ sh, const bf16* __restrict__ a,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ s, bf16* __restrict__ out,
                             long long rows) {
  constexpr int C = 64 * NP;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * EPI_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float av[2 * NP], sv[2 * NP];
  epi_load_row<NP>(a + row * C, lane, av);
  epi_load_row<NP>(sh + row * C, lane, sv);
  float mu, r;
  epi_row_stats<NP>(av, mu, r);
  const float sc = s[row];
  for (int j = 0; j < NP; ++j) {
    float y[2];
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * j + e, c = epi_col(i, lane);
      y[e] = sv[i] + sc * ((av[i] - mu) * r * gamma[c] + beta[c]);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + row * C + 64 * j + 2 * lane) =
        __floats2bfloat162_rn(y[0], y[1]);
  }
}

// G: the type of the incoming gradient gy (bf16, or f32 for K12's dx1);
// PER_SAMPLE: s has one value per `rows_per_scale` rows (K12), else one per row.
template <int NP, typename G, bool PER_SAMPLE>
__global__ void __launch_bounds__(EPI_THREADS)
residual_postnorm_bwd_kernel(const bf16* __restrict__ a, const G* __restrict__ gy,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ s, bf16* __restrict__ da,
                             float* __restrict__ ds, float* __restrict__ dgamma_part,
                             float* __restrict__ dbeta_part, long long rows,
                             long long rows_per_scale) {
  constexpr int C = 64 * NP;
  __shared__ float red[2][EPI_WARPS][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gam[2 * NP], bet[2 * NP], dg[2 * NP], db[2 * NP];
  for (int i = 0; i < 2 * NP; ++i) {
    gam[i] = gamma[epi_col(i, lane)];
    bet[i] = beta[epi_col(i, lane)];
    dg[i] = 0.f;
    db[i] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * EPI_WARPS + warp; row < rows;
       row += (long long)gridDim.x * EPI_WARPS) {
    float av[2 * NP], gv[2 * NP];
    epi_load_row<NP>(a + row * C, lane, av);
    epi_load_row<NP>(gy + row * C, lane, gv);
    float mu, r;
    epi_row_stats<NP>(av, mu, r);
    const float sc = s[PER_SAMPLE ? row / rows_per_scale : row];
    float dsum = 0.f, m1 = 0.f, m2 = 0.f;
    float yhat[2 * NP], dyh[2 * NP];
    for (int i = 0; i < 2 * NP; ++i) {
      yhat[i] = (av[i] - mu) * r;
      dsum += gv[i] * (yhat[i] * gam[i] + bet[i]);
      const float gb = gv[i] * sc;
      dg[i] += gb * yhat[i];
      db[i] += gb;
      dyh[i] = gb * gam[i];
      m1 += dyh[i];
      m2 += dyh[i] * yhat[i];
    }
    dsum = warp_sum(dsum);
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    if (lane == 0) ds[row] = dsum;
    for (int j = 0; j < NP; ++j) {
      const int i = 2 * j;
      *reinterpret_cast<__nv_bfloat162*>(da + row * C + 64 * j + 2 * lane) =
          __floats2bfloat162_rn(r * (dyh[i] - m1 - yhat[i] * m2),
                                r * (dyh[i + 1] - m1 - yhat[i + 1] * m2));
    }
  }
  for (int i = 0; i < 2 * NP; ++i) {
    red[0][warp][epi_col(i, lane)] = dg[i];
    red[1][warp][epi_col(i, lane)] = db[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += EPI_THREADS) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < EPI_WARPS; ++w) {
      sg += red[0][w][c];
      sb += red[1][w][c];
    }
    dgamma_part[(long long)blockIdx.x * C + c] = sg;
    dbeta_part[(long long)blockIdx.x * C + c] = sb;
  }
}

template <int NP>
cudaError_t launch_residual_fwd(const bf16* sh, const bf16* a, const float* gamma,
                                const float* beta, const float* s, bf16* out, long long rows,
                                cudaStream_t stream) {
  residual_postnorm_fwd_kernel<NP><<<(unsigned)((rows + EPI_WARPS - 1) / EPI_WARPS),
                                     EPI_THREADS, 0, stream>>>(sh, a, gamma, beta, s, out, rows);
  return cudaGetLastError();
}

// The backward on `stream`: da, ds (per row), then dgamma and dbeta (f32, C)
// summed in order from the CTAs' partials in `part` (2 EPI_BWD_BLOCKS C floats).
template <int NP, typename G, bool PER_SAMPLE = false>
cudaError_t launch_residual_bwd(const bf16* a, const G* gy, const float* gamma,
                                const float* beta, const float* s, long long rows_per_scale,
                                bf16* da, float* ds, float* part, float* dgamma, float* dbeta,
                                long long rows, cudaStream_t stream) {
  constexpr int C = 64 * NP;
  residual_postnorm_bwd_kernel<NP, G, PER_SAMPLE><<<EPI_BWD_BLOCKS, EPI_THREADS, 0, stream>>>(
      a, gy, gamma, beta, s, da, ds, part, part + (long long)EPI_BWD_BLOCKS * C, rows,
      rows_per_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_partials(part, EPI_BWD_BLOCKS, C, nullptr, dgamma, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(part + (long long)EPI_BWD_BLOCKS * C, EPI_BWD_BLOCKS, C, nullptr, dbeta,
                         stream);
}

}  // namespace
