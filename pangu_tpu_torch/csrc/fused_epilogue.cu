// Post-norm residual of the attention sublayer in training, bf16 -- CUDA for
// Hopper (sm_90a), forward and backward.
//
// Replaces pangu_tpu/ops/fused_epilogue.py::fused_residual_postnorm (K4, the
// Pallas kernel _make_fwd_kernel) and its backward _res_bwd (K5,
// _make_bwd_kernel). Per token row of (rows, C):
//
//   forward   out = bf16(shortcut + s * LN(a))          (f32 inside, one rounding)
//   backward  da, dgamma, dbeta, ds from g = dL/dout     (LN statistics recomputed)
//
// with LN(a) = (a - mu) rsqrt(E[a^2] - mu^2 + 1e-5) gamma + beta and s the
// per-row f32 branch scale (stochastic depth). dshortcut is g itself and
// never touches a kernel.
//
// What bounds it on an H100: ~10 FLOP per element against 6 bytes per element
// each way (two bf16 reads, one bf16 write): memory. One warp per row keeps
// the row in registers (C/64 bf16 pairs per lane, 3 at C = 192, 6 at C = 384)
// and sums its statistics with shuffles, so each tensor is read once and
// written once. The backward's dgamma and dbeta are per-CTA partial sums (lane
// registers, then shared memory across the warps), summed over the CTAs by
// reduce_partials in a fixed order: deterministic.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_epilogue.py; the plain PyTorch versions are
// fused_residual_postnorm_reference and fused_residual_postnorm_bwd_reference.

#include "common.cuh"

namespace {

constexpr int EPI_WARPS = 8;
constexpr int EPI_THREADS = EPI_WARPS * 32;
constexpr int BWD_BLOCKS = 132 * 4;

template <int NP>
__device__ __forceinline__ void load_row(const bf16* __restrict__ p, int lane, float (&v)[2 * NP]) {
  for (int j = 0; j < NP; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + 64 * j + 2 * lane));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// column of value i of a lane
__device__ __forceinline__ int col_of(int i, int lane) { return 64 * (i >> 1) + 2 * lane + (i & 1); }

template <int NP>
__device__ __forceinline__ void row_stats(const float (&a)[2 * NP], float& mu, float& r) {
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
  load_row<NP>(a + row * C, lane, av);
  load_row<NP>(sh + row * C, lane, sv);
  float mu, r;
  row_stats<NP>(av, mu, r);
  const float sc = s[row];
  for (int j = 0; j < NP; ++j) {
    float y[2];
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * j + e, c = col_of(i, lane);
      y[e] = sv[i] + sc * ((av[i] - mu) * r * gamma[c] + beta[c]);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + row * C + 64 * j + 2 * lane) =
        __floats2bfloat162_rn(y[0], y[1]);
  }
}

template <int NP>
__global__ void __launch_bounds__(EPI_THREADS)
residual_postnorm_bwd_kernel(const bf16* __restrict__ a, const bf16* __restrict__ gy,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ s, bf16* __restrict__ da,
                             float* __restrict__ ds, float* __restrict__ dgamma_part,
                             float* __restrict__ dbeta_part, long long rows) {
  constexpr int C = 64 * NP;
  __shared__ float red[2][EPI_WARPS][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gam[2 * NP], bet[2 * NP], dg[2 * NP], db[2 * NP];
  for (int i = 0; i < 2 * NP; ++i) {
    gam[i] = gamma[col_of(i, lane)];
    bet[i] = beta[col_of(i, lane)];
    dg[i] = 0.f;
    db[i] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * EPI_WARPS + warp; row < rows;
       row += (long long)gridDim.x * EPI_WARPS) {
    float av[2 * NP], gv[2 * NP];
    load_row<NP>(a + row * C, lane, av);
    load_row<NP>(gy + row * C, lane, gv);
    float mu, r;
    row_stats<NP>(av, mu, r);
    const float sc = s[row];
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
    red[0][warp][col_of(i, lane)] = dg[i];
    red[1][warp][col_of(i, lane)] = db[i];
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
cudaError_t launch_fwd(const bf16* sh, const bf16* a, const float* gamma, const float* beta,
                       const float* s, bf16* out, long long rows, cudaStream_t stream) {
  residual_postnorm_fwd_kernel<NP><<<(unsigned)((rows + EPI_WARPS - 1) / EPI_WARPS),
                                     EPI_THREADS, 0, stream>>>(sh, a, gamma, beta, s, out, rows);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_bwd(const bf16* a, const bf16* gy, const float* gamma, const float* beta,
                       const float* s, bf16* da, float* ds, float* part, float* dgamma,
                       float* dbeta, long long rows, cudaStream_t stream) {
  constexpr int C = 64 * NP;
  residual_postnorm_bwd_kernel<NP><<<BWD_BLOCKS, EPI_THREADS, 0, stream>>>(
      a, gy, gamma, beta, s, da, ds, part, part + (long long)BWD_BLOCKS * C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_partials(part, BWD_BLOCKS, C, nullptr, dgamma, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(part + (long long)BWD_BLOCKS * C, BWD_BLOCKS, C, nullptr, dbeta, stream);
}

}  // namespace

extern "C" {

// K4 on `stream`: out = bf16(shortcut + s * LN(a)); s has one f32 per row.
// C 192 or 384, else cudaErrorInvalidValue.
int pangu_residual_postnorm_fwd(const void* shortcut, const void* a, const void* gamma,
                                const void* beta, const void* s, void* out, long long rows, int C,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* sh = static_cast<const bf16*>(shortcut);
  const bf16* ab = static_cast<const bf16*>(a);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(s);
  bf16* o = static_cast<bf16*>(out);
  switch (C) {
    case 192: return (int)launch_fwd<3>(sh, ab, gm, bt, sc, o, rows, st);
    case 384: return (int)launch_fwd<6>(sh, ab, gm, bt, sc, o, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_residual_postnorm_bwd needs.
long long pangu_residual_postnorm_bwd_scratch(int C) { return 2LL * BWD_BLOCKS * C; }

// K5 on `stream`: da (bf16, per element), ds (f32, per row), dgamma and dbeta
// (f32, C) from gy = dL/dout.
int pangu_residual_postnorm_bwd(const void* a, const void* gy, const void* gamma,
                                const void* beta, const void* s, void* da, void* ds,
                                void* scratch, void* dgamma, void* dbeta, long long rows, int C,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* gb = static_cast<const bf16*>(gy);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(s);
  bf16* d = static_cast<bf16*>(da);
  float* dsr = static_cast<float*>(ds);
  float* part = static_cast<float*>(scratch);
  float* dgm = static_cast<float*>(dgamma);
  float* dbt = static_cast<float*>(dbeta);
  switch (C) {
    case 192: return (int)launch_bwd<3>(ab, gb, gm, bt, sc, d, dsr, part, dgm, dbt, rows, st);
    case 384: return (int)launch_bwd<6>(ab, gb, gm, bt, sc, d, dsr, part, dgm, dbt, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
