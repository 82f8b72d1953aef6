// The token tail of an Earth-Specific block, per 48 rows of the flattened
// (rolled, window-padded) grid: the out-projection of the attention output,
// LN1 and the first residual, the MLP (mlp_tile.cuh), LN2 and the second
// residual. token_tail_kernel<C, false> is the second kernel of the inference
// block K1 (fused_earth_block.cu, where the design is described);
// token_tail_kernel<C, true> that of the training block K11
// (fused_block_train.cu): per-sample branch scales s1, s2, and the attention
// output a and x1 rounded to bf16 as the unfused training chain writes them.
// token_tail_kernel<C, false, false> stops after LN1 and writes bf16(x1): the
// LN-epilogue mode of the training attention K2 (block_attention.cu).

#pragma once

#include "mlp_tile.cuh"

namespace {

// ---- token tail: out-projection, LN1, MLP, LN2 ----------------------------------
// Y holds f32 rows: y, then x1; XB bf16 rows: the attention output, then bf16(x1).
template <int C>
struct TailLayout : MlpTile<C> {
  using M = MlpTile<C>;
  static constexpr int WORK_BYTES = M::XB_BYTES + M::H_BYTES + M::HB_BYTES + 2 * M::STAGE_BYTES;
  // the MLP output reuses the work area once the MLP is done
  static constexpr int SMEM = M::Y_BYTES + cmax(WORK_BYTES, M::Y_BYTES);
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
};

// v[j] holds column lane + 32 j of one row; LayerNorm over the C columns.
template <int C>
__device__ __forceinline__ void layer_norm_row(float (&v)[C / 32], const float* __restrict__ s,
                                               const float* __restrict__ t, int lane) {
  float sum = 0.f, sq = 0.f;
  for (int j = 0; j < C / 32; ++j) {
    sum += v[j];
    sq += v[j] * v[j];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float rs = rsqrtf(sq / C - mu * mu + kLnEps);
  for (int j = 0; j < C / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = (v[j] - mu) * rs * s[c] + t[c];
  }
}

template <int C, bool TRAIN, bool MLP = true>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
token_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                  const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                  const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                  const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                  const float* __restrict__ s1, const float* __restrict__ s2,
                  long long rows_per_sample, bf16* __restrict__ out) {
  using L = TailLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Y = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + L::Y_BYTES;
  bf16* XB = reinterpret_cast<bf16*>(work);
  float* H = reinterpret_cast<float*>(work + L::XB_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(work + L::XB_BYTES + L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(work + L::XB_BYTES + L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE_BYTES / 2;
  float* Zs = reinterpret_cast<float*>(work);  // after the MLP
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;  // row tile, column group
  const long long row0 = (long long)blockIdx.x * TAIL_ROWS;
  // the tile's per-sample branch scales (a tile lies in one sample)
  const float sc1 = TRAIN ? s1[row0 / rows_per_sample] : 1.f;
  const float sc2 = TRAIN ? s2[row0 / rows_per_sample] : 1.f;

  // ---- y = attn @ Wproj: the attention rows are staged with the first chunk
  {
    FragC acc[L::NT];
    for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(acc[i], 0.f);
    pipelined(
        C / 32, S0, S1,
        [&](int i, bf16* st) {
          if (i == 0) stage_tile(XB, L::XB_LD, attn + row0 * C, C, TAIL_ROWS, C);
          stage_tile(st, L::WT_LD, wproj + i * 32, C, C, 32);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 32; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, XB + mt * 16 * L::XB_LD + i * 32 + kk, L::XB_LD);
            for (int j = 0; j < L::NT; ++j) {
              FragBt w;
              wmma::load_matrix_sync(w, st + (ng + 4 * j) * 16 * L::WT_LD + kk, L::WT_LD);
              wmma::mma_sync(acc[j], a, w, acc[j]);
            }
          }
        });
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Y + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, acc[j], L::Y_LD,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // ---- x1 = x + s1 LN1(y + bproj), kept f32 (inference) or rounded to bf16
  // with the attention output a = y + bproj before it (TRAIN, the unfused
  // chain's writes); bf16(x1) is the MLP input, or the output (MLP false)
  for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
    float v[C / 32];
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = Y[r * L::Y_LD + c] + __bfloat162float(bproj[c]);
      if (TRAIN) v[j] = __bfloat162float(__float2bfloat16(v[j]));
    }
    layer_norm_row<C>(v, ln1_s, ln1_b, lane);
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      float x1 = __bfloat162float(x[(row0 + r) * C + c]) + sc1 * v[j];
      if (TRAIN) x1 = __bfloat162float(__float2bfloat16(x1));
      if (!MLP) {
        out[(row0 + r) * C + c] = __float2bfloat16(x1);
        continue;
      }
      Y[r * L::Y_LD + c] = x1;
      XB[r * L::XB_LD + c] = __float2bfloat16(x1);
    }
  }
  if (!MLP) return;
  __syncthreads();

  // ---- z = GELU(x1 @ W1 + b1) @ W2, over 64-column chunks of the hidden
  FragC zacc[L::NT];
  mlp_rows<C>(XB, H, HB, S0, S1, w1, b1, w2, zacc);
  for (int j = 0; j < L::NT; ++j)
    wmma::store_matrix_sync(Zs + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, zacc[j], L::Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // ---- out = x1 + s2 LN2(z + b2), the add in f32
  for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
    float v[C / 32];
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = Zs[r * L::Y_LD + c] + __bfloat162float(b2[c]);
    }
    layer_norm_row<C>(v, ln2_s, ln2_b, lane);
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      out[(row0 + r) * C + c] = __float2bfloat16(Y[r * L::Y_LD + c] + sc2 * v[j]);
    }
  }
}

// One CTA per 48 rows; rows_per_sample a multiple of 48 (TRAIN: s1, s2 one f32
// per sample; else null). MLP false: out = bf16(x1); the MLP arguments may be null.
template <int C, bool TRAIN, bool MLP = true>
cudaError_t launch_tail(long long rows, cudaStream_t stream, const bf16* x, const bf16* attn,
                        const bf16* wproj, const bf16* bproj, const float* ln1_s,
                        const float* ln1_b, const bf16* w1, const bf16* b1, const bf16* w2,
                        const bf16* b2, const float* ln2_s, const float* ln2_b, const float* s1,
                        const float* s2, long long rows_per_sample, bf16* out) {
  using L = TailLayout<C>;
  if (rows % TAIL_ROWS || rows_per_sample % TAIL_ROWS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(token_tail_kernel<C, TRAIN, MLP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  token_tail_kernel<C, TRAIN, MLP>
      <<<(unsigned)(rows / TAIL_ROWS), TAIL_THREADS, L::SMEM, stream>>>(
      x, attn, wproj, bproj, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, s1, s2,
      rows_per_sample, out);
  return cudaGetLastError();
}

}  // namespace
