// The MLP of a 48-row token tile, GELU(x W1^T + b1) W2^T, streamed over
// 64-column chunks of the 4C hidden so that the (48, 4C) hidden never exists
// whole: shared by K1's token tail (fused_earth_block.cu) and the training
// MLP tail K6/K7 (fused_mlp.cu). A CTA of 12 warps works on the tile, warp w
// on row tile w / 4 and column group w % 4; the W1 and W2 chunks are staged in
// shared memory through the two-stage cp.async ring of common.cuh. The hidden
// is rounded to bf16 after an f32 GELU, as the Pallas bodies round it.

#pragma once

#include "common.cuh"

namespace {

constexpr int TAIL_ROWS = 48;  // divides every grid: rows = windows * 144
constexpr int TAIL_WARPS = 12;  // 3 row tiles x 4 column groups
constexpr int TAIL_THREADS = TAIL_WARPS * 32;
constexpr int HC = 64;  // hidden columns per MLP chunk

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C>
struct MlpTile {
  static constexpr int Y_LD = C + 4;      // f32 rows of width C
  static constexpr int XB_LD = C + 8;     // bf16 rows of width C: the MLP input
  static constexpr int H_LD = HC + 4;     // f32 hidden chunk
  static constexpr int HB_LD = HC + 8;    // bf16 hidden chunk
  static constexpr int WT_LD = 32 + 8;    // staged (C, 32) chunk of W2 (or Wproj) rows
  static constexpr int W1_LD = 64 + 8;    // staged (64, 64) chunk of W1 rows
  static constexpr int Y_BYTES = TAIL_ROWS * Y_LD * 4;
  static constexpr int XB_BYTES = TAIL_ROWS * XB_LD * 2;
  static constexpr int H_BYTES = TAIL_ROWS * H_LD * 4;
  static constexpr int HB_BYTES = TAIL_ROWS * HB_LD * 2;
  static constexpr int STAGE_BYTES = cmax(C * WT_LD * 2, HC * W1_LD * 2);
  static constexpr int NT = C / 64;  // 16-column output tiles per warp
  static_assert(C % 64 == 0, "C must be a multiple of 64");
  static_assert(Y_BYTES % 32 == 0 && XB_BYTES % 32 == 0 && H_BYTES % 32 == 0 &&
                    HB_BYTES % 32 == 0 && STAGE_BYTES % 32 == 0,
                "wmma needs 256-bit aligned tiles");
};

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// yacc = GELU(XB W1^T + b1) W2^T for the warp's 16-row tile and its C / 64
// column tiles (ng + 4 j), f32. XB (TAIL_ROWS, C) bf16 must be written before
// the call and made visible by a barrier, or staged by cp.async groups
// committed before it (the first chunk's wait and barrier complete them). H,
// HB and the stages S0, S1 (MlpTile<C>::STAGE_BYTES each) are scratch. Ends
// with a barrier.
template <int C>
__device__ __forceinline__ void mlp_rows(const bf16* XB, float* H, bf16* HB, bf16* S0, bf16* S1,
                                         const bf16* __restrict__ w1,
                                         const bf16* __restrict__ b1,
                                         const bf16* __restrict__ w2, FragC (&yacc)[C / 64]) {
  using L = MlpTile<C>;
  constexpr int H4 = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;  // row tile, column group
  for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(yacc[i], 0.f);
  for (int h0 = 0; h0 < H4; h0 += HC) {
    FragC hacc;
    wmma::fill_fragment(hacc, 0.f);
    pipelined(
        C / 64, S0, S1,
        [&](int i, bf16* st) {
          stage_tile(st, L::W1_LD, w1 + (long long)h0 * C + i * 64, C, HC, 64);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 64; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, XB + mt * 16 * L::XB_LD + i * 64 + kk, L::XB_LD);
            FragBt w;
            wmma::load_matrix_sync(w, st + ng * 16 * L::W1_LD + kk, L::W1_LD);
            wmma::mma_sync(hacc, a, w, hacc);
          }
        });
    float* Ht = H + mt * 16 * L::H_LD + ng * 16;
    wmma::store_matrix_sync(Ht, hacc, L::H_LD, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const float h = Ht[r * L::H_LD + c] + __bfloat162float(b1[h0 + ng * 16 + c]);
      HB[(mt * 16 + r) * L::HB_LD + ng * 16 + c] = __float2bfloat16(gelu(h));
    }
    // the first barrier inside makes every warp's hidden tile visible
    pipelined(
        HC / 32, S0, S1,
        [&](int i, bf16* st) { stage_tile(st, L::WT_LD, w2 + h0 + i * 32, H4, C, 32); },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 32; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, HB + mt * 16 * L::HB_LD + i * 32 + kk, L::HB_LD);
            for (int j = 0; j < L::NT; ++j) {
              FragBt w;
              wmma::load_matrix_sync(w, st + (ng + 4 * j) * 16 * L::WT_LD + kk, L::WT_LD);
              wmma::mma_sync(yacc[j], a, w, yacc[j]);
            }
          }
        });
  }
}

}  // namespace
