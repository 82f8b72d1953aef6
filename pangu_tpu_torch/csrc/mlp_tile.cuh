// The MLP of a 48-row token tile, GELU(x W1^T + b1) W2^T, streamed over
// 64-column chunks of the 4C hidden so that the (48, 4C) hidden never exists
// whole, on wmma fragments: the row pass of the MLP-tail backward K7 and the
// raw MLP K8 (fused_mlp.cu) and the block backward K12 (fused_block_train.cu).
// A CTA of 12 warps works on the tile, warp w on row tile w / 4 and column
// group w % 4; the W1 and W2 chunks are staged in shared memory through the
// two-stage cp.async ring of common.cuh. The hidden is rounded to bf16 after
// an f32 GELU, as the Pallas bodies round it. mlp_hidden_bwd_rows is the
// hidden pass of the block backward K12 (K7 and K9 have a wgmma hidden pass of
// their own, fused_mlp.cu). The forward MLP of K6, K10 and the block tails
// runs on wgmma (mlp_wg.cuh).

#pragma once

#include "common.cuh"

namespace {

constexpr int TAIL_ROWS = 48;  // divides every grid: rows = windows * 144
constexpr int TAIL_WARPS = 12;  // 3 row tiles x 4 column groups
constexpr int TAIL_THREADS = TAIL_WARPS * 32;
constexpr int HC = 64;  // hidden columns per MLP chunk

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

// CTAs of `kernel` (TAIL_THREADS each, `smem` bytes of dynamic shared memory)
// that fit the card at once, at most `tiles`: the grid of a loop over row tiles.
// 0 if the attributes cannot be set or read.
template <class K>
int resident_ctas(K kernel, int smem, long long tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TAIL_THREADS, smem) !=
          cudaSuccess)
    return 0;
  const long long n = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(n < tiles ? n : tiles);
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

// Bytes of one stage of mlp_hidden_bwd_rows: a W1 and a W2 chunk, or 32 W1 rows.
template <int C>
constexpr int hidden_bwd_stage_bytes() {
  return cmax(2 * HC * MlpTile<C>::W1_LD * 2, 32 * MlpTile<C>::XB_LD * 2);
}

// The hidden pass of an MLP backward for the 48-row tile at row0. Per 64-column
// chunk of the 4C hidden: h = XB W1^T + b1 beside dP = DB W2[:, chunk], in one
// pipelined loop over the same input channels (XB the MLP input, DB the
// gradient of its output, both (TAIL_ROWS, C) bf16 in shared memory, written
// and made visible before the call or staged by committed cp.async groups);
// a = bf16(GELU(h)) and dh = bf16(dP GELU'(h)) go to the (rows, 4C) slabs a_out
// and dh_out, bf16 dh to HB and the f32 dh to P; dacc (the warp's C / 64 tiles)
// accumulates dh W1[chunk, :]; db1 (4C f32, shared memory) adds the chunk's
// column sums of the f32 dh, rows in order; then every thread runs
// chunk_done(h0), with HB and XB intact. The stages S0, S1 each hold
// hidden_bwd_stage_bytes<C>(). Ends with a barrier.
template <int C, class Hook>
__device__ __forceinline__ void mlp_hidden_bwd_rows(
    const bf16* XB, const bf16* DB, float* H, float* P, bf16* HB, bf16* S0, bf16* S1,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    bf16* __restrict__ a_out, bf16* __restrict__ dh_out, long long row0, float* db1,
    FragC (&dacc)[C / 64], Hook chunk_done) {
  using L = MlpTile<C>;
  constexpr int H4 = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;
  for (int h0 = 0; h0 < H4; h0 += HC) {
    FragC hacc, pacc;
    wmma::fill_fragment(hacc, 0.f);
    wmma::fill_fragment(pacc, 0.f);
    // h and dP together over C in steps of 64: W1 rows h0.. (col-major B) and
    // W2 columns h0.. (row-major B) of the same 64 input channels
    pipelined(
        C / 64, S0, S1,
        [&](int i, bf16* st) {
          stage_tile(st, L::W1_LD, w1 + (long long)h0 * C + i * 64, C, HC, 64);
          stage_tile(st + HC * L::W1_LD, L::W1_LD, w2 + (long long)i * 64 * H4 + h0, H4, 64, HC);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 64; kk += 16) {
            FragA a, d;
            wmma::load_matrix_sync(a, XB + mt * 16 * L::XB_LD + i * 64 + kk, L::XB_LD);
            wmma::load_matrix_sync(d, DB + mt * 16 * L::XB_LD + i * 64 + kk, L::XB_LD);
            FragBt w;
            wmma::load_matrix_sync(w, st + ng * 16 * L::W1_LD + kk, L::W1_LD);
            wmma::mma_sync(hacc, a, w, hacc);
            FragB w2f;
            wmma::load_matrix_sync(w2f, st + HC * L::W1_LD + kk * L::W1_LD + ng * 16, L::W1_LD);
            wmma::mma_sync(pacc, d, w2f, pacc);
          }
        });
    float* Ht = H + mt * 16 * L::H_LD + ng * 16;
    float* Pt = P + mt * 16 * L::H_LD + ng * 16;
    wmma::store_matrix_sync(Ht, hacc, L::H_LD, wmma::mem_row_major);
    wmma::store_matrix_sync(Pt, pacc, L::H_LD, wmma::mem_row_major);
    __syncwarp();
    {  // lane: row r of the warp's 16 x 16 tile, 8 columns from c0
      const int r = lane >> 1, c0 = (lane & 1) * 8;
      const long long at = (row0 + mt * 16 + r) * H4 + h0 + ng * 16 + c0;
      __align__(16) bf16 av[8], dv[8];
      for (int e = 0; e < 8; ++e) {
        const float h = Ht[r * L::H_LD + c0 + e] + __bfloat162float(b1[h0 + ng * 16 + c0 + e]);
        const float dh = Pt[r * L::H_LD + c0 + e] * gelu_grad(h);
        av[e] = __float2bfloat16(gelu(h));
        dv[e] = __float2bfloat16(dh);
        Pt[r * L::H_LD + c0 + e] = dh;
        HB[(mt * 16 + r) * L::HB_LD + ng * 16 + c0 + e] = dv[e];
      }
      *reinterpret_cast<uint4*>(a_out + at) = *reinterpret_cast<const uint4*>(av);
      *reinterpret_cast<uint4*>(dh_out + at) = *reinterpret_cast<const uint4*>(dv);
    }
    // dx += dh W1[h0:h0+64, :] (row-major B), 32 hidden rows per stage; the
    // first barrier inside makes every warp's dh tile visible
    pipelined(
        HC / 32, S0, S1,
        [&](int i, bf16* st) {
          stage_tile(st, L::XB_LD, w1 + (long long)(h0 + i * 32) * C, C, 32, C);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 32; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, HB + mt * 16 * L::HB_LD + i * 32 + kk, L::HB_LD);
            for (int j = 0; j < L::NT; ++j) {
              FragB w;
              wmma::load_matrix_sync(w, st + kk * L::XB_LD + (ng + 4 * j) * 16, L::XB_LD);
              wmma::mma_sync(dacc[j], a, w, dacc[j]);
            }
          }
        });
    // db1 of the chunk: column sums of the f32 dh, rows in order
    for (int c = threadIdx.x; c < HC; c += TAIL_THREADS) {
      float acc = 0.f;
      for (int r = 0; r < TAIL_ROWS; ++r) acc += P[r * L::H_LD + c];
      db1[h0 + c] += acc;
    }
    chunk_done(h0);
  }
  __syncthreads();
}

}  // namespace
