// The window-attention kernel: per (batch, window, head), softmax(q k^T * scale
// + earth bias (+ shift mask)) @ v with the Pallas body's rounding points.
// Shared by the inference block (fused_earth_block.cu, K1) and the training
// attention forward (block_attention.cu, K2); the design notes are in
// fused_earth_block.cu.

#pragma once

#include "common.cuh"

namespace {

// ---- window attention --------------------------------------------------------
constexpr int ATT_WARPS = T / 16;               // one 16-row query tile per warp
constexpr int ATT_THREADS = ATT_WARPS * 32;     // 288
constexpr int QKV_LD = 3 * D + 8;               // bf16 row stride of the q|k|v tile
constexpr int KC = 64;                          // x channels staged per step
constexpr int XS_LD = KC + 8;
constexpr int S_LD = T;                         // f32 score row stride
constexpr int P_LD = T + 8;                     // bf16 prob row stride (over the scores)
constexpr int WARP_SCRATCH = 16 * S_LD * 4;     // 9,216 B per warp
constexpr int QKV_BYTES = T * QKV_LD * 2;       // 29,952 B
constexpr int ATT_SMEM = QKV_BYTES + ATT_WARPS * WARP_SCRATCH;  // 112,896 B
constexpr int O_OFFSET = 16 * P_LD * 2;         // P @ v tile after the probs
constexpr int WT_LD = KC + 8;                   // row stride of a staged (96, KC) Wqkv chunk
constexpr int XS_ELEMS = T * XS_LD;             // x chunk, then the Wqkv chunk
constexpr int ATT_STAGE_ELEMS = XS_ELEMS + 3 * D * WT_LD;  // 34,560 B per stage

static_assert(2 * ATT_STAGE_ELEMS * 2 <= ATT_WARPS * WARP_SCRATCH, "two stages fit the scratch");
static_assert((XS_ELEMS * 2) % 32 == 0 && (ATT_STAGE_ELEMS * 2) % 32 == 0,
              "wmma needs 256-bit aligned tiles");
static_assert(16 * 3 * D * 4 <= WARP_SCRATCH, "qkv staging fits a warp's scratch");
static_assert(O_OFFSET + 16 * D * 4 <= WARP_SCRATCH, "probs + output fit a warp's scratch");
static_assert(O_OFFSET % 32 == 0, "wmma needs 256-bit aligned tiles");

__global__ void __launch_bounds__(ATT_THREADS, 2)
window_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ attn_out,
                        Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem);
  unsigned char* scratch = smem + QKV_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zn = g.Z / g.wz, hn = g.Hp / g.wh, wn = g.W / g.ww;
  int idx = blockIdx.x;
  const int head = idx % g.heads;
  idx /= g.heads;
  const int wi = idx % wn;
  idx /= wn;
  const int hi = idx % hn;
  idx /= hn;
  const int zi = idx % zn;
  const int b = idx / zn;
  const int type = zi * hn + hi;
  const int C = g.C;

  // ---- q | k | v of this head: (144, C) @ (C, 96), KC channels of x and the
  // same KC input columns of this head's 96 Wqkv rows (its q, k and v outputs)
  // per stage
  bf16* stage0 = reinterpret_cast<bf16*>(scratch);
  FragC acc[6];
  for (int n = 0; n < 6; ++n) wmma::fill_fragment(acc[n], 0.f);
  pipelined(
      C / KC, stage0, stage0 + ATT_STAGE_ELEMS,
      [&](int i, bf16* st) {
        const int k0 = i * KC;
        for (int v = threadIdx.x; v < T * (KC / 8); v += ATT_THREADS) {
          const int t = v / (KC / 8), cv = v - t * (KC / 8);
          cp_async16(st + t * XS_LD + cv * 8,
                     x + token_row(g, b, zi, hi, wi, t) * C + k0 + cv * 8);
        }
        for (int v = threadIdx.x; v < 3 * D * (KC / 8); v += ATT_THREADS) {
          const int r = v / (KC / 8), cv = v - r * (KC / 8);
          const int seg = r / D, j = r - seg * D;  // seg 0,1,2: q, k, v
          cp_async16(st + XS_ELEMS + r * WT_LD + cv * 8,
                     wqkv + (long long)(seg * C + head * D + j) * C + k0 + cv * 8);
        }
      },
      [&](int, bf16* st) {
        for (int kk = 0; kk < KC; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, st + warp * 16 * XS_LD + kk, XS_LD);
          for (int n = 0; n < 6; ++n) {  // n = 0,1: q columns; 2,3: k; 4,5: v
            FragBt w;
            wmma::load_matrix_sync(w, st + XS_ELEMS + n * 16 * WT_LD + kk, WT_LD);
            wmma::mma_sync(acc[n], a, w, acc[n]);
          }
        }
      });
  // the stages are dead: the scratch is now per warp
  float* ws = reinterpret_cast<float*>(scratch + warp * WARP_SCRATCH);
  for (int n = 0; n < 6; ++n)
    wmma::store_matrix_sync(ws + n * 16, acc[n], 3 * D, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * 3 * D; e += 32) {
    const int r = e / (3 * D), cidx = e - r * (3 * D);
    const int seg = cidx / D, j = cidx - seg * D;
    const float v = ws[e] + __bfloat162float(bqkv[seg * C + head * D + j]);
    qkv[(warp * 16 + r) * QKV_LD + cidx] = __float2bfloat16(v);
  }
  __syncthreads();

  // ---- this warp's 16 query rows: scores, softmax, P @ v
  const int q0 = warp * 16;
  float* S = ws;
  bf16* P = reinterpret_cast<bf16*>(ws);  // written over S, row r after row r is read
  float* O = reinterpret_cast<float*>(scratch + warp * WARP_SCRATCH + O_OFFSET);
  {
    FragA qa[2];
    wmma::load_matrix_sync(qa[0], qkv + q0 * QKV_LD, QKV_LD);
    wmma::load_matrix_sync(qa[1], qkv + q0 * QKV_LD + 16, QKV_LD);
    for (int j = 0; j < T / 16; ++j) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
      for (int kk = 0; kk < 2; ++kk) {
        FragBt kt;  // k^T: column n of the tile is key token 16 j + n
        wmma::load_matrix_sync(kt, qkv + j * 16 * QKV_LD + D + kk * 16, QKV_LD);
        wmma::mma_sync(s, qa[kk], kt, s);
      }
      wmma::store_matrix_sync(S + j * 16, s, S_LD, wmma::mem_row_major);
    }
  }
  __syncwarp();

  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T;
  const float* mask_rows = mask ? mask + ((long long)type * T + q0) * T : nullptr;
  constexpr int PER_LANE = (T + 31) / 32;
  for (int r = 0; r < 16; ++r) {
    float v[PER_LANE];
    float m = -INFINITY;
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      v[i] = -INFINITY;
      if (c < T) {
        float s = S[r * S_LD + c] * scale + bias_rows[r * T + c];
        if (mask_rows) s += mask_rows[r * T + c];
        v[i] = s;
        m = fmaxf(m, s);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = (lane + 32 * i < T) ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // score row r is read by every lane before probs overwrite it
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      if (c < T) P[r * P_LD + c] = __float2bfloat16(v[i] / sum);
    }
  }
  __syncwarp();

  {
    FragC o[2];
    wmma::fill_fragment(o[0], 0.f);
    wmma::fill_fragment(o[1], 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, P + kk * 16, P_LD);
      for (int n = 0; n < 2; ++n) {
        FragB vb;
        wmma::load_matrix_sync(vb, qkv + kk * 16 * QKV_LD + 2 * D + n * 16, QKV_LD);
        wmma::mma_sync(o[n], pa, vb, o[n]);
      }
    }
    wmma::store_matrix_sync(O, o[0], D, wmma::mem_row_major);
    wmma::store_matrix_sync(O + 16, o[1], D, wmma::mem_row_major);
  }
  __syncwarp();
  {
    const int r = lane >> 1, c0 = (lane & 1) * 16;
    const long long row = token_row(g, b, zi, hi, wi, q0 + r);
    __align__(16) bf16 tmp[16];
    for (int j = 0; j < 16; ++j) tmp[j] = __float2bfloat16(O[r * D + c0 + j]);
    uint4* dst = reinterpret_cast<uint4*>(attn_out + row * C + head * D + c0);
    dst[0] = reinterpret_cast<const uint4*>(tmp)[0];
    dst[1] = reinterpret_cast<const uint4*>(tmp)[1];
  }
}

}  // namespace
