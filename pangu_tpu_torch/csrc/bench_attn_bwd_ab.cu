// Attention-backward A/B: the weight grads accumulated on chip -- CUDA for
// Hopper (sm_90a).
//
// Replaces the `local_accum` variant of scripts/bench_attn_bwd_ab.py (S2, the
// Pallas body _make_variant_kernel run by _variant_call; `shipped` is K3,
// block_attention.cu). It computes K3's function, mask-free, on the outer-stage
// grid (C = 192): from the cotangent g of y = attn(x) @ Wproj^T + bproj, dx
// (bf16), dWqkv, dbqkv, dWproj, dbproj and dbias, the weight and bias grads f32
// and unrounded, as the JAX variants return them.
//
// Design. K3 writes the attention output acc (rows, C) and dqkv (rows, 3C) as
// bf16 slabs and forms dWqkv = dqkv^T x and dWproj = g^T acc as row-split
// products over all rows. The Pallas variant instead carries the weight grads
// across the windows of its program. Here attention_bwd_kernel (below, K3's
// earlier wmma schedule): one CTA per (window type, head), as K3, which after
// each window adds its head's dWqkv slice
// (dq_h|dk_h|dv_h)^T x (96 x C) and dWproj columns acc_h^T g (32 x C) into
// 96 wmma accumulators in f32 registers (11 per warp), reading x and g again
// from L2 into the qkv and dO tiles it no longer needs. Each CTA writes one partial per (type, head); reduce_partials sums
// the 124 type partials in a fixed order (no atomics: the same bits on every
// run). dx = dqkv @ Wqkv, dbqkv and dbias stay as K3 computes them; dbproj is
// the column sum of g in f32.
//
// What bounds it on an H100: K3's products and bytes (the acc slab and the two
// deep products it no longer needs are traded for the per-window weight-grad
// products, the same FLOP); the partials are 73 MB of f32.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_attn_bwd_ab.py; the plain PyTorch version is
// fused_block_attention_bwd_reference(..., round_grads=False) of
// pangu_tpu_torch/ops/fused_block_attention.py.

#include "attention_bwd.cuh"
#include "gemm.cuh"

namespace {

// ---- K3's earlier schedule: wmma fragments, the scores in shared memory
constexpr int DS_LD = T + 8;                 // bf16 rows of P and dS
constexpr int WR_S = 16 * T * 4;             // f32 scores / probabilities, 9,216 B
constexpr int WR_P = 16 * DS_LD * 2;         // bf16 P rows, 4,864 B
constexpr int WR_BYTES = WR_S + 2 * WR_P;    // + bf16 dS rows: 18,944 B per warp
constexpr int TMP_BYTES = 16 * 16 * 4;       // one dP fragment per warp
constexpr int BWD_SMEM = QKV_BYTES + DO_BYTES + BWD_WARPS * (WR_BYTES + TMP_BYTES);
constexpr int B_XS = T * XS_LD;              // per stage: x chunk, g chunk, Wqkv, Wproj
constexpr int B_STAGE_ELEMS = 2 * B_XS + 3 * D * WT_LD + KC * WP_LD;

static_assert(BWD_SMEM <= 232448, "fits one CTA's shared memory");
static_assert(2 * B_STAGE_ELEMS * 2 <= BWD_WARPS * WR_BYTES, "two stages fit the warp regions");
static_assert(WR_S % 32 == 0 && WR_P % 32 == 0 && WR_BYTES % 32 == 0 && DO_BYTES % 32 == 0 &&
                  (B_XS * 2) % 32 == 0 && (3 * D * WT_LD * 2) % 32 == 0,
              "wmma needs 256-bit aligned tiles");
static_assert(16 * 4 * D * 4 <= WR_S, "the qkv and dO rows of a warp fit its f32 region");

// ---- the on-chip weight grads of the local_accum schedule (C = 192 only)
constexpr int LC = 192;
constexpr int LQ_LD = 3 * D + 8;               // a warp's bf16 dq|dk|dv rows, in its P region
constexpr int LA_LD = D + 8;                   // its bf16 acc rows, in its dS region
constexpr int L_TILES = (3 * D / 16 + D / 16) * (LC / 16);  // 96 16x16 tiles: dWqkv_h, dWproj_h
constexpr int L_PER_WARP = (L_TILES + BWD_WARPS - 1) / BWD_WARPS;  // 11
constexpr int L_CHUNK_TILES = L_TILES / (LC / KC);                  // 32 per 64 channels
static_assert(16 * LQ_LD * 2 <= WR_P && 16 * LA_LD * 2 <= WR_P, "the rows fit the regions");
static_assert(2 * T * XS_LD * 2 <= QKV_BYTES + DO_BYTES, "an x and a g chunk fit qkv and dO");
using FragAcm = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

// dO = g @ Wproj[:, head] is formed here, and the dWqkv rows (seg C + head D +
// j, all C) and dWproj columns (head D + j) of this (type, head), summed over
// its windows, go to wgrad_part: n_types (3C, C) partials, then n_types (C, C)
// partials (nn.Linear layouts).
__global__ void __launch_bounds__(BWD_THREADS, 1)
attention_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                     const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                     const bf16* __restrict__ wproj, const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ dqkv,
                     float* __restrict__ dbias, float* __restrict__ dbqkv_part, Geom g,
                     float scale, float* __restrict__ wgrad_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem);
  bf16* dO = reinterpret_cast<bf16*>(smem + QKV_BYTES);
  unsigned char* regions = smem + QKV_BYTES + DO_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wr = regions + warp * WR_BYTES;
  float* S = reinterpret_cast<float*>(wr);                  // (16, T) f32
  bf16* Pw = reinterpret_cast<bf16*>(wr + WR_S);            // (16, DS_LD) bf16
  bf16* dSw = reinterpret_cast<bf16*>(wr + WR_S + WR_P);    // (16, DS_LD) bf16
  float* tmp = reinterpret_cast<float*>(regions + BWD_WARPS * WR_BYTES + warp * TMP_BYTES);
  auto P_of = [&](int w) { return reinterpret_cast<const bf16*>(regions + w * WR_BYTES + WR_S); };
  auto dS_of = [&](int w) {
    return reinterpret_cast<const bf16*>(regions + w * WR_BYTES + WR_S + WR_P);
  };

  const int hn = g.Hp / g.wh, wn = g.W / g.ww;
  const int head = blockIdx.x % g.heads;
  const int type = blockIdx.x / g.heads;
  const int zi = type / hn, hi = type - zi * hn;
  const int C = g.C;
  const int q0 = warp * 16;
  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T;
  const float* mask_rows = mask ? mask + ((long long)type * T + q0) * T : nullptr;
  float* dbias_rows = dbias + ((long long)(type * g.heads + head) * T + q0) * T;
  float bsum[3] = {0.f, 0.f, 0.f};  // dbqkv partials: column lane of dq, dk, dv
  FragC wacc[L_PER_WARP];  // tiles warp + BWD_WARPS f of the 96
  for (int f = 0; f < L_PER_WARP; ++f) wmma::fill_fragment(wacc[f], 0.f);
  uint4 acc_keep[2];  // the lane's 16 bf16 acc values of this window

  for (int b = 0; b < g.B; ++b) {
    for (int wi = 0; wi < wn; ++wi) {
      // ---- this head's q|k|v (x @ Wqkv rows) and dO (g @ Wproj columns) for
      // the warp's 16 rows, KC input channels per stage
      constexpr int NF = 8;
      FragC acc[NF];  // 0-5: q|k|v columns, 6-7: dO columns
      for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);
      bf16* stage0 = reinterpret_cast<bf16*>(regions);
      pipelined(
          C / KC, stage0, stage0 + B_STAGE_ELEMS,
          [&](int i, bf16* st) {
            const int k0 = i * KC;
            for (int v = threadIdx.x; v < T * (KC / 8); v += BWD_THREADS) {
              const int t = v / (KC / 8), cv = v - t * (KC / 8);
              const long long row = token_row(g, b, zi, hi, wi, t) * C + k0 + cv * 8;
              cp_async16(st + t * XS_LD + cv * 8, x + row);
              cp_async16(st + B_XS + t * XS_LD + cv * 8, gy + row);
            }
            for (int v = threadIdx.x; v < 3 * D * (KC / 8); v += BWD_THREADS) {
              const int r = v / (KC / 8), cv = v - r * (KC / 8);
              const int seg = r / D, j = r - seg * D;
              cp_async16(st + 2 * B_XS + r * WT_LD + cv * 8,
                         wqkv + (long long)(seg * C + head * D + j) * C + k0 + cv * 8);
            }
            for (int v = threadIdx.x; v < KC * (D / 8); v += BWD_THREADS) {
              const int r = v / (D / 8), cv = v - r * (D / 8);
              cp_async16(st + 2 * B_XS + 3 * D * WT_LD + r * WP_LD + cv * 8,
                         wproj + (long long)(k0 + r) * C + head * D + cv * 8);
            }
          },
          [&](int, bf16* st) {
            for (int kk = 0; kk < KC; kk += 16) {
              FragA a;
              wmma::load_matrix_sync(a, st + q0 * XS_LD + kk, XS_LD);
              for (int n = 0; n < 6; ++n) {
                FragBt w;
                wmma::load_matrix_sync(w, st + 2 * B_XS + n * 16 * WT_LD + kk, WT_LD);
                wmma::mma_sync(acc[n], a, w, acc[n]);
              }
              FragA ga;
              wmma::load_matrix_sync(ga, st + B_XS + q0 * XS_LD + kk, XS_LD);
              for (int n = 6; n < NF; ++n) {
                FragB w;
                wmma::load_matrix_sync(
                    w, st + 2 * B_XS + 3 * D * WT_LD + kk * WP_LD + (n - 6) * 16, WP_LD);
                wmma::mma_sync(acc[n], ga, w, acc[n]);
              }
            }
          });
      // the stages are dead: each warp stages its rows in its own f32 region
      for (int n = 0; n < NF; ++n)
        wmma::store_matrix_sync(S + n * 16, acc[n], 4 * D, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 4 * D; e += 32) {
        const int r = e / (4 * D), cidx = e - r * (4 * D);
        if (cidx < 3 * D) {
          const int seg = cidx / D, j = cidx - seg * D;
          const float v = S[e] + __bfloat162float(bqkv[seg * C + head * D + j]);
          qkv[(q0 + r) * QKV_LD + cidx] = __float2bfloat16(v);
        } else {
          dO[(q0 + r) * DO_LD + cidx - 3 * D] = __float2bfloat16(S[e]);
        }
      }
      __syncthreads();

      // ---- scores of the warp's query rows, f32 softmax: p f32 in S, bf16 in P
      {
        FragA qa[2];
        wmma::load_matrix_sync(qa[0], qkv + q0 * QKV_LD, QKV_LD);
        wmma::load_matrix_sync(qa[1], qkv + q0 * QKV_LD + 16, QKV_LD);
        for (int j = 0; j < T / 16; ++j) {
          FragC s;
          wmma::fill_fragment(s, 0.f);
          for (int kk = 0; kk < 2; ++kk) {
            FragBt kt;
            wmma::load_matrix_sync(kt, qkv + j * 16 * QKV_LD + D + kk * 16, QKV_LD);
            wmma::mma_sync(s, qa[kk], kt, s);
          }
          wmma::store_matrix_sync(S + j * 16, s, T, wmma::mem_row_major);
        }
      }
      __syncwarp();
      constexpr int PER_LANE = (T + 31) / 32;
      for (int r = 0; r < 16; ++r) {
        float v[PER_LANE];
        float m = -INFINITY;
        for (int i = 0; i < PER_LANE; ++i) {
          const int c = lane + 32 * i;
          v[i] = -INFINITY;
          if (c < T) {
            float s = S[r * T + c] * scale + bias_rows[r * T + c];
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
        for (int i = 0; i < PER_LANE; ++i) {
          const int c = lane + 32 * i;
          if (c < T) {
            const float p = v[i] / sum;
            S[r * T + c] = p;
            Pw[r * DS_LD + c] = __float2bfloat16(p);
          }
        }
      }
      __syncwarp();

      // ---- acc = P v for the warp's rows, kept in registers (f32 staging in dS)
      {
        FragC o[2];
        wmma::fill_fragment(o[0], 0.f);
        wmma::fill_fragment(o[1], 0.f);
        for (int kk = 0; kk < T / 16; ++kk) {
          FragA pa;
          wmma::load_matrix_sync(pa, Pw + kk * 16, DS_LD);
          for (int n = 0; n < 2; ++n) {
            FragB vb;
            wmma::load_matrix_sync(vb, qkv + kk * 16 * QKV_LD + 2 * D + n * 16, QKV_LD);
            wmma::mma_sync(o[n], pa, vb, o[n]);
          }
        }
        float* O = reinterpret_cast<float*>(dSw);
        wmma::store_matrix_sync(O, o[0], D, wmma::mem_row_major);
        wmma::store_matrix_sync(O + 16, o[1], D, wmma::mem_row_major);
        __syncwarp();
        const int r = lane >> 1, c0 = (lane & 1) * 16;
        __align__(16) bf16 t16[16];
        for (int j = 0; j < 16; ++j) t16[j] = __float2bfloat16(O[r * D + c0 + j]);
        acc_keep[0] = reinterpret_cast<const uint4*>(t16)[0];
        acc_keep[1] = reinterpret_cast<const uint4*>(t16)[1];
        __syncwarp();
      }

      // ---- dP = dO v^T, tile by tile: first rowsum(dP p), then dS (dbias, bf16 dS)
      {
        FragA da[2];
        wmma::load_matrix_sync(da[0], dO + q0 * DO_LD, DO_LD);
        wmma::load_matrix_sync(da[1], dO + q0 * DO_LD + 16, DO_LD);
        const int r = lane >> 1, c0 = (lane & 1) * 8;
        auto dp_tile = [&](int j) {
          FragC dp;
          wmma::fill_fragment(dp, 0.f);
          for (int kk = 0; kk < 2; ++kk) {
            FragBt vt;  // v^T: column n of the tile is key token 16 j + n
            wmma::load_matrix_sync(vt, qkv + j * 16 * QKV_LD + 2 * D + kk * 16, QKV_LD);
            wmma::mma_sync(dp, da[kk], vt, dp);
          }
          wmma::store_matrix_sync(tmp, dp, 16, wmma::mem_row_major);
          __syncwarp();
        };
        float rs = 0.f;
        for (int j = 0; j < T / 16; ++j) {
          dp_tile(j);
          for (int c = 0; c < 8; ++c) rs += tmp[r * 16 + c0 + c] * S[r * T + j * 16 + c0 + c];
          __syncwarp();
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        const bool first = (b == 0 && wi == 0);
        for (int j = 0; j < T / 16; ++j) {
          dp_tile(j);
          for (int c = 0; c < 8; ++c) {
            const int col = j * 16 + c0 + c;
            const float p = S[r * T + col];
            const float ds = p * (tmp[r * 16 + c0 + c] - rs);
            float* db = dbias_rows + r * T + col;
            *db = first ? ds : *db + ds;
            dSw[r * DS_LD + col] = __float2bfloat16(ds);
          }
          __syncwarp();
        }
      }
      __syncthreads();  // every warp's P and dS rows are complete

      // ---- dq (query rows), dk and dv (key rows) of tile `warp`
      {
        FragC o[6];  // dq 0-1, dk 2-3, dv 4-5
        for (int n = 0; n < 6; ++n) wmma::fill_fragment(o[n], 0.f);
        for (int t = 0; t < T / 16; ++t) {
          FragA a;
          wmma::load_matrix_sync(a, dSw + t * 16, DS_LD);
          for (int n = 0; n < 2; ++n) {
            FragB kb;
            wmma::load_matrix_sync(kb, qkv + t * 16 * QKV_LD + D + n * 16, QKV_LD);
            wmma::mma_sync(o[n], a, kb, o[n]);
          }
          using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
          FragAt dst, pt;  // dS^T and P^T: rows of query tile t, columns of key tile warp
          wmma::load_matrix_sync(dst, dS_of(t) + q0, DS_LD);
          wmma::load_matrix_sync(pt, P_of(t) + q0, DS_LD);
          for (int n = 0; n < 2; ++n) {
            FragB qb, ob;
            wmma::load_matrix_sync(qb, qkv + t * 16 * QKV_LD + n * 16, QKV_LD);
            wmma::mma_sync(o[2 + n], dst, qb, o[2 + n]);
            wmma::load_matrix_sync(ob, dO + t * 16 * DO_LD + n * 16, DO_LD);
            wmma::mma_sync(o[4 + n], pt, ob, o[4 + n]);
          }
        }
        for (int n = 0; n < 4; ++n)
          for (int e = 0; e < o[n].num_elements; ++e) o[n].x[e] *= scale;
        // S is dead for this window: stage the (16, 3 x 32) f32 rows there
        for (int n = 0; n < 6; ++n)
          wmma::store_matrix_sync(S + n * 16, o[n], 3 * D, wmma::mem_row_major);
        __syncwarp();
        for (int seg = 0; seg < 3; ++seg) {
          float s = 0.f;
          for (int r = 0; r < 16; ++r) s += S[r * 3 * D + seg * D + lane];
          bsum[seg] += s;
        }
        const int r = lane >> 1, c0 = (lane & 1) * 16;
        const long long row = token_row(g, b, zi, hi, wi, q0 + r);
        for (int seg = 0; seg < 3; ++seg) {
          __align__(16) bf16 t16[16];
          for (int j = 0; j < 16; ++j) t16[j] = __float2bfloat16(S[r * 3 * D + seg * D + c0 + j]);
          uint4* dst = reinterpret_cast<uint4*>(dqkv + row * 3 * C + seg * C + head * D + c0);
          dst[0] = reinterpret_cast<const uint4*>(t16)[0];
          dst[1] = reinterpret_cast<const uint4*>(t16)[1];
        }
      }
      __syncthreads();  // the regions are staging space again

      {
        // ---- this window's dWqkv_h += dqkv_h^T x and dWproj_h^T += acc_h^T g: the
        // warp's bf16 dq|dk|dv rows (still f32 in S) go to its P region, its acc
        // rows to its dS region; x and g come again, 64 channels at a time, into
        // the dead qkv and dO tiles
        bf16* dqw = reinterpret_cast<bf16*>(wr + WR_S);
        bf16* accw = reinterpret_cast<bf16*>(wr + WR_S + WR_P);
        for (int e = lane; e < 16 * 3 * D; e += 32) {
          const int rr = e / (3 * D), cc = e - rr * (3 * D);
          dqw[rr * LQ_LD + cc] = __float2bfloat16(S[e]);
        }
        {
          const int rr = lane >> 1, cc = (lane & 1) * 16;
          reinterpret_cast<uint4*>(accw + rr * LA_LD + cc)[0] = acc_keep[0];
          reinterpret_cast<uint4*>(accw + rr * LA_LD + cc)[1] = acc_keep[1];
        }
        bf16* xs = reinterpret_cast<bf16*>(smem);
        bf16* gs = xs + T * XS_LD;
        for (int i = 0; i < LC / KC; ++i) {
          for (int v = threadIdx.x; v < T * (KC / 8); v += BWD_THREADS) {
            const int t = v / (KC / 8), cv = v - t * (KC / 8);
            const long long at = token_row(g, b, zi, hi, wi, t) * LC + i * KC + cv * 8;
            cp_async16(xs + t * XS_LD + cv * 8, x + at);
            cp_async16(gs + t * XS_LD + cv * 8, gy + at);
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();  // the chunks and every warp's rows are in place
#pragma unroll
          for (int f = 0; f < L_PER_WARP; ++f) {
            const int tile = warp + BWD_WARPS * f;
            if (tile >= L_TILES || tile / L_CHUNK_TILES != i) continue;
            const int local = tile % L_CHUNK_TILES, mt = local / 4, nt = local % 4;
            for (int tt = 0; tt < T / 16; ++tt) {
              const unsigned char* rw = regions + tt * WR_BYTES + WR_S;
              FragAcm a;
              FragB bb;
              if (mt < 6) {
                wmma::load_matrix_sync(a, reinterpret_cast<const bf16*>(rw) + mt * 16, LQ_LD);
                wmma::load_matrix_sync(bb, xs + tt * 16 * XS_LD + nt * 16, XS_LD);
              } else {
                wmma::load_matrix_sync(a, reinterpret_cast<const bf16*>(rw + WR_P) + (mt - 6) * 16,
                                       LA_LD);
                wmma::load_matrix_sync(bb, gs + tt * 16 * XS_LD + nt * 16, XS_LD);
              }
              wmma::mma_sync(wacc[f], a, bb, wacc[f]);
            }
          }
          __syncthreads();  // the chunks are read
        }
      }
    }
  }

  {  // this (type, head)'s weight-grad partial
    const int n_types = gridDim.x / g.heads;
#pragma unroll
    for (int f = 0; f < L_PER_WARP; ++f) {
      const int tile = warp + BWD_WARPS * f;
      if (tile >= L_TILES) continue;
      const int i = tile / L_CHUNK_TILES, local = tile % L_CHUNK_TILES;
      const int mt = local / 4, col0 = i * KC + (local % 4) * 16;
      if (mt < 6) {  // dWqkv rows seg C + head D + j0.., (3C, C) row-major
        const int seg = mt / 2, j0 = (mt % 2) * 16;
        float* p = wgrad_part + (long long)type * 3 * LC * LC +
                   (long long)(seg * LC + head * D + j0) * LC + col0;
        wmma::store_matrix_sync(p, wacc[f], LC, wmma::mem_row_major);
      } else {  // dWproj (C_out, C_in): tile (in head D + m, out col0 + n)
        float* p = wgrad_part + (long long)n_types * 3 * LC * LC + (long long)type * LC * LC +
                   (long long)col0 * LC + head * D + (mt - 6) * 16;
        wmma::store_matrix_sync(p, wacc[f], LC, wmma::mem_col_major);
      }
    }
  }

  // ---- dbqkv partial of this (type, head): the warps' column sums, in order
  float* red = reinterpret_cast<float*>(regions);
  for (int seg = 0; seg < 3; ++seg) red[warp * 3 * D + seg * D + lane] = bsum[seg];
  __syncthreads();
  if (threadIdx.x < 3 * D) {
    float s = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w) s += red[w * 3 * D + threadIdx.x];
    const int seg = threadIdx.x / D, j = threadIdx.x - seg * D;
    dbqkv_part[(long long)type * 3 * C + seg * C + head * D + j] = s;
  }
}

}  // namespace

extern "C" {

// f32 elements of scratch that pangu_attn_bwd_local needs.
long long pangu_attn_bwd_local_scratch(int C, int n_types) {
  const long long sums = (long long)COLSUM_BLOCKS * C > (long long)n_types * 3 * C
                             ? (long long)COLSUM_BLOCKS * C
                             : (long long)n_types * 3 * C;
  return (long long)n_types * 4 * C * C + sums;
}

// local_accum on `stream`, from gy = dL/dy: dx (rows, C) bf16; dwqkv (3C, C),
// dbqkv (3C), dwproj (C, C), dbproj (C), dbias (n_types, heads, T, T) f32.
// dqkv_buf (rows, 3C) is bf16 scratch, scratch has pangu_attn_bwd_local_scratch
// floats. C 192, head dim 32, 144-token windows, rows a multiple of 64, else
// cudaErrorInvalidValue.
int pangu_attn_bwd_local(const void* x, const void* gy, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bias, void* dqkv_buf, void* scratch,
                         void* dx, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                         void* dbias, int B, int Z, int Hp, int W, int C, int heads, int wz,
                         int wh, int ww, float scale, void* stream) {
  const long long rows = (long long)B * Z * Hp * W;
  if (C != LC || C != heads * D || wz * wh * ww != T || B < 1 || Z % wz || Hp % wh || W % ww ||
      rows % ROW_TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const int n_types = (Z / wz) * (Hp / wh);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gy);
  bf16* dq = static_cast<bf16*>(dqkv_buf);
  float* wpart = static_cast<float*>(scratch);
  float* sums = wpart + (long long)n_types * 4 * C * C;

  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<<<(unsigned)(n_types * heads), BWD_THREADS, BWD_SMEM, s>>>(
      xb, gb, static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
      static_cast<const bf16*>(wproj), static_cast<const float*>(bias), nullptr, dq,
      static_cast<float*>(dbias), sums, g, scale, wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = reduce_partials(sums, n_types, 3LL * C, nullptr, static_cast<float*>(dbqkv), s)) !=
          cudaSuccess ||
      (err = reduce_partials(wpart, n_types, 3LL * C * C, nullptr, static_cast<float*>(dwqkv),
                             s)) != cudaSuccess ||
      (err = reduce_partials(wpart + (long long)n_types * 3 * C * C, n_types, (long long)C * C,
                             nullptr, static_cast<float*>(dwproj), s)) != cudaSuccess)
    return (int)err;
  // dx = dqkv @ Wqkv, as K3: Wqkv (3C, C) is the (k, n) operand as it lies
  if ((err = gemm<true, true>(dq, 3 * C, static_cast<const bf16*>(wqkv), C, (int)rows, C, 3 * C,
                              1, nullptr, static_cast<bf16*>(dx), nullptr, s)) != cudaSuccess)
    return (int)err;
  // dbproj = the f32 column sums of g
  const long long rpb = (rows + COLSUM_BLOCKS - 1) / COLSUM_BLOCKS;
  colsum_kernel<<<COLSUM_BLOCKS, 128, 0, s>>>(gb, rows, C, rpb, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce_partials(sums, COLSUM_BLOCKS, C, nullptr, static_cast<float*>(dbproj), s);
}

}  // extern "C"
