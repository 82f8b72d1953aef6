// The flash backward of the windowed attention, one CTA per (window type,
// head) looping over the batch and the lon windows of its type:
// attention_bwd_regs_kernel, K3's attention kernel (block_attention.cu, where
// the design is described): scores, probabilities and dP live in mma.sync
// registers, dbias accumulates on chip across the CTA's windows and is
// written once, and the column sums of g (dbproj) are folded in. K12
// (fused_block_train.cu) runs it too, from its LayerNorm-1 gradient; S2's
// `local_accum` (bench_attn_bwd_ab.cu) runs a copy with on-chip weight sums.

#pragma once

#include "window_attention.cuh"

namespace {

// ---- attention backward --------------------------------------------------------
constexpr int BWD_WARPS = T / 16;
constexpr int BWD_THREADS = BWD_WARPS * 32;  // 288
constexpr int DO_LD = D + 8;
constexpr int DO_BYTES = T * DO_LD * 2;      // 11,520 B
constexpr int WP_LD = D + 8;                 // staged (KC, 32) chunk of Wproj rows

// ---- K3: the attention backward with register-resident scores ------------------
constexpr int K3_KC = 32;                         // x and g channels per recompute stage
constexpr int K3_XS_LD = K3_KC + 8;
constexpr int K3_WT_LD = K3_KC + 8;               // staged (96, K3_KC) chunk of Wqkv rows
constexpr int K3_XS = T * K3_XS_LD;               // per stage: x chunk, g chunk, Wqkv, Wproj
constexpr int K3_STAGE_ELEMS = 2 * K3_XS + 3 * D * K3_WT_LD + K3_KC * WP_LD;
constexpr int PS_LD = T + 8;                      // bf16 rows of P and of dS
constexpr int PS_BYTES = T * PS_LD * 2;           // 43,776 B each
constexpr int K3_PS = QKV_BYTES + DO_BYTES;       // P, then dS
constexpr int K3_DBIAS = K3_PS + 2 * PS_BYTES;    // the CTA's dbias tile, f32, fragment order
constexpr int K3_RED = K3_DBIAS + T * T * 4;      // cross-warp sums at the end
constexpr int K3_SMEM = K3_RED + BWD_WARPS * 3 * D * 4;
static_assert(K3_SMEM <= 232448, "fits one CTA's shared memory");
static_assert(2 * K3_STAGE_ELEMS * 2 <= 2 * PS_BYTES, "two stages fit the P and dS rows");
static_assert(BWD_WARPS * 16 * 4 * D * 4 <= 2 * PS_BYTES, "the q|k|v|dO f32 rows fit too");
static_assert(K3_KC == D, "one recompute stage holds one head's channels of g");
static_assert((K3_XS * 2) % 32 == 0 && (3 * D * K3_WT_LD * 2) % 32 == 0 &&
                  (K3_STAGE_ELEMS * 2) % 32 == 0 && K3_PS % 32 == 0,
              "wmma needs 256-bit aligned tiles");

// K3's attention backward for CTA (type, head): per window, the head's q|k|v
// and dO = g @ Wproj[:, head] recomputed with wmma (K3_KC channels a stage),
// then warp w's 16 query rows in registers: S = q k^T, p = softmax(S scale +
// bias (+ mask)) in f32, O = P v (P = bf16(p)) -> the acc slab, D = rowsum(dO
// O), and per 16-key block dP = dO v^T, dS = p (dP - D) added to the dbias
// tile in shared memory, dq += bf16(dS) k; P and dS (bf16) go to shared memory
// for warp w's key rows: dk = dS^T q, dv = P^T dO. dq, dk (both times scale)
// and dv go to the dqkv slab; O goes to the acc slab where ACC_OUT (K3; K12
// has the attention output from its forward recompute). At the end: dbias
// (written once), the dbqkv
// partial of (type, head) and its 32 columns of the dbproj partial of `type`
// (the column sums of g over the type's windows).
template <bool ACC_OUT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attention_bwd_regs_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                          const bf16* __restrict__ wproj, const float* __restrict__ bias,
                          const float* __restrict__ mask, bf16* __restrict__ dqkv,
                          bf16* __restrict__ acc_out, float* __restrict__ dbias,
                          float* __restrict__ dbqkv_part, float* __restrict__ dbproj_part,
                          Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem);
  bf16* dO = reinterpret_cast<bf16*>(smem + QKV_BYTES);
  bf16* Ps = reinterpret_cast<bf16*>(smem + K3_PS);
  bf16* dSs = reinterpret_cast<bf16*>(smem + K3_PS + PS_BYTES);
  float4* dbs = reinterpret_cast<float4*>(smem + K3_DBIAS);
  float* red = reinterpret_cast<float*>(smem + K3_RED);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int hn = g.Hp / g.wh, wn = g.W / g.ww;
  const int head = blockIdx.x % g.heads;
  const int type = blockIdx.x / g.heads;
  const int zi = type / hn, hi = type - zi * hn;
  const int C = g.C;
  const int q0 = warp * 16;
  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T;
  const float* mask_rows = mask ? mask + ((long long)type * T + q0) * T : nullptr;
  float bsum[3][4][2] = {};  // dbqkv partials: the thread's columns 8 n + 2 tq + e, its rows
  float gsum = 0.f;          // dbproj partial: column lane of the head, rows 16 warp ..

  for (int b = 0; b < g.B; ++b) {
    for (int wi = 0; wi < wn; ++wi) {
      // ---- q|k|v (x @ Wqkv rows of the head) and dO (g @ Wproj columns) of the
      // warp's 16 rows, K3_KC channels per stage; stage `head` holds the head's
      // channels of g: their column sums go to gsum
      FragC acc[8];  // 0-5: q|k|v columns, 6-7: dO columns
      for (int n = 0; n < 8; ++n) wmma::fill_fragment(acc[n], 0.f);
      bf16* stage0 = Ps;
      pipelined(
          C / K3_KC, stage0, stage0 + K3_STAGE_ELEMS,
          [&](int i, bf16* st) {
            const int k0 = i * K3_KC;
            for (int v = threadIdx.x; v < T * (K3_KC / 8); v += BWD_THREADS) {
              const int t = v / (K3_KC / 8), cv = v - t * (K3_KC / 8);
              const long long row = token_row(g, b, zi, hi, wi, t) * C + k0 + cv * 8;
              cp_async16(st + t * K3_XS_LD + cv * 8, x + row);
              cp_async16(st + K3_XS + t * K3_XS_LD + cv * 8, gy + row);
            }
            for (int v = threadIdx.x; v < 3 * D * (K3_KC / 8); v += BWD_THREADS) {
              const int r = v / (K3_KC / 8), cv = v - r * (K3_KC / 8);
              const int seg = r / D, j = r - seg * D;
              cp_async16(st + 2 * K3_XS + r * K3_WT_LD + cv * 8,
                         wqkv + (long long)(seg * C + head * D + j) * C + k0 + cv * 8);
            }
            for (int v = threadIdx.x; v < K3_KC * (D / 8); v += BWD_THREADS) {
              const int r = v / (D / 8), cv = v - r * (D / 8);
              cp_async16(st + 2 * K3_XS + 3 * D * K3_WT_LD + r * WP_LD + cv * 8,
                         wproj + (long long)(k0 + r) * C + head * D + cv * 8);
            }
          },
          [&](int i, bf16* st) {
            for (int kk = 0; kk < K3_KC; kk += 16) {
              FragA a, ga;
              wmma::load_matrix_sync(a, st + q0 * K3_XS_LD + kk, K3_XS_LD);
              for (int n = 0; n < 6; ++n) {
                FragBt w;
                wmma::load_matrix_sync(w, st + 2 * K3_XS + n * 16 * K3_WT_LD + kk, K3_WT_LD);
                wmma::mma_sync(acc[n], a, w, acc[n]);
              }
              wmma::load_matrix_sync(ga, st + K3_XS + q0 * K3_XS_LD + kk, K3_XS_LD);
              for (int n = 6; n < 8; ++n) {
                FragB w;
                wmma::load_matrix_sync(
                    w, st + 2 * K3_XS + 3 * D * K3_WT_LD + kk * WP_LD + (n - 6) * 16, WP_LD);
                wmma::mma_sync(acc[n], ga, w, acc[n]);
              }
            }
            if (i == head) {
              const bf16* gc = st + K3_XS + q0 * K3_XS_LD + lane;
              for (int r = 0; r < 16; ++r) gsum += __bfloat162float(gc[r * K3_XS_LD]);
            }
          });
      {  // the stages are dead: each warp stages its f32 rows over them
        float* S = reinterpret_cast<float*>(smem + K3_PS) + warp * 16 * 4 * D;
        for (int n = 0; n < 8; ++n)
          wmma::store_matrix_sync(S + n * 16, acc[n], 4 * D, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 4 * D; e += 32) {
          const int r = e / (4 * D), cidx = e - r * (4 * D);
          if (cidx < 3 * D) {
            const int seg = cidx / D, j = cidx - seg * D;
            qkv[(q0 + r) * QKV_LD + cidx] =
                __float2bfloat16(S[e] + __bfloat162float(bqkv[seg * C + head * D + j]));
          } else {
            dO[(q0 + r) * DO_LD + cidx - 3 * D] = __float2bfloat16(S[e]);
          }
        }
      }
      __syncthreads();  // q|k|v and dO of every row are in place

      // ---- S = q k^T (16 x 144 of the warp), f32 softmax in registers
      float s[T / 8][4];
      {
        uint32_t qa[2][4];
        for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], afrag_at(qkv, QKV_LD, q0, 16 * kk, lane));
#pragma unroll
        for (int nb = 0; nb < T / 16; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * nb][e] = s[2 * nb + 1][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t kb[4];
            ldsm_x4(kb, bfrag_nk(qkv, QKV_LD, 16 * nb, D + 16 * kk, lane));
            mma_bf16(s[2 * nb], qa[kk], kb[0], kb[1]);
            mma_bf16(s[2 * nb + 1], qa[kk], kb[2], kb[3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows gq and gq + 8
        const float* brow = bias_rows + (gq + 8 * h) * T + 2 * tq;
        const float* mrow = mask_rows ? mask_rows + (gq + 8 * h) * T + 2 * tq : nullptr;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(brow + 8 * j));
          s[j][2 * h] = s[j][2 * h] * scale + bv.x;
          s[j][2 * h + 1] = s[j][2 * h + 1] * scale + bv.y;
          if (mrow) {
            const float2 mv = __ldg(reinterpret_cast<const float2*>(mrow + 8 * j));
            s[j][2 * h] += mv.x;
            s[j][2 * h + 1] += mv.y;
          }
          m = fmaxf(m, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          s[j][2 * h] = expf(s[j][2 * h] - m);
          s[j][2 * h + 1] = expf(s[j][2 * h + 1] - m);
          sum += s[j][2 * h] + s[j][2 * h + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        bf16* prow = Ps + (q0 + gq + 8 * h) * PS_LD + 2 * tq;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          s[j][2 * h] /= sum;
          s[j][2 * h + 1] /= sum;
          *reinterpret_cast<uint32_t*>(prow + 8 * j) = pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
        }
      }

      // ---- O = P v (P the bf16 probabilities, from the score registers) -> the
      // acc slab; D = rowsum(dO O) in f32
      float Dr[2];
      {
        float o[4][4] = {};
#pragma unroll
        for (int kb = 0; kb < T / 16; ++kb) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                                  pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                                  pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                                  pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
          for (int dn = 0; dn < 2; ++dn) {
            uint32_t vb[4];
            ldsm_x4_t(vb, bfrag_kn(qkv, QKV_LD, 16 * kb, 2 * D + 16 * dn, lane));
            mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
            mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = q0 + gq + 8 * h;
          const long long at = token_row(g, b, zi, hi, wi, r) * C + head * D + 2 * tq;
          const bf16* drow = dO + r * DO_LD + 2 * tq;
          float d = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (ACC_OUT)
              *reinterpret_cast<uint32_t*>(acc_out + at + 8 * n) =
                  pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
            const float2 dv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + 8 * n));
            d += dv.x * o[n][2 * h] + dv.y * o[n][2 * h + 1];
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          Dr[h] = d;
        }
      }

      // ---- per 16-key block: dP = dO v^T, dS = p (dP - D) -> dbias (f32, on
      // chip) and bf16 dS rows; dq += dS k
      float dq[4][4] = {};
      {
        const bool first = (b == 0 && wi == 0);
        uint32_t da[2][4];
        for (int kk = 0; kk < 2; ++kk) ldsm_x4(da[kk], afrag_at(dO, DO_LD, q0, 16 * kk, lane));
#pragma unroll
        for (int nb = 0; nb < T / 16; ++nb) {
          float dp[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t vb[4];
            ldsm_x4(vb, bfrag_nk(qkv, QKV_LD, 16 * nb, 2 * D + 16 * kk, lane));
            mma_bf16(dp[0], da[kk], vb[0], vb[1]);
            mma_bf16(dp[1], da[kk], vb[2], vb[3]);
          }
          uint32_t sa[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * nb + jj;
            float4 ds;
            ds.x = s[j][0] * (dp[jj][0] - Dr[0]);
            ds.y = s[j][1] * (dp[jj][1] - Dr[0]);
            ds.z = s[j][2] * (dp[jj][2] - Dr[1]);
            ds.w = s[j][3] * (dp[jj][3] - Dr[1]);
            float4* slot = dbs + (warp * (T / 8) + j) * 32 + lane;
            if (first) {
              *slot = ds;
            } else {
              const float4 o = *slot;
              *slot = make_float4(o.x + ds.x, o.y + ds.y, o.z + ds.z, o.w + ds.w);
            }
            sa[2 * jj] = pack_bf16(ds.x, ds.y);
            sa[2 * jj + 1] = pack_bf16(ds.z, ds.w);
            bf16* drow = dSs + (q0 + gq) * PS_LD + 8 * j + 2 * tq;
            *reinterpret_cast<uint32_t*>(drow) = sa[2 * jj];
            *reinterpret_cast<uint32_t*>(drow + 8 * PS_LD) = sa[2 * jj + 1];
          }
          const uint32_t dsa[4] = {sa[0], sa[1], sa[2], sa[3]};
#pragma unroll
          for (int dn = 0; dn < 2; ++dn) {
            uint32_t kb[4];
            ldsm_x4_t(kb, bfrag_kn(qkv, QKV_LD, 16 * nb, D + 16 * dn, lane));
            mma_bf16(dq[2 * dn], dsa, kb[0], kb[1]);
            mma_bf16(dq[2 * dn + 1], dsa, kb[2], kb[3]);
          }
        }
      }
      __syncthreads();  // every warp's P and dS rows are in shared memory

      // ---- warp w's key rows (the same 16 tokens): dk = dS^T q, dv = P^T dO
      float dk[4][4] = {}, dv[4][4] = {};
#pragma unroll
      for (int qb = 0; qb < T / 16; ++qb) {
        uint32_t pa[4], sa[4];
        ldsm_x4_t(pa, atfrag_at(Ps, PS_LD, 16 * qb, q0, lane));
        ldsm_x4_t(sa, atfrag_at(dSs, PS_LD, 16 * qb, q0, lane));
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {
          uint32_t ob[4], qb4[4];
          ldsm_x4_t(ob, bfrag_kn(dO, DO_LD, 16 * qb, 16 * dn, lane));
          mma_bf16(dv[2 * dn], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * dn + 1], pa, ob[2], ob[3]);
          ldsm_x4_t(qb4, bfrag_kn(qkv, QKV_LD, 16 * qb, 16 * dn, lane));
          mma_bf16(dk[2 * dn], sa, qb4[0], qb4[1]);
          mma_bf16(dk[2 * dn + 1], sa, qb4[2], qb4[3]);
        }
      }
      // ---- dq, dk (times scale) and dv to the dqkv slab; their column sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* row = dqkv + token_row(g, b, zi, hi, wi, q0 + gq + 8 * h) * 3 * C + head * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float v[3][2] = {{dq[n][2 * h] * scale, dq[n][2 * h + 1] * scale},
                                 {dk[n][2 * h] * scale, dk[n][2 * h + 1] * scale},
                                 {dv[n][2 * h], dv[n][2 * h + 1]}};
#pragma unroll
          for (int seg = 0; seg < 3; ++seg) {
            *reinterpret_cast<uint32_t*>(row + seg * C + 8 * n) = pack_bf16(v[seg][0], v[seg][1]);
            bsum[seg][n][0] += v[seg][0];
            bsum[seg][n][1] += v[seg][1];
          }
        }
      }
      __syncthreads();  // qkv, dO, P and dS are read: the next window stages over them
    }
  }

  // ---- dbias of (type, head), written once (f32, from the fragment order)
  {
    float* drow = dbias + ((long long)(type * g.heads + head) * T + q0 + gq) * T + 2 * tq;
    for (int j = 0; j < T / 8; ++j) {
      const float4 v = dbs[(warp * (T / 8) + j) * 32 + lane];
      *reinterpret_cast<float2*>(drow + 8 * j) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(drow + 8 * T + 8 * j) = make_float2(v.z, v.w);
    }
  }
  // ---- dbqkv partial of (type, head) and dbproj partial columns: the warps'
  // sums, rows and warps in a fixed order
#pragma unroll
  for (int seg = 0; seg < 3; ++seg)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = bsum[seg][n][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) red[warp * 3 * D + seg * D + 8 * n + 2 * tq + e] = v;
      }
  __syncthreads();
  if (threadIdx.x < 3 * D) {
    float v = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w) v += red[w * 3 * D + threadIdx.x];
    const int seg = threadIdx.x / D, j = threadIdx.x - seg * D;
    dbqkv_part[(long long)type * 3 * C + seg * C + head * D + j] = v;
  }
  __syncthreads();
  red[warp * 32 + lane] = gsum;
  __syncthreads();
  if (threadIdx.x < D) {
    float v = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w) v += red[w * 32 + threadIdx.x];
    dbproj_part[(long long)type * C + head * D + threadIdx.x] = v;
  }
}

}  // namespace
