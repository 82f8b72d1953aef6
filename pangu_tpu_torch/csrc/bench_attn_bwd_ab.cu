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
// wgmma products over all rows. The Pallas variant instead carries the weight
// grads across the windows of its program. local_accum_kernel (below) is
// K3's attention kernel (attention_bwd.cuh::attention_bwd_regs_kernel, one CTA
// per (window type, head), S, P and dP in mma.sync registers, the q|k|v and dO
// recompute on wmma) with one addition: after each window it adds
//
//   dWqkv_h += (dq_h|dk_h|dv_h)^T x     (96 x C)
//   dWproj[:, h]^T += acc_h^T g          (32 x C)
//
// an M = 128, N = 192, K = 144 product on mma.sync m16n8k16, A = the bf16
// dq|dk|dv and acc rows by ldmatrix.trans, B = x and g streamed again from
// the L2 in 64-channel chunks (two stages over the dead P and dS tiles); warp
// w < 8 owns rows 16 w.. of the slice. The slice's f32 sums (98,304 B) live in
// shared memory in fragment order (one float4 a lane per 16 x 8 tile, loaded
// into registers for a chunk's nine k-steps and stored back). That space is
// K3's dbias tile (82,944 B), which moves out: each CTA adds its window's dS
// to its own (type, head) dbias tile in device memory (one writer, in window
// order; the L2 holds the tiles of the CTAs in flight). The weight sums of
// the 168-register CTA cannot take registers (85 f32 a thread over K3's 168),
// and the whole K3 layout leaves 17 KB of shared memory.
//
// Each CTA writes one partial per (type, head): its dWqkv rows and dWproj
// columns, its dbqkv columns and its 32 dbproj columns (the column sums of g,
// folded into the recompute as in K3); reduce_partials sums the 124 type
// partials in a fixed order (no atomics: the same bits on every run). dx =
// dqkv @ Wqkv is K3's wgmma product.
//
// What bounds it on an H100: K3's products (22 rows C^2 + 12 rows 144 C FLOP):
// operations. The on-chip weight sums trade K3's two deep products and its
// acc-slab read for the same FLOP in 16-row mma.sync tiles, x and g read a
// second time from the L2 and the dbias tile's read and write per window
// (83 KB each, from the L2); the partials are 73 MB of f32.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_attn_bwd_ab.py; the plain PyTorch version is
// fused_block_attention_bwd_reference(..., round_grads=False) of
// pangu_tpu_torch/ops/fused_block_attention.py.

#include "attention_bwd.cuh"
#include "gemm.cuh"

namespace {

constexpr int LC = 192;                           // channels (the outer stage)
constexpr int LW_M = 4 * D / 16;                  // 8 m16 tiles: dq|dk|dv, then acc
constexpr int LW_N = LC / 8;                      // 24 n8 tiles of channels
constexpr int LKC = 64;                           // channels of a streamed x and g chunk
constexpr int LXS_LD = LKC + 8;
constexpr int L_STAGE_ELEMS = 2 * T * LXS_LD;     // x chunk, g chunk: 41,472 B
constexpr int L_WACC = K3_PS + 2 * PS_BYTES;      // the weight sums, where K3 keeps dbias
constexpr int L_RED = L_WACC + LW_M * LW_N * 32 * 16;  // + 98,304 B
constexpr int L_SMEM = L_RED + BWD_WARPS * 3 * D * 4;  // 230,784 B
static_assert(L_SMEM <= 232448, "fits one CTA's shared memory");
static_assert(2 * L_STAGE_ELEMS * 2 <= 2 * PS_BYTES, "two chunks fit the P and dS tiles");
static_assert(T * DO_LD * 2 == DO_BYTES, "the acc rows fit the dO tile");
static_assert(LW_M < BWD_WARPS, "a warp per m16 tile of the weight slice");

// K3's attention backward for CTA (type, head), as attention_bwd_regs_kernel<true>
// (the comments there), with dbias added to device memory per window and the
// weight grads of the window summed on chip after its dq|dk|dv. wgrad_part:
// n_types (3C, C) dWqkv partials, then n_types (C, C) dWproj partials
// (nn.Linear layouts); each (type, head) writes its rows / columns.
__global__ void __launch_bounds__(BWD_THREADS, 1)
local_accum_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                   const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                   const bf16* __restrict__ wproj, const float* __restrict__ bias,
                   bf16* __restrict__ dqkv, bf16* __restrict__ acc_out,
                   float* __restrict__ dbias, float* __restrict__ dbqkv_part,
                   float* __restrict__ dbproj_part, float* __restrict__ wgrad_part, Geom g,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem);
  bf16* dO = reinterpret_cast<bf16*>(smem + QKV_BYTES);
  bf16* Ps = reinterpret_cast<bf16*>(smem + K3_PS);
  bf16* dSs = reinterpret_cast<bf16*>(smem + K3_PS + PS_BYTES);
  float4* wacc = reinterpret_cast<float4*>(smem + L_WACC);
  float* red = reinterpret_cast<float*>(smem + L_RED);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int hn = g.Hp / g.wh, wn = g.W / g.ww;
  const int head = blockIdx.x % g.heads;
  const int type = blockIdx.x / g.heads;
  const int zi = type / hn, hi = type - zi * hn;
  constexpr int C = LC;
  const int q0 = warp * 16;
  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T;
  float* dbias_rows = dbias + ((long long)(type * g.heads + head) * T + q0 + gq) * T + 2 * tq;
  float bsum[3][4][2] = {};  // dbqkv partials: the thread's columns 8 n + 2 tq + e, its rows
  float gsum = 0.f;          // dbproj partial: column lane of the head, rows 16 warp ..
  for (int i = threadIdx.x; i < LW_M * LW_N * 32; i += BWD_THREADS)
    wacc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int b = 0; b < g.B; ++b) {
    for (int wi = 0; wi < wn; ++wi) {
      // ---- q|k|v and dO of the warp's 16 rows (K3's recompute)
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
      {
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
      __syncthreads();

      // ---- S = q k^T, the f32 softmax in registers; bf16 P rows to shared memory
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
      for (int h = 0; h < 2; ++h) {
        const float* brow = bias_rows + (gq + 8 * h) * T + 2 * tq;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(brow + 8 * j));
          s[j][2 * h] = s[j][2 * h] * scale + bv.x;
          s[j][2 * h + 1] = s[j][2 * h + 1] * scale + bv.y;
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

      // ---- O = P v -> the acc slab; D = rowsum(dO O) in f32
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

      // ---- per 16-key block: dP = dO v^T, dS = p (dP - D) -> dbias (f32, the
      // CTA's tile in device memory) and bf16 dS rows; dq += dS k
      float dq[4][4] = {};
      {
        const bool first = (b == 0 && wi == 0);
        uint32_t da[2][4];
        for (int kk = 0; kk < 2; ++kk) ldsm_x4(da[kk], afrag_at(dO, DO_LD, q0, 16 * kk, lane));
#pragma unroll
        for (int nb = 0; nb < T / 16; ++nb) {
          float2 old[2][2];
          if (!first)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                old[jj][h] = __ldcg(reinterpret_cast<const float2*>(
                    dbias_rows + 8 * h * T + 8 * (2 * nb + jj)));
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
            float2 lo = make_float2(ds.x, ds.y), hi2 = make_float2(ds.z, ds.w);
            if (!first) {
              lo.x += old[jj][0].x, lo.y += old[jj][0].y;
              hi2.x += old[jj][1].x, hi2.y += old[jj][1].y;
            }
            __stcg(reinterpret_cast<float2*>(dbias_rows + 8 * j), lo);
            __stcg(reinterpret_cast<float2*>(dbias_rows + 8 * T + 8 * j), hi2);
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

      // ---- warp w's key rows: dk = dS^T q, dv = P^T dO
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
      __syncthreads();  // qkv, dO, P and dS are read

      // ---- the weight-sum chunks: x and g, 64 channels each, into the dead
      // P and dS tiles; the window's acc rows back from the slab into the dO tile
      auto load_chunk = [&](int i) {
        bf16* st = Ps + (i & 1) * L_STAGE_ELEMS;
        for (int v = threadIdx.x; v < T * (LKC / 8); v += BWD_THREADS) {
          const int t = v / (LKC / 8), cv = (v - t * (LKC / 8)) * 8;
          const long long at = token_row(g, b, zi, hi, wi, t) * C + i * LKC + cv;
          cp_async16(st + t * LXS_LD + cv, x + at);
          cp_async16(st + T * LXS_LD + t * LXS_LD + cv, gy + at);
        }
      };
      for (int v = threadIdx.x; v < T * (D / 8); v += BWD_THREADS) {
        const int t = v / (D / 8), cv = (v - t * (D / 8)) * 8;
        cp_async16(dO + t * DO_LD + cv,
                   acc_out + token_row(g, b, zi, hi, wi, t) * C + head * D + cv);
      }
      load_chunk(0);
      cp_async_commit();
      load_chunk(1);
      cp_async_commit();
      // ---- dq, dk (times scale) and dv: the dqkv slab, the qkv tile (bf16, the
      // A rows of the weight sums) and their column sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + gq + 8 * h;
        bf16* row = dqkv + token_row(g, b, zi, hi, wi, r) * 3 * C + head * D + 2 * tq;
        bf16* trow = qkv + r * QKV_LD + 2 * tq;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float v[3][2] = {{dq[n][2 * h] * scale, dq[n][2 * h + 1] * scale},
                                 {dk[n][2 * h] * scale, dk[n][2 * h + 1] * scale},
                                 {dv[n][2 * h], dv[n][2 * h + 1]}};
#pragma unroll
          for (int seg = 0; seg < 3; ++seg) {
            const uint32_t pk = pack_bf16(v[seg][0], v[seg][1]);
            *reinterpret_cast<uint32_t*>(row + seg * C + 8 * n) = pk;
            *reinterpret_cast<uint32_t*>(trow + seg * D + 8 * n) = pk;
            bsum[seg][n][0] += v[seg][0];
            bsum[seg][n][1] += v[seg][1];
          }
        }
      }
      // ---- dWqkv_h / dWproj_h^T += (dq|dk|dv|acc)^T (x|g): warp w < 8 owns
      // rows 16 w.. of the (128, C) slice; 8 n8 tiles of the chunk a warp
      const int mt = warp;
      const bf16* arows = mt < 6 ? qkv + 16 * mt : dO + 16 * (mt - 6);
      const int ald = mt < 6 ? QKV_LD : DO_LD;
      for (int i = 0; i < LC / LKC; ++i) {
        if (i + 1 < LC / LKC)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();  // chunk i and every warp's rows are in place
        if (mt < LW_M) {
          const bf16* brows = Ps + (i & 1) * L_STAGE_ELEMS + (mt < 6 ? 0 : T * LXS_LD);
          float4* tile = wacc + (mt * LW_N + i * (LKC / 8)) * 32 + lane;
          float c[LKC / 8][4];
#pragma unroll
          for (int n = 0; n < LKC / 8; ++n) {
            const float4 v = tile[n * 32];
            c[n][0] = v.x, c[n][1] = v.y, c[n][2] = v.z, c[n][3] = v.w;
          }
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4_t(a, atfrag_at(arows, ald, 16 * kk, 0, lane));
#pragma unroll
            for (int np = 0; np < LKC / 16; ++np) {
              uint32_t bb[4];
              ldsm_x4_t(bb, bfrag_kn(brows, LXS_LD, 16 * kk, 16 * np, lane));
              mma_bf16(c[2 * np], a, bb[0], bb[1]);
              mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
            }
          }
#pragma unroll
          for (int n = 0; n < LKC / 8; ++n)
            tile[n * 32] = make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
        }
        __syncthreads();  // the chunk is read: chunk i + 2 takes its stage
        if (i + 2 < LC / LKC) {
          load_chunk(i + 2);
          cp_async_commit();
        }
      }
    }
  }

  // ---- the weight-grad partial of (type, head): warp w < 8's rows of the
  // slice, from the fragment order
  if (warp < LW_M) {
    const int n_types = gridDim.x / g.heads;
#pragma unroll 1
    for (int n = 0; n < LW_N; ++n) {
      const float4 v = wacc[(warp * LW_N + n) * 32 + lane];
      const int col = 8 * n + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + gq + 8 * h;
        const float e0 = h ? v.z : v.x, e1 = h ? v.w : v.y;
        if (r < 3 * D) {  // dWqkv row seg C + head D + j, (3C, C) row-major
          const int seg = r / D, j = r - seg * D;
          *reinterpret_cast<float2*>(wgrad_part + (long long)type * 3 * C * C +
                                     (long long)(seg * C + head * D + j) * C + col) =
              make_float2(e0, e1);
        } else {  // dWproj (C_out, C_in): (out col, in head D + j)
          float* p = wgrad_part + (long long)n_types * 3 * C * C + (long long)type * C * C +
                     (long long)col * C + head * D + r - 3 * D;
          p[0] = e0;
          p[C] = e1;
        }
      }
    }
  }
  // ---- dbqkv partial of (type, head) and dbproj partial columns (as K3)
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

extern "C" {

// f32 elements of scratch that pangu_attn_bwd_local needs.
long long pangu_attn_bwd_local_scratch(int C, int n_types) {
  return (long long)n_types * 4 * C * C + (long long)n_types * 4 * C;
}

// local_accum on `stream`, from gy = dL/dy: dx (rows, C) bf16; dwqkv (3C, C),
// dbqkv (3C), dwproj (C, C), dbproj (C), dbias (n_types, heads, T, T) f32.
// dqkv_buf (rows, 3C) and acc_buf (rows, C) are bf16 scratch, scratch has
// pangu_attn_bwd_local_scratch floats. C 192, head dim 32, 144-token windows,
// rows a multiple of 64, else cudaErrorInvalidValue.
int pangu_attn_bwd_local(const void* x, const void* gy, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bias, void* dqkv_buf, void* acc_buf,
                         void* scratch, void* dx, void* dwqkv, void* dbqkv, void* dwproj,
                         void* dbproj, void* dbias, int B, int Z, int Hp, int W, int C,
                         int heads, int wz, int wh, int ww, float scale, void* stream) {
  const long long rows = (long long)B * Z * Hp * W;
  if (C != LC || C != heads * D || wz * wh * ww != T || B < 1 || Z % wz || Hp % wh || W % ww ||
      rows % ROW_TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const int n_types = (Z / wz) * (Hp / wh);
  float* wpart = static_cast<float*>(scratch);
  float* bpart = wpart + (long long)n_types * 4 * C * C;  // dbqkv, then dbproj partials

  cudaError_t err = cudaFuncSetAttribute(local_accum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L_SMEM);
  if (err != cudaSuccess) return (int)err;
  local_accum_kernel<<<(unsigned)(n_types * heads), BWD_THREADS, L_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gy), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bias), static_cast<bf16*>(dqkv_buf),
      static_cast<bf16*>(acc_buf), static_cast<float*>(dbias), bpart,
      bpart + (long long)n_types * 3 * C, wpart, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = reduce_partials(bpart, n_types, 3LL * C, nullptr, static_cast<float*>(dbqkv), s)) !=
          cudaSuccess ||
      (err = reduce_partials(bpart + (long long)n_types * 3 * C, n_types, C, nullptr,
                             static_cast<float*>(dbproj), s)) != cudaSuccess ||
      (err = reduce_partials(wpart, n_types, 3LL * C * C, nullptr, static_cast<float*>(dwqkv),
                             s)) != cudaSuccess ||
      (err = reduce_partials(wpart + (long long)n_types * 3 * C * C, n_types, (long long)C * C,
                             nullptr, static_cast<float*>(dwproj), s)) != cudaSuccess)
    return (int)err;
  // dx = dqkv @ Wqkv, as K3: Wqkv (3C, C) is the (k, n) operand as it lies
  return (int)gemm<true, true>(static_cast<const bf16*>(dqkv_buf), 3 * C,
                               static_cast<const bf16*>(wqkv), C, (int)rows, C, 3 * C, 1, nullptr,
                               static_cast<bf16*>(dx), nullptr, s);
}

}  // extern "C"
