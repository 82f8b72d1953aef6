// Whole Earth-Specific block in training, bf16 -- CUDA for Hopper (sm_90a):
// the forward (K11) and its flash backward (K12).
//
// Replaces pangu_tpu/ops/fused_block_train.py::fused_earth_block_train (K11,
// the Pallas kernel _make_fwd_kernel) and its backward _backward_pallas (K12,
// _make_bwd_kernel). On the (rolled, window-padded) token grid x (B, Z, Hp, W, C),
// with s1, s2 one f32 per sample (the stochastic-depth branch scales):
//
//   a   = bf16(attn(x) @ Wproj^T + bproj)        attn as in K1 (window_attention.cuh)
//   x1  = bf16(x + s1 * LN1(a))
//   out = bf16(x1 + s2 * LN2(bf16(GELU(x1 @ W1^T + b1)) @ W2^T + b2))
//
// and, from g = dL/dout, the 16 gradients dx, dWqkv, dbqkv, dWproj, dbproj,
// dbias, dgamma1, dbeta1, dW1, db1, dW2, db2, dgamma2, dbeta2, ds1, ds2 with
// the rounding points of the Pallas backward body: q|k|v, the probabilities
// fed to P v and dv, a, x1, the GELU hidden, dy2, dh2, da, dO and dqkv are
// bf16 where they feed a product; p for dS, every LayerNorm statistic (E[y^2]
// - mu^2, eps 1e-5), dx1 and every sum stay f32; dx = bf16(dqkv Wqkv + dx1)
// is rounded once. Weights come in nn.Linear's (out, in) layout and their
// grads go back in it, rounded to bf16 as the Pallas wrapper rounds them to
// the argument dtype; dbias, the LayerNorm grads and ds1/ds2 are f32.
//
// Forward design (K11): K1's two kernels. window_attention_kernel (one CTA per
// (batch, window, head)) writes the bf16 attention output; mlp_tail_kernel
// <C, true, true, true> (mlp_wg.cuh, K1's token tail on wgmma and TMA) does the
// projection, LN1 with s1, the MLP streamed through shared memory in 64-column
// chunks of the hidden, LN2 with s2, per 64-row tile.
//
// Backward design (K12). The Pallas kernel recomputes the block per (z-window,
// h-window) slab in VMEM and carries twelve weight and LayerNorm grads, dbias
// and ds1/ds2 across its sequential grid. Hopper's CTAs run in no order, so:
//
//  1. window_attention_kernel recomputes the attention output acc (bf16 slab).
//  2. block_bwd_tail_kernel<C>, persistent over 48-row tiles (one CTA per SM):
//     on chip per tile it recomputes a (bf16), the LN1 statistics, x1 (bf16),
//     the MLP output y2 (f32) and LN2, forms dy2, runs the hidden pass of the
//     MLP backward (mlp_hidden_bwd_rows: h beside dy2 W2 per 64-column chunk,
//     dx1 accumulated in registers), then the LN1 backward (ds1, dgamma1,
//     dbeta1, da) and dO = bf16(da Wproj). It writes: dO (bf16, for the
//     attention backward); dy2, GELU(h) and dh (bf16, for dW2 and dx); ds1 and
//     ds2 per row; per-CTA f32 partials of dgamma1/2, dbeta1/2, db2, dbproj
//     (column passes, one thread per column) and db1. dW1 = dh^T x1 and dWproj
//     = da^T acc need x1 and da, which never leave the chip: each CTA adds its
//     tile's product to its own f32 partial of them in device memory (a
//     read-modify-write per tile, no atomics).
//  3. attention_bwd_kernel<true> (attention_bwd.cuh, K3's earlier schedule
//     given dO): per (window type, head), looping over the batch and the lon
//     windows, the dqkv slab, dbias (one writer per tile) and dbqkv partials.
//  4. gemm.cuh: dx = bf16(dqkv Wqkv + dh W1 + g) -- dx1 = g + dh W1 formed
//     again from the dh slab instead of being stored -- (wmma) and the wgmma
//     row-split products dWqkv = dqkv^T x and dW2 = dy2^T GELU(h).
//  5. every partial summed in a fixed order (reduce_partials; ds1 and ds2 per
//     sample by segment_sum_kernel): the same bits on every run.
//
// Never in device memory: a, x1, dx1 and da, the tensors the unfused chain
// (K2, K4, K6, K7, K5, K3) passes between its kernels.
//
// What bounds it on an H100: an outer-stage block is ~0.53 TFLOP forward and
// ~1.9 TFLOP backward (the forward recomputed, dO, four score-sized products,
// the MLP's three and the deep products) against a few GB of traffic: the
// tensor cores, fed here by wmma fragments from shared memory. The partials
// of dW1 and dWproj add 2 x 5 C^2 x 4 bytes of read-modify-write per 48-row
// tile (~13 GB per outer block): the first thing to cut in a later PR.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_train.py; the plain PyTorch versions are
// fused_earth_block_train_reference and fused_earth_block_train_bwd_reference.

#include "attention_bwd.cuh"
#include "mlp_tile.cuh"
#include "mlp_wg.cuh"
#include "gemm.cuh"

namespace {

template <int C>
struct BwdLayout : MlpTile<C> {
  using M = MlpTile<C>;
  static constexpr int STAGE = cmax(hidden_bwd_stage_bytes<C>(), M::STAGE_BYTES);
  // H, P, HB and two stages; f32 rows (C wide) over it between the products
  static constexpr int WORK = 2 * M::H_BYTES + M::HB_BYTES + 2 * STAGE;
  static constexpr int XB_OFF = 0;                  // x1
  static constexpr int AB_OFF = M::XB_BYTES;        // a, then da
  static constexpr int DB_OFF = 2 * M::XB_BYTES;    // acc, then dy2, then acc
  static constexpr int W_OFF = 3 * M::XB_BYTES;
  static constexpr int ST_OFF = W_OFF + WORK;       // 8 f32 statistics per row
  static constexpr int DB1_OFF = ST_OFF + TAIL_ROWS * 8 * 4;
  static constexpr int SMEM = DB1_OFF + 4 * C * 4;
  static_assert(STAGE % 32 == 0 && WORK % 32 == 0, "wmma needs 256-bit aligned tiles");
  static_assert(M::Y_BYTES <= WORK, "the f32 rows fit the work area");
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
};

// G (M x N f32, row stride ldg, device memory) = (first ? 0 : G) + A^T B over
// the TAIL_ROWS rows of A (TAIL_ROWS x M) and B (TAIL_ROWS x N), bf16 row-major
// in shared memory. Warp w takes the 16 x 16 tiles w, w + 12, ...
template <int M, int N>
__device__ __forceinline__ void accumulate_at_b(const bf16* A, int lda, const bf16* B, int ldb,
                                                float* G, int ldg, bool first) {
  using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  constexpr int TN = N / 16;
  for (int t = threadIdx.x >> 5; t < (M / 16) * TN; t += TAIL_WARPS) {
    const int tm = t / TN, tn = t - tm * TN;
    float* g = G + (long long)tm * 16 * ldg + tn * 16;
    FragC c;
    if (first)
      wmma::fill_fragment(c, 0.f);
    else
      wmma::load_matrix_sync(c, g, ldg, wmma::mem_row_major);
    for (int k = 0; k < TAIL_ROWS; k += 16) {
      FragAt a;  // A^T(m, k) = A[k * lda + m]
      FragB b;
      wmma::load_matrix_sync(a, A + k * lda + tm * 16, lda);
      wmma::load_matrix_sync(b, B + k * ldb + tn * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(g, c, ldg, wmma::mem_row_major);
  }
}

// Step 2 of K12 (see the top of the file), per 48-row tile of the flattened
// grid; a tile lies in one sample. col_part holds 6 x gridDim.x x C floats
// (dgamma1, dbeta1, dgamma2, dbeta2, db2, dbproj), db1_part gridDim.x x 4C,
// dw1_part gridDim.x x 4C x C, dwp_part gridDim.x x C x C.
template <int C>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
block_bwd_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                      const bf16* __restrict__ acc, const bf16* __restrict__ wproj,
                      const bf16* __restrict__ bproj, const float* __restrict__ ln1_s,
                      const float* __restrict__ ln1_b, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ b2, const float* __restrict__ ln2_s,
                      const float* __restrict__ ln2_b, const float* __restrict__ s1,
                      const float* __restrict__ s2, long long rows_per_sample, long long tiles,
                      bf16* __restrict__ do_out, bf16* __restrict__ dy_out,
                      bf16* __restrict__ act_out, bf16* __restrict__ dh_out,
                      float* __restrict__ ds1_rows, float* __restrict__ ds2_rows,
                      float* __restrict__ col_part, float* __restrict__ db1_part,
                      float* __restrict__ dw1_part, float* __restrict__ dwp_part) {
  using L = BwdLayout<C>;
  constexpr int H4 = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XB = reinterpret_cast<bf16*>(smem + L::XB_OFF);
  bf16* AB = reinterpret_cast<bf16*>(smem + L::AB_OFF);
  bf16* DB = reinterpret_cast<bf16*>(smem + L::DB_OFF);
  unsigned char* work = smem + L::W_OFF;
  float* H = reinterpret_cast<float*>(work);
  float* P = reinterpret_cast<float*>(work + L::H_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(work + 2 * L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(work + 2 * L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE / 2;
  float* Yf = reinterpret_cast<float*>(work);  // f32 rows between the products
  // per row: mu1, r1, mu2, r2, then the means of the LN2 and LN1 backwards
  float* stat = reinterpret_cast<float*>(smem + L::ST_OFF);
  float* db1 = reinterpret_cast<float*>(smem + L::DB1_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;  // row tile, column group
  const int col = threadIdx.x;             // the column of the column passes (col < C)
  float cg1 = 0.f, cb1 = 0.f, cg2 = 0.f, cb2 = 0.f, cby = 0.f, cbp = 0.f;  // its sums
  for (int c = threadIdx.x; c < H4; c += TAIL_THREADS) db1[c] = 0.f;
  float* dw1p = dw1_part + (long long)blockIdx.x * H4 * C;
  float* dwpp = dwp_part + (long long)blockIdx.x * C * C;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TAIL_ROWS;
    const bool first = tile == blockIdx.x;
    const float sc1 = s1[row0 / rows_per_sample], sc2 = s2[row0 / rows_per_sample];

    // ---- a = bf16(acc Wproj^T + bproj): acc staged into DB with the first chunk
    {
      FragC pacc[L::NT];
      for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(pacc[i], 0.f);
      pipelined(
          C / 32, S0, S1,
          [&](int i, bf16* st) {
            if (i == 0) stage_tile(DB, L::XB_LD, acc + row0 * C, C, TAIL_ROWS, C);
            stage_tile(st, L::WT_LD, wproj + i * 32, C, C, 32);
          },
          [&](int i, bf16* st) {
            for (int kk = 0; kk < 32; kk += 16) {
              FragA a;
              wmma::load_matrix_sync(a, DB + mt * 16 * L::XB_LD + i * 32 + kk, L::XB_LD);
              for (int j = 0; j < L::NT; ++j) {
                FragBt w;
                wmma::load_matrix_sync(w, st + (ng + 4 * j) * 16 * L::WT_LD + kk, L::WT_LD);
                wmma::mma_sync(pacc[j], a, w, pacc[j]);
              }
            }
          });
      for (int j = 0; j < L::NT; ++j)
        wmma::store_matrix_sync(Yf + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, pacc[j], L::Y_LD,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // ---- per row (one warp): a -> AB, LN1 statistics, x1 = bf16(x + s1 LN1(a)) -> XB
    for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
      const long long row = row0 + r;
      float v[C / 32];
      float sum = 0.f, sq = 0.f;
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        const bf16 ab = __float2bfloat16(Yf[r * L::Y_LD + c] + __bfloat162float(bproj[c]));
        AB[r * L::XB_LD + c] = ab;
        v[j] = __bfloat162float(ab);
        sum += v[j];
        sq += v[j] * v[j];
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mu = sum / C;
      const float rs = rsqrtf(sq / C - mu * mu + kLnEps);
      if (lane == 0) {
        stat[r * 8] = mu;
        stat[r * 8 + 1] = rs;
      }
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        const float ln = (v[j] - mu) * rs * ln1_s[c] + ln1_b[c];
        XB[r * L::XB_LD + c] =
            __float2bfloat16(__bfloat162float(x[row * C + c]) + sc1 * ln);
      }
    }
    __syncthreads();

    // ---- y2 = GELU(x1 W1^T + b1) W2^T, b2 added below
    {
      FragC yacc[L::NT];
      mlp_rows<C>(XB, H, HB, S0, S1, w1, b1, w2, yacc);
      for (int j = 0; j < L::NT; ++j)
        wmma::store_matrix_sync(Yf + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, yacc[j], L::Y_LD,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // ---- per row: LN2 statistics, ds2, and the two means of the LN2 backward
    for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
      const long long row = row0 + r;
      float v[C / 32];
      float sum = 0.f, sq = 0.f;
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        v[j] = Yf[r * L::Y_LD + c] + __bfloat162float(b2[c]);
        sum += v[j];
        sq += v[j] * v[j];
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mu = sum / C;
      const float rs = rsqrtf(sq / C - mu * mu + kLnEps);
      float dsum = 0.f, m1 = 0.f, m2 = 0.f;
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        const float yhat = (v[j] - mu) * rs;
        const float gv = __bfloat162float(gy[row * C + c]);
        dsum += gv * (yhat * ln2_s[c] + ln2_b[c]);
        const float dyh = gv * sc2 * ln2_s[c];
        m1 += dyh;
        m2 += dyh * yhat;
      }
      dsum = warp_sum(dsum);
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
      if (lane == 0) {
        stat[r * 8 + 2] = mu;
        stat[r * 8 + 3] = rs;
        stat[r * 8 + 4] = m1;
        stat[r * 8 + 5] = m2;
        ds2_rows[row] = dsum;
      }
    }
    __syncthreads();

    // ---- per column (one thread): dy2 = r2 (s2 g gamma2 - m1 - yhat2 m2) -> DB and
    // its slab, bf16; the column sums of dgamma2, dbeta2 and db2, rows in order
    if (col < C) {
      const float gam = ln2_s[col], bb = __bfloat162float(b2[col]);
      for (int r = 0; r < TAIL_ROWS; ++r) {
        const float* st = stat + r * 8;
        const float yhat = (Yf[r * L::Y_LD + col] + bb - st[2]) * st[3];
        const float gb = __bfloat162float(gy[(row0 + r) * C + col]) * sc2;
        cg2 += gb * yhat;
        cb2 += gb;
        const float dy = st[3] * (gb * gam - st[4] - yhat * st[5]);
        cby += dy;
        const bf16 d = __float2bfloat16(dy);
        DB[r * L::XB_LD + col] = d;
        dy_out[(row0 + r) * C + col] = d;
      }
    }
    __syncthreads();

    // ---- the hidden pass: GELU(h) and dh to their slabs, db1, dx1 - g in dacc;
    // per chunk dW1[chunk, :] += dh^T x1 into this CTA's partial
    FragC dacc[L::NT];
    for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(dacc[i], 0.f);
    mlp_hidden_bwd_rows<C>(XB, DB, H, P, HB, S0, S1, w1, b1, w2, act_out, dh_out, row0, db1, dacc,
                           [&](int h0) {
                             accumulate_at_b<HC, C>(HB, L::HB_LD, XB, L::XB_LD,
                                                    dw1p + (long long)h0 * C, C, first);
                           });
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Yf + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, dacc[j], L::Y_LD,
                              wmma::mem_row_major);
    __syncthreads();

    // ---- per row: dx1 = g + dh W1 (kept in Yf), ds1 and the two means of the LN1
    // backward (yhat1 from a and its statistics)
    for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
      const long long row = row0 + r;
      const float mu = stat[r * 8], rs = stat[r * 8 + 1];
      float dsum = 0.f, m1 = 0.f, m2 = 0.f;
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        const float d = __bfloat162float(gy[row * C + c]) + Yf[r * L::Y_LD + c];
        Yf[r * L::Y_LD + c] = d;
        const float yhat = (__bfloat162float(AB[r * L::XB_LD + c]) - mu) * rs;
        dsum += d * (yhat * ln1_s[c] + ln1_b[c]);
        const float dyh = d * sc1 * ln1_s[c];
        m1 += dyh;
        m2 += dyh * yhat;
      }
      dsum = warp_sum(dsum);
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
      if (lane == 0) {
        stat[r * 8 + 6] = m1;
        stat[r * 8 + 7] = m2;
        ds1_rows[row] = dsum;
      }
    }
    __syncthreads();

    // ---- per column: da = r1 (s1 dx1 gamma1 - m1 - yhat1 m2) -> AB (bf16, over a);
    // the column sums of dgamma1, dbeta1 and dbproj
    if (col < C) {
      const float gam = ln1_s[col];
      for (int r = 0; r < TAIL_ROWS; ++r) {
        const float* st = stat + r * 8;
        const float yhat = (__bfloat162float(AB[r * L::XB_LD + col]) - st[0]) * st[1];
        const float gb = Yf[r * L::Y_LD + col] * sc1;
        cg1 += gb * yhat;
        cb1 += gb;
        const float da = st[1] * (gb * gam - st[6] - yhat * st[7]);
        cbp += da;
        AB[r * L::XB_LD + col] = __float2bfloat16(da);
      }
    }
    __syncthreads();

    // ---- dO = bf16(da Wproj) (Wproj rows as the row-major B) -> its slab; acc
    // staged into DB again with the first chunk
    {
      FragC oacc[L::NT];
      for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(oacc[i], 0.f);
      pipelined(
          C / 32, S0, S1,
          [&](int i, bf16* st) {
            if (i == 0) stage_tile(DB, L::XB_LD, acc + row0 * C, C, TAIL_ROWS, C);
            stage_tile(st, L::XB_LD, wproj + (long long)i * 32 * C, C, 32, C);
          },
          [&](int i, bf16* st) {
            for (int kk = 0; kk < 32; kk += 16) {
              FragA a;
              wmma::load_matrix_sync(a, AB + mt * 16 * L::XB_LD + i * 32 + kk, L::XB_LD);
              for (int j = 0; j < L::NT; ++j) {
                FragB w;
                wmma::load_matrix_sync(w, st + kk * L::XB_LD + (ng + 4 * j) * 16, L::XB_LD);
                wmma::mma_sync(oacc[j], a, w, oacc[j]);
              }
            }
          });
      for (int j = 0; j < L::NT; ++j)
        wmma::store_matrix_sync(Yf + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, oacc[j], L::Y_LD,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int v = threadIdx.x; v < TAIL_ROWS * C / 8; v += TAIL_THREADS) {
      const int r = v / (C / 8), c = (v - r * (C / 8)) * 8;
      __align__(16) bf16 o[8];
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(Yf[r * L::Y_LD + c + e]);
      *reinterpret_cast<uint4*>(do_out + (row0 + r) * C + c) = *reinterpret_cast<const uint4*>(o);
    }
    // ---- dWproj (out, in) += da^T acc into this CTA's partial
    accumulate_at_b<C, C>(AB, L::XB_LD, DB, L::XB_LD, dwpp, C, first);
    __syncthreads();  // the next tile stages over the buffers
  }

  if (col < C) {
    const float sums[6] = {cg1, cb1, cg2, cb2, cby, cbp};
    for (int k = 0; k < 6; ++k)
      col_part[((long long)k * gridDim.x + blockIdx.x) * C + col] = sums[k];
  }
  for (int c = threadIdx.x; c < H4; c += TAIL_THREADS)
    db1_part[(long long)blockIdx.x * H4 + c] = db1[c];
}

// out[b] = the sum of x[b * n, (b + 1) * n), in a fixed order; one block per b.
__global__ void segment_sum_kernel(const float* __restrict__ x, long long n,
                                   float* __restrict__ out) {
  __shared__ float red[256];
  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += 256) s += x[(long long)blockIdx.x * n + i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int o = 128; o; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

bool geometry_ok(const Geom& g) {
  const long long rows = (long long)g.B * g.Z * g.Hp * g.W;
  return g.wz * g.wh * g.ww == T && g.C == g.heads * D && (g.C == 192 || g.C == 384) &&
         g.B >= 1 && g.Z % g.wz == 0 && g.Hp % g.wh == 0 && g.W % g.ww == 0 && rows % GM == 0 &&
         (rows / g.B) % TAIL_ROWS == 0;
}

struct BwdArgs {
  const bf16 *x, *gy, *wqkv, *bqkv, *wproj, *bproj, *w1, *b1, *w2, *b2;
  const float *bias, *mask, *ln1_s, *ln1_b, *ln2_s, *ln2_b, *s1, *s2;
  bf16 *acc, *dO, *dy, *act, *dh, *dqkv;
  float *ds_rows, *part;
  bf16 *dx, *dwqkv, *dbqkv, *dwproj, *dbproj, *dw1, *db1, *dw2, *db2;
  float *dbias, *dln1_s, *dln1_b, *dln2_s, *dln2_b, *ds1, *ds2;
};

template <int C>
int tail_grid(long long rows) {
  return resident_ctas(block_bwd_tail_kernel<C>, BwdLayout<C>::SMEM, rows / TAIL_ROWS);
}

template <int C>
long long bwd_scratch(const Geom& g) {
  const long long rows = (long long)g.B * g.Z * g.Hp * g.W;
  const long long grid = tail_grid<C>(rows);
  if (grid < 1) return 0;
  long long n = grid * (6LL * C + 4LL * C + 4LL * C * C + (long long)C * C);
  const long long types = (long long)(g.Z / g.wz) * (g.Hp / g.wh);
  const long long a = (long long)weight_grad_splits(3 * C, C, rows) * 3 * C * C;
  const long long b = (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C;
  if (types * 3 * C > n) n = types * 3 * C;
  if (a > n) n = a;
  if (b > n) n = b;
  return n;
}

template <int C>
cudaError_t launch_bwd(const BwdArgs& p, const Geom& g, float scale, cudaStream_t s) {
  using L = BwdLayout<C>;
  const long long rows = (long long)g.B * g.Z * g.Hp * g.W;
  const long long rps = rows / g.B;
  const int n_types = (g.Z / g.wz) * (g.Hp / g.wh);
  const int grid = tail_grid<C>(rows);
  if (grid < 1) return cudaErrorInvalidValue;

  // 1. the attention output, recomputed
  cudaError_t err =
      launch_window_attention(p.x, p.wqkv, p.bqkv, p.bias, p.mask, p.acc, g, scale, s);
  if (err != cudaSuccess) return err;

  // 2. the token tail backward, then its partials summed in order
  float* col_part = p.part;
  float* db1_part = col_part + 6LL * grid * C;
  float* dw1_part = db1_part + 4LL * grid * C;
  float* dwp_part = dw1_part + 4LL * grid * C * C;
  block_bwd_tail_kernel<C><<<grid, TAIL_THREADS, L::SMEM, s>>>(
      p.x, p.gy, p.acc, p.wproj, p.bproj, p.ln1_s, p.ln1_b, p.w1, p.b1, p.w2, p.b2, p.ln2_s,
      p.ln2_b, p.s1, p.s2, rps, rows / TAIL_ROWS, p.dO, p.dy, p.act, p.dh, p.ds_rows,
      p.ds_rows + rows, col_part, db1_part, dw1_part, dwp_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* const f32_out[4] = {p.dln1_s, p.dln1_b, p.dln2_s, p.dln2_b};
  for (int k = 0; k < 4; ++k)
    if ((err = reduce_partials(col_part + (long long)k * grid * C, grid, C, nullptr, f32_out[k],
                               s)) != cudaSuccess)
      return err;
  if ((err = reduce_partials(col_part + 4LL * grid * C, grid, C, p.db2, nullptr, s)) !=
          cudaSuccess ||
      (err = reduce_partials(col_part + 5LL * grid * C, grid, C, p.dbproj, nullptr, s)) !=
          cudaSuccess ||
      (err = reduce_partials(db1_part, grid, 4LL * C, p.db1, nullptr, s)) != cudaSuccess ||
      (err = reduce_partials(dw1_part, grid, 4LL * C * C, p.dw1, nullptr, s)) != cudaSuccess ||
      (err = reduce_partials(dwp_part, grid, (long long)C * C, p.dwproj, nullptr, s)) !=
          cudaSuccess)
    return err;
  segment_sum_kernel<<<g.B, 256, 0, s>>>(p.ds_rows, rps, p.ds1);
  segment_sum_kernel<<<g.B, 256, 0, s>>>(p.ds_rows + rows, rps, p.ds2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. the attention backward, given dO
  if ((err = cudaFuncSetAttribute(attention_bwd_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM)) !=
      cudaSuccess)
    return err;
  attention_bwd_kernel<true><<<(unsigned)(n_types * g.heads), BWD_THREADS, BWD_SMEM, s>>>(
      p.x, p.dO, p.wqkv, p.bqkv, nullptr, p.bias, p.mask, p.dqkv, p.dbias, p.part, g, scale,
      nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(p.part, n_types, 3LL * C, p.dbqkv, nullptr, s)) != cudaSuccess)
    return err;

  // 4. dx = bf16(dqkv Wqkv + dh W1 + g); dWqkv = dqkv^T x; dW2 (C, 4C) = dy2^T GELU(h)
  if ((err = gemm_sum(p.dqkv, 3 * C, p.wqkv, C, 3 * C, p.dh, 4 * C, p.w1, C, 4 * C, (int)rows,
                      C, p.gy, p.dx, s)) != cudaSuccess)
    return err;
  if ((err = gemm<false, true>(p.dqkv, 3 * C, p.x, C, 3 * C, C, rows,
                               weight_grad_splits(3 * C, C, rows), nullptr, p.dwqkv, p.part, s)) !=
      cudaSuccess)
    return err;
  return gemm<false, true>(p.dy, C, p.act, 4 * C, C, 4 * C, rows,
                           weight_grad_splits(C, 4 * C, rows), nullptr, p.dw2, p.part, s);
}

}  // namespace

extern "C" {

// K11 on `stream`: out = the training block of x, s1 and s2 one f32 per sample;
// attn_buf is (rows, C) bf16 scratch. Returns a cudaError_t
// (cudaErrorInvalidValue for a geometry the kernels do not take). `mask` may
// be null.
int pangu_block_train_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                          const void* bproj, const void* bias, const void* mask,
                          const void* ln1_s, const void* ln1_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* ln2_s, const void* ln2_b,
                          const void* s1, const void* s2, void* attn_buf, void* out, int B, int Z,
                          int Hp, int W, int C, int heads, int wz, int wh, int ww, float scale,
                          void* stream) {
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long windows = (long long)B * (Z / wz) * (Hp / wh) * (W / ww);
  const long long rows = windows * T;
  cudaError_t err = launch_window_attention(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), g, scale, s);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(attn_buf);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* bp = static_cast<const bf16*>(bproj);
  const float* l1s = static_cast<const float*>(ln1_s);
  const float* l1b = static_cast<const float*>(ln1_b);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* b2b = static_cast<const bf16*>(b2);
  const float* l2s = static_cast<const float*>(ln2_s);
  const float* l2b = static_cast<const float*>(ln2_b);
  const float* sc1 = static_cast<const float*>(s1);
  const float* sc2 = static_cast<const float*>(s2);
  bf16* ob = static_cast<bf16*>(out);
  err = (C == 192) ? launch_tail<192, true>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b, b2b,
                                            l2s, l2b, sc1, sc2, rows / B, ob)
                   : launch_tail<384, true>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b, b2b,
                                            l2s, l2b, sc1, sc2, rows / B, ob);
  return (int)err;
}

// f32 elements of scratch that pangu_block_train_bwd needs (0: geometry not taken).
long long pangu_block_train_bwd_scratch(int B, int Z, int Hp, int W, int C, int heads, int wz,
                                        int wh, int ww) {
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  if (!geometry_ok(g)) return 0;
  return C == 192 ? bwd_scratch<192>(g) : bwd_scratch<384>(g);
}

// K12 on `stream`, from g = dL/dout (gy). Scratch: acc_buf, do_buf, dy_buf
// (rows, C), act_buf, dh_buf (rows, 4C), dqkv_buf (rows, 3C), all bf16;
// ds_rows 2 x rows f32; scratch pangu_block_train_bwd_scratch(...) f32.
// Outputs: dx (rows, C), dwqkv (3C, C), dbqkv (3C), dwproj (C, C), dbproj (C),
// dw1 (4C, C), db1 (4C), dw2 (C, 4C), db2 (C) bf16; dbias (n_types, heads, T,
// T), dln1_s, dln1_b, dln2_s, dln2_b (C) and ds1, ds2 (B) f32.
int pangu_block_train_bwd(const void* x, const void* gy, const void* wqkv, const void* bqkv,
                          const void* wproj, const void* bproj, const void* bias,
                          const void* mask, const void* ln1_s, const void* ln1_b, const void* w1,
                          const void* b1, const void* w2, const void* b2, const void* ln2_s,
                          const void* ln2_b, const void* s1, const void* s2, void* acc_buf,
                          void* do_buf, void* dy_buf, void* act_buf, void* dh_buf, void* dqkv_buf,
                          void* ds_rows, void* scratch, void* dx, void* dwqkv, void* dbqkv,
                          void* dwproj, void* dbproj, void* dbias, void* dln1_s, void* dln1_b,
                          void* dw1, void* db1, void* dw2, void* db2, void* dln2_s, void* dln2_b,
                          void* ds1, void* ds2, int B, int Z, int Hp, int W, int C, int heads,
                          int wz, int wh, int ww, float scale, void* stream) {
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  BwdArgs p{};
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const bf16*>(bproj);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.ln2_s = static_cast<const float*>(ln2_s);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.s1 = static_cast<const float*>(s1);
  p.s2 = static_cast<const float*>(s2);
  p.acc = static_cast<bf16*>(acc_buf);
  p.dO = static_cast<bf16*>(do_buf);
  p.dy = static_cast<bf16*>(dy_buf);
  p.act = static_cast<bf16*>(act_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.dqkv = static_cast<bf16*>(dqkv_buf);
  p.ds_rows = static_cast<float*>(ds_rows);
  p.part = static_cast<float*>(scratch);
  p.dx = static_cast<bf16*>(dx);
  p.dwqkv = static_cast<bf16*>(dwqkv);
  p.dbqkv = static_cast<bf16*>(dbqkv);
  p.dwproj = static_cast<bf16*>(dwproj);
  p.dbproj = static_cast<bf16*>(dbproj);
  p.dbias = static_cast<float*>(dbias);
  p.dln1_s = static_cast<float*>(dln1_s);
  p.dln1_b = static_cast<float*>(dln1_b);
  p.dw1 = static_cast<bf16*>(dw1);
  p.db1 = static_cast<bf16*>(db1);
  p.dw2 = static_cast<bf16*>(dw2);
  p.db2 = static_cast<bf16*>(db2);
  p.dln2_s = static_cast<float*>(dln2_s);
  p.dln2_b = static_cast<float*>(dln2_b);
  p.ds1 = static_cast<float*>(ds1);
  p.ds2 = static_cast<float*>(ds2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(C == 192 ? launch_bwd<192>(p, g, scale, st) : launch_bwd<384>(p, g, scale, st));
}

}  // extern "C"
