// MLP of an Earth-Specific block in training, bf16 -- CUDA for Hopper
// (sm_90a): the MLP tail with its post-norm residual, and the raw MLP, each
// forward and backward.
//
// Replaces pangu_tpu/ops/fused_mlp.py::fused_mlp_postnorm (K6, the Pallas
// kernel _make_postnorm_fwd_kernel) and its backward _postnorm_bwd (K7,
// _make_postnorm_bwd_kernel), fused_mlp (K8, _make_raw_fwd_kernel) with its
// backward _raw_bwd (K9, _make_raw_bwd_kernel), and the inference MLP tail
// fused_mlp_block (K10, _make_kernel; its backward is XLA in the JAX package,
// so it has no kernel here either). Per token row of x (rows, C):
//
//   K6  out = bf16(x + s * LN(GELU(x @ W1^T + b1) @ W2^T + b2))
//   K10 out = bf16(x + LN(GELU(x @ W1^T + b1) @ W2^T + b2))
//   K7  dx, dW1, db1, dW2, db2, dgamma, dbeta, ds from g = dL/dout
//   K8  out = bf16(GELU(x @ W1^T + b1) @ W2^T + b2)
//   K9  dx = bf16(dh W1), dW1, db1, dW2, db2 from g = dL/dout
//
// with the rounding points of the Pallas bodies: the GELU hidden a, the LN
// input gradient dy and the hidden gradient dh are rounded to bf16 where they
// feed a product; the pre-activation h, the MLP output y, the LayerNorm
// (E[y^2] - mu^2, eps 1e-5), the residual and every sum stay f32. Weights
// come in nn.Linear's (out, in) layout, W1 (4C, C) and W2 (C, 4C); the weight
// and bias grads come back in it, rounded to bf16 as the Pallas wrapper
// rounds them to the argument dtype; dgamma, dbeta and ds (one per row) are
// f32. s is the per-row f32 branch scale (stochastic depth).
//
// Design. A CTA owns 48 rows at a time (12 warps: 3 row tiles x 4 column
// groups) and streams the 4C hidden in 64-column chunks, so the (rows, 4C)
// hidden exists in shared memory one chunk at a time (mlp_tile.cuh, shared
// with K1's token tail):
//
//  * mlp_postnorm_kernel<C, false> (K6): h chunk = x W1^T, GELU, bf16, then
//    the W2 product accumulating in registers; LN, scale and residual per row.
//  * the backward has two row passes and two products over all rows:
//    - mlp_postnorm_kernel<C, true> recomputes y the same way and forms, per
//      row, ds, dy = LN backward of s g (written bf16, (rows, C)) and the
//      f32 partials of dgamma, dbeta and db2;
//    - mlp_hidden_bwd_kernel<C> recomputes each h chunk beside the dy W2
//      chunk, writes a = bf16(GELU(h)) and dh = bf16(dy W2 * GELU'(h)) to
//      (rows, 4C) slabs, sums db1 (f32) and accumulates dx = dh W1 + g in
//      registers;
//    - dW2 = dy^T a and dW1 = dh^T x over the rows are gemm.cuh products
//      split over the rows with f32 partials summed in order.
//    Every cross-CTA sum goes through per-CTA partials reduced in a fixed
//    order (reduce_partials): the result is the same on every run.
//  * mlp_postnorm_kernel<C, false, false> (K10): K6 without the branch scale,
//    so it reads no scale vector; with s = 1 the two give the same bits.
//  * mlp_raw_kernel<C> (K8): K6 without the LayerNorm and the residual.
//  * K9 is K7 without its row pass: the hidden pass (mlp_hidden_bwd_rows) runs
//    on g itself as the output gradient and adds no residual to dx; db2 is
//    the column sum of g (gemm.cuh colsum), dW2 = g^T a and dW1 = dh^T x the
//    row-split products. The Pallas body carries dW1, dW2, db1 and db2 in VMEM
//    across its sequential grid; here they are per-CTA f32 partials summed in
//    order, as above.
//
// What bounds it on an H100: ~4 x rows x C x 4C FLOP forward (316 GFLOP at
// the outer stage) against two (rows, C) bf16 passes (0.4 GB): compute; the
// backward does ~3x the FLOP and moves the two hidden slabs (1.6 GB at the
// outer stage) once each way. K8/K9 are bound the same way. The products are
// wmma fragments loaded from shared memory, as in K1's tail; wgmma is later
// work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_mlp.py; the plain PyTorch versions are
// fused_mlp_postnorm_reference, fused_mlp_postnorm_bwd_reference,
// fused_mlp_reference and fused_mlp_bwd_reference there.

#include "gemm.cuh"
#include "mlp_tile.cuh"

namespace {

template <int C>
struct MlpLayout : MlpTile<C> {
  using M = MlpTile<C>;
  // forward: x, h, bf16 hidden, two stages; y (f32) reuses it all after the MLP
  static constexpr int F_WORK = M::XB_BYTES + M::H_BYTES + M::HB_BYTES + 2 * M::STAGE_BYTES;
  static constexpr int F_RED = 3 * TAIL_WARPS * C * 4;  // backward partials, at the end
  static constexpr int F_SMEM = cmax(cmax(F_WORK, M::Y_BYTES), F_RED);
  // hidden backward: x, dy, h, dP (then dh), bf16 dh, two stages, db1 sums
  static constexpr int B_STAGE = hidden_bwd_stage_bytes<C>();
  static constexpr int B_ROWS = 2 * M::XB_BYTES + 2 * M::H_BYTES;  // dx f32 reuses it
  static constexpr int B_SMEM = B_ROWS + M::HB_BYTES + 2 * B_STAGE + 4 * C * 4;
  static_assert(B_STAGE % 32 == 0, "wmma needs 256-bit aligned tiles");
  static_assert(M::Y_BYTES <= B_ROWS, "dx fits the row buffers");
  static_assert(F_SMEM <= 232448 && B_SMEM <= 232448, "fits one CTA's shared memory");
};

// K6 (BWD false): out = bf16(x + s * LN(y)); K10 (SCALED false too): out =
// bf16(x + LN(y)), s not read. Backward pass 1 (BWD true): ds, dy = bf16(LN
// backward of s g) and the per-CTA partials of dgamma, dbeta, db2.
// y = GELU(x W1^T + b1) W2^T + b2, recomputed. Loops over 48-row tiles.
template <int C, bool BWD, bool SCALED = true>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
mlp_postnorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ s,
                    const bf16* __restrict__ gy, bf16* __restrict__ out,
                    float* __restrict__ ds, float* __restrict__ part, long long tiles) {
  using L = MlpLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XB = reinterpret_cast<bf16*>(smem);
  float* H = reinterpret_cast<float*>(smem + L::XB_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE_BYTES / 2;
  float* Ys = reinterpret_cast<float*>(smem);  // after the MLP
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;  // row tile, column group
  float dg[C / 32], db[C / 32], dby[C / 32];  // backward partials, column lane + 32 j
  for (int j = 0; j < C / 32; ++j) dg[j] = db[j] = dby[j] = 0.f;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TAIL_ROWS;
    // ---- y = GELU(x W1^T + b1) W2^T over 64-column chunks of the hidden
    stage_tile(XB, L::XB_LD, x + row0 * C, C, TAIL_ROWS, C);
    cp_async_commit();
    FragC yacc[L::NT];
    mlp_rows<C>(XB, H, HB, S0, S1, w1, b1, w2, yacc);
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Ys + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, yacc[j], L::Y_LD,
                              wmma::mem_row_major);
    __syncthreads();

    // ---- per row (one warp): LayerNorm statistics of y + b2, then the epilogue
    for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
      const long long row = row0 + r;
      float v[C / 32];
      float sum = 0.f, sq = 0.f;
      for (int j = 0; j < C / 32; ++j) {
        const int c = lane + 32 * j;
        v[j] = Ys[r * L::Y_LD + c] + __bfloat162float(b2[c]);
        sum += v[j];
        sq += v[j] * v[j];
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mu = sum / C;
      const float rs = rsqrtf(sq / C - mu * mu + kLnEps);
      const float sc = SCALED ? s[row] : 1.f;
      if (!BWD) {
        for (int j = 0; j < C / 32; ++j) {
          const int c = lane + 32 * j;
          const float y = (v[j] - mu) * rs * gamma[c] + beta[c];
          out[row * C + c] = __float2bfloat16(__bfloat162float(x[row * C + c]) + sc * y);
        }
      } else {
        float dsum = 0.f, m1 = 0.f, m2 = 0.f, dyh[C / 32];
        for (int j = 0; j < C / 32; ++j) {
          const int c = lane + 32 * j;
          v[j] = (v[j] - mu) * rs;  // yhat
          const float gv = __bfloat162float(gy[row * C + c]);
          dsum += gv * (v[j] * gamma[c] + beta[c]);
          const float gb = gv * sc;
          dg[j] += gb * v[j];
          db[j] += gb;
          dyh[j] = gb * gamma[c];
          m1 += dyh[j];
          m2 += dyh[j] * v[j];
        }
        dsum = warp_sum(dsum);
        m1 = warp_sum(m1) / C;
        m2 = warp_sum(m2) / C;
        if (lane == 0) ds[row] = dsum;
        for (int j = 0; j < C / 32; ++j) {
          const float dy = rs * (dyh[j] - m1 - v[j] * m2);
          dby[j] += dy;
          out[row * C + lane + 32 * j] = __float2bfloat16(dy);
        }
      }
    }
    __syncthreads();  // y is read: the next tile stages over it
  }

  if (BWD) {  // dgamma, dbeta, db2 partials of this CTA: the warps' sums, in order
    float* red = reinterpret_cast<float*>(smem);
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      red[(0 * TAIL_WARPS + warp) * C + c] = dg[j];
      red[(1 * TAIL_WARPS + warp) * C + c] = db[j];
      red[(2 * TAIL_WARPS + warp) * C + c] = dby[j];
    }
    __syncthreads();
    for (int v = threadIdx.x; v < 3 * C; v += TAIL_THREADS) {
      const int k = v / C, c = v - k * C;
      float acc = 0.f;
      for (int w = 0; w < TAIL_WARPS; ++w) acc += red[(k * TAIL_WARPS + w) * C + c];
      part[((long long)k * gridDim.x + blockIdx.x) * C + c] = acc;
    }
  }
}

// Backward pass 2: the hidden pass (mlp_hidden_bwd_rows) with dy as the MLP
// output's gradient; then dx = bf16(dh W1 + g), or bf16(dh W1) with gy null
// (K9). Loops over 48-row tiles; db1 partials per CTA.
template <int C>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
mlp_hidden_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const bf16* __restrict__ gy, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      bf16* __restrict__ a_out, bf16* __restrict__ dh_out,
                      bf16* __restrict__ dx, float* __restrict__ db1_part, long long tiles) {
  using L = MlpLayout<C>;
  constexpr int H4 = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XB = reinterpret_cast<bf16*>(smem);
  bf16* DB = reinterpret_cast<bf16*>(smem + L::XB_BYTES);
  float* H = reinterpret_cast<float*>(smem + 2 * L::XB_BYTES);
  float* P = reinterpret_cast<float*>(smem + 2 * L::XB_BYTES + L::H_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(smem + L::B_ROWS);
  bf16* S0 = reinterpret_cast<bf16*>(smem + L::B_ROWS + L::HB_BYTES);
  bf16* S1 = S0 + L::B_STAGE / 2;
  float* db1 = reinterpret_cast<float*>(smem + L::B_ROWS + L::HB_BYTES + 2 * L::B_STAGE);
  float* Ds = reinterpret_cast<float*>(smem);  // dx, after the last chunk
  const int warp = threadIdx.x >> 5;
  const int mt = warp >> 2, ng = warp & 3;
  for (int c = threadIdx.x; c < H4; c += TAIL_THREADS) db1[c] = 0.f;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TAIL_ROWS;
    stage_tile(XB, L::XB_LD, x + row0 * C, C, TAIL_ROWS, C);
    stage_tile(DB, L::XB_LD, dy + row0 * C, C, TAIL_ROWS, C);
    cp_async_commit();  // completed by the first chunk's wait
    FragC dacc[L::NT];
    for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(dacc[i], 0.f);
    mlp_hidden_bwd_rows<C>(XB, DB, H, P, HB, S0, S1, w1, b1, w2, a_out, dh_out, row0, db1, dacc,
                           [](int) {});
    // P is read (the pass ends with a barrier): dx goes over the row buffers
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Ds + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, dacc[j], L::Y_LD,
                              wmma::mem_row_major);
    __syncthreads();
    for (int v = threadIdx.x; v < TAIL_ROWS * C; v += TAIL_THREADS) {
      const int r = v / C, c = v - r * C;
      const long long at = (row0 + r) * C + c;
      dx[at] = __float2bfloat16(Ds[r * L::Y_LD + c] + (gy ? __bfloat162float(gy[at]) : 0.f));
    }
    __syncthreads();  // dx is read: the next tile stages over it
  }
  for (int c = threadIdx.x; c < H4; c += TAIL_THREADS)
    db1_part[(long long)blockIdx.x * H4 + c] = db1[c];
}

// K8: out = bf16(GELU(x W1^T + b1) W2^T + b2). Loops over 48-row tiles.
template <int C>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
mlp_raw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, long long tiles) {
  using L = MlpLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XB = reinterpret_cast<bf16*>(smem);
  float* H = reinterpret_cast<float*>(smem + L::XB_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE_BYTES / 2;
  float* Ys = reinterpret_cast<float*>(smem);  // after the MLP
  const int warp = threadIdx.x >> 5;
  const int mt = warp >> 2, ng = warp & 3;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TAIL_ROWS;
    stage_tile(XB, L::XB_LD, x + row0 * C, C, TAIL_ROWS, C);
    cp_async_commit();
    FragC yacc[L::NT];
    mlp_rows<C>(XB, H, HB, S0, S1, w1, b1, w2, yacc);
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Ys + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, yacc[j], L::Y_LD,
                              wmma::mem_row_major);
    __syncthreads();
    for (int v = threadIdx.x; v < TAIL_ROWS * C / 8; v += TAIL_THREADS) {
      const int r = v / (C / 8), c = (v - r * (C / 8)) * 8;
      __align__(16) bf16 o[8];
      for (int e = 0; e < 8; ++e)
        o[e] = __float2bfloat16(Ys[r * L::Y_LD + c + e] + __bfloat162float(b2[c + e]));
      *reinterpret_cast<uint4*>(out + (row0 + r) * C + c) = *reinterpret_cast<const uint4*>(o);
    }
    __syncthreads();  // y is read: the next tile stages over it
  }
}

struct Args {
  const bf16 *x, *gy, *w1, *b1, *w2, *b2;
  const float *gamma, *beta, *s;
  bf16 *dy, *a, *dh, *out, *dw1, *db1, *dw2, *db2;
  float *part, *dgamma, *dbeta, *ds;
  long long rows;
};

template <int C>
cudaError_t launch_fwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int grid = resident_ctas(mlp_postnorm_kernel<C, false>, L::F_SMEM, tiles);
  if (grid < 1) return cudaErrorInvalidValue;
  mlp_postnorm_kernel<C, false><<<grid, TAIL_THREADS, L::F_SMEM, stream>>>(
      p.x, p.w1, p.b1, p.w2, p.b2, p.gamma, p.beta, p.s, nullptr, p.out, nullptr, nullptr,
      tiles);
  return cudaGetLastError();
}

// K10: K6's forward with no branch scale.
template <int C>
cudaError_t launch_block_fwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int grid = resident_ctas(mlp_postnorm_kernel<C, false, false>, L::F_SMEM, tiles);
  if (grid < 1) return cudaErrorInvalidValue;
  mlp_postnorm_kernel<C, false, false><<<grid, TAIL_THREADS, L::F_SMEM, stream>>>(
      p.x, p.w1, p.b1, p.w2, p.b2, p.gamma, p.beta, nullptr, nullptr, p.out, nullptr, nullptr,
      tiles);
  return cudaGetLastError();
}

template <int C>
long long bwd_scratch(long long rows) {
  using L = MlpLayout<C>;
  const long long tiles = rows / TAIL_ROWS;
  const long long g1 = resident_ctas(mlp_postnorm_kernel<C, true>, L::F_SMEM, tiles);
  const long long g2 = resident_ctas(mlp_hidden_bwd_kernel<C>, L::B_SMEM, tiles);
  long long n = 3 * g1 * C;
  if (g2 * 4 * C > n) n = g2 * 4 * C;
  const long long w = (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C;
  return w > n ? w : n;
}

template <int C>
cudaError_t launch_bwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int g1 = resident_ctas(mlp_postnorm_kernel<C, true>, L::F_SMEM, tiles);
  const int g2 = resident_ctas(mlp_hidden_bwd_kernel<C>, L::B_SMEM, tiles);
  if (g1 < 1 || g2 < 1) return cudaErrorInvalidValue;
  mlp_postnorm_kernel<C, true><<<g1, TAIL_THREADS, L::F_SMEM, stream>>>(
      p.x, p.w1, p.b1, p.w2, p.b2, p.gamma, p.beta, p.s, p.gy, p.dy, p.ds, p.part, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = reduce_partials(p.part, g1, C, nullptr, p.dgamma, stream)) != cudaSuccess ||
      (err = reduce_partials(p.part + (long long)g1 * C, g1, C, nullptr, p.dbeta, stream)) !=
          cudaSuccess ||
      (err = reduce_partials(p.part + 2LL * g1 * C, g1, C, p.db2, nullptr, stream)) !=
          cudaSuccess)
    return err;
  mlp_hidden_bwd_kernel<C><<<g2, TAIL_THREADS, L::B_SMEM, stream>>>(
      p.x, p.dy, p.gy, p.w1, p.b1, p.w2, p.a, p.dh, p.out, p.part, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(p.part, g2, 4LL * C, p.db1, nullptr, stream)) != cudaSuccess)
    return err;
  // dW2 (C, 4C) = dy^T a and dW1 (4C, C) = dh^T x, over the rows
  if ((err = gemm<false, true>(p.dy, C, p.a, 4 * C, C, 4 * C, p.rows,
                               weight_grad_splits(C, 4 * C, p.rows), nullptr, p.dw2, p.part,
                               stream)) != cudaSuccess)
    return err;
  return gemm<false, true>(p.dh, 4 * C, p.x, C, 4 * C, C, p.rows,
                           weight_grad_splits(4 * C, C, p.rows), nullptr, p.dw1, p.part, stream);
}

template <int C>
cudaError_t launch_raw_fwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int grid = resident_ctas(mlp_raw_kernel<C>, L::F_SMEM, tiles);
  if (grid < 1) return cudaErrorInvalidValue;
  mlp_raw_kernel<C><<<grid, TAIL_THREADS, L::F_SMEM, stream>>>(p.x, p.w1, p.b1, p.w2, p.b2,
                                                               p.out, tiles);
  return cudaGetLastError();
}

template <int C>
long long raw_bwd_scratch(long long rows) {
  using L = MlpLayout<C>;
  const long long g2 = resident_ctas(mlp_hidden_bwd_kernel<C>, L::B_SMEM, rows / TAIL_ROWS);
  long long n = g2 * 4 * C;
  if ((long long)COLSUM_BLOCKS * C > n) n = (long long)COLSUM_BLOCKS * C;
  const long long w = (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C;
  return w > n ? w : n;
}

// K9: the hidden pass on g (no residual in dx), db1, db2 = sum of g, then
// dW2 = g^T a and dW1 = dh^T x over the rows.
template <int C>
cudaError_t launch_raw_bwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int g2 = resident_ctas(mlp_hidden_bwd_kernel<C>, L::B_SMEM, tiles);
  if (g2 < 1) return cudaErrorInvalidValue;
  mlp_hidden_bwd_kernel<C><<<g2, TAIL_THREADS, L::B_SMEM, stream>>>(
      p.x, p.gy, nullptr, p.w1, p.b1, p.w2, p.a, p.dh, p.out, p.part, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = reduce_partials(p.part, g2, 4LL * C, p.db1, nullptr, stream)) != cudaSuccess ||
      (err = colsum(p.gy, p.rows, C, p.part, p.db2, stream)) != cudaSuccess)
    return err;
  if ((err = gemm<false, true>(p.gy, C, p.a, 4 * C, C, 4 * C, p.rows,
                               weight_grad_splits(C, 4 * C, p.rows), nullptr, p.dw2, p.part,
                               stream)) != cudaSuccess)
    return err;
  return gemm<false, true>(p.dh, 4 * C, p.x, C, 4 * C, C, p.rows,
                           weight_grad_splits(4 * C, C, p.rows), nullptr, p.dw1, p.part, stream);
}

bool rows_ok(long long rows) { return rows > 0 && rows % TAIL_ROWS == 0 && rows % GK == 0; }

}  // namespace

extern "C" {

// K6 on `stream`: out = bf16(x + s * LN(GELU(x W1^T + b1) W2^T + b2)), s one f32
// per row. C 192 or 384 and rows a multiple of 96, else cudaErrorInvalidValue.
int pangu_mlp_postnorm_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* gamma, const void* beta, const void* s,
                           void* out, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.s = static_cast<const float*>(s);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_fwd<192>(p, st);
    case 384: return (int)launch_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K10 on `stream`: out = bf16(x + LN(GELU(x W1^T + b1) W2^T + b2)). C 192 or 384
// and rows a multiple of 96, else cudaErrorInvalidValue.
int pangu_mlp_block_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* gamma, const void* beta, void* out,
                        long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_block_fwd<192>(p, st);
    case 384: return (int)launch_block_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_mlp_postnorm_bwd needs (0: C or rows not taken).
long long pangu_mlp_postnorm_bwd_scratch(long long rows, int C) {
  if (!rows_ok(rows)) return 0;
  switch (C) {
    case 192: return bwd_scratch<192>(rows);
    case 384: return bwd_scratch<384>(rows);
    default: return 0;
  }
}

// K7 on `stream`, from gy = dL/dout: dx (rows, C) bf16; dw1 (4C, C), db1 (4C),
// dw2 (C, 4C), db2 (C) bf16; dgamma, dbeta (C) and ds (rows) f32. dy_buf (rows,
// C), a_buf and dh_buf (rows, 4C) are bf16 scratch, scratch has
// pangu_mlp_postnorm_bwd_scratch(rows, C) floats.
int pangu_mlp_postnorm_bwd(const void* x, const void* gy, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma, const void* beta,
                           const void* s, void* dy_buf, void* a_buf, void* dh_buf, void* scratch,
                           void* dx, void* dw1, void* db1, void* dw2, void* db2, void* dgamma,
                           void* dbeta, void* ds, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.s = static_cast<const float*>(s);
  p.dy = static_cast<bf16*>(dy_buf);
  p.a = static_cast<bf16*>(a_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.part = static_cast<float*>(scratch);
  p.out = static_cast<bf16*>(dx);
  p.dw1 = static_cast<bf16*>(dw1);
  p.db1 = static_cast<bf16*>(db1);
  p.dw2 = static_cast<bf16*>(dw2);
  p.db2 = static_cast<bf16*>(db2);
  p.dgamma = static_cast<float*>(dgamma);
  p.dbeta = static_cast<float*>(dbeta);
  p.ds = static_cast<float*>(ds);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_bwd<192>(p, st);
    case 384: return (int)launch_bwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8 on `stream`: out = bf16(GELU(x W1^T + b1) W2^T + b2). C 192 or 384 and rows
// a multiple of 96, else cudaErrorInvalidValue.
int pangu_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                  void* out, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_raw_fwd<192>(p, st);
    case 384: return (int)launch_raw_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_mlp_bwd needs (0: C or rows not taken).
long long pangu_mlp_bwd_scratch(long long rows, int C) {
  if (!rows_ok(rows)) return 0;
  switch (C) {
    case 192: return raw_bwd_scratch<192>(rows);
    case 384: return raw_bwd_scratch<384>(rows);
    default: return 0;
  }
}

// K9 on `stream`, from gy = dL/dout: dx (rows, C), dw1 (4C, C), db1 (4C), dw2
// (C, 4C), db2 (C), all bf16. a_buf and dh_buf (rows, 4C) are bf16 scratch,
// scratch has pangu_mlp_bwd_scratch(rows, C) floats.
int pangu_mlp_bwd(const void* x, const void* gy, const void* w1, const void* b1, const void* w2,
                  void* a_buf, void* dh_buf, void* scratch, void* dx, void* dw1, void* db1,
                  void* dw2, void* db2, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.a = static_cast<bf16*>(a_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.part = static_cast<float*>(scratch);
  p.out = static_cast<bf16*>(dx);
  p.dw1 = static_cast<bf16*>(dw1);
  p.db1 = static_cast<bf16*>(db1);
  p.dw2 = static_cast<bf16*>(dw2);
  p.db2 = static_cast<bf16*>(db2);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_raw_bwd<192>(p, st);
    case 384: return (int)launch_raw_bwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
