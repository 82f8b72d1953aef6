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
// Design.
//
//  * K6 and K10 run mlp_tail_kernel<C, false, true, false> (mlp_wg.cuh, shared
//    with the token tail of K1, K11 and K2's LN mode): a persistent CTA per
//    SM walks 64-row tiles, x resident in shared memory (TMA), a producer
//    warp streaming 64-column chunks of W1 and W2 through a ring of
//    mbarrier-guarded slots, two consumer warpgroups forming the hidden chunk
//    on wgmma, GELU in registers, and y[:, their half] on wgmma; LN, scale and
//    residual per row. K10 passes no scale: with s = 1 the two give the same
//    bits. Any multiple of 48 rows: the last 64-row tile is masked.
//  * the backward K7, a row pass, a hidden pass and two products over all rows:
//    - the row pass, mlp_tail_kernel<C, false, true, false, true>: K6's
//      kernel recomputes y and, per row, forms ds and dy = LN backward of s g
//      (written bf16, (rows, C)); the column sums of dgamma, dbeta and db2
//      go over the warp's rows by shuffles, are kept across the CTA's tiles
//      by the lanes, and leave as four f32 partials per CTA;
//    - mlp_hidden_bwd_kernel<C, bf16> (mlp_hidden.cuh, wgmma): 64-row tiles,
//      x and dy resident in shared memory, one producer warp feeding the W2
//      and W1 chunks of each 64-column hidden chunk by TMA (one buffer
//      each: W2 is released after h and dP, W1 after dx, so each load
//      overlaps the other product); two
//      consumer warpgroups each form h = x W1^T and dP = dy W2[:, chunk] for
//      32 of the chunk's columns, a = bf16(GELU(h)) and dh = bf16(dP
//      GELU'(h)) in registers, written to a double-buffered staging tile
//      (the dh tile is also the A operand of dx) and from there to the (rows,
//      4C) slabs with 16-byte stores; then each accumulates dx[:, its half]
//      += dh W1[chunk, half] (f32 registers: 48 or 96 a thread). db1: f32
//      column sums of dh, rows and warps in a fixed order, per-CTA partials.
//      A partial last tile is read as zeros and not stored.
//    - dW2 = dy^T a and dW1 = dh^T x over the rows are gemm.cuh's wgmma
//      row-split products.
//    Every cross-CTA sum goes through per-CTA partials reduced in a fixed
//    order (reduce_partials): the result is the same on every run.
//  * K8 runs the same row kernel in its raw mode, mlp_tail_kernel<C, false,
//    true, false, false, true>: the MLP of K6 with an epilogue that adds b2
//    and rounds, no LayerNorm, scale or residual.
//  * K9 is K7 without its row pass: the hidden pass runs on g itself as the
//    output gradient and adds no residual to dx; db2 is the column sum of g
//    (gemm.cuh colsum), dW2 = g^T a and dW1 = dh^T x the row-split products.
//    The Pallas body carries dW1, dW2, db1 and db2 in VMEM across its
//    sequential grid; here they are per-CTA f32 partials summed in order.
//
// What bounds it on an H100: ~4 x rows x C x 4C FLOP forward (316 GFLOP at
// the outer stage) against two (rows, C) bf16 passes (0.4 GB): compute; the
// backward does ~3x the FLOP and moves the two hidden slabs (1.6 GB at the
// outer stage) once each way. K6, the row pass and the hidden pass stream W1
// and W2 (2 x 4C x C bf16) from the L2 for every 64-row tile, ~5 GB a call,
// and idle the tensor cores during their GELU epilogues: held by that feed
// and the epilogue rather than by the tensor-core peak (K8 too).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_mlp.py; the plain PyTorch versions are
// fused_mlp_postnorm_reference, fused_mlp_postnorm_bwd_reference,
// fused_mlp_reference and fused_mlp_bwd_reference there.

#include "gemm.cuh"
#include "mlp_hidden.cuh"

namespace {

struct Args {
  const bf16 *x, *gy, *w1, *b1, *w2, *b2;
  const float *gamma, *beta, *s;
  bf16 *dy, *a, *dh, *out, *dw1, *db1, *dw2, *db2;
  float *part, *dgamma, *dbeta, *ds;
  long long rows;
};

// The row kernel's arguments for the MLP tail over p's rows (s one per row).
TailArgs tail_args(const Args& p) {
  TailArgs a{};
  a.x = p.x;
  a.b1 = p.b1;
  a.b2 = p.b2;
  a.gy = p.gy;
  a.ln2_s = p.gamma;
  a.ln2_b = p.beta;
  a.s2 = p.s;
  a.ds = p.ds;
  a.rows = p.rows;
  a.rows_per_scale = 1;
  return a;
}

// K6 (s, one per row) and K10 (s null): out = bf16(x + s LN(y)).
template <int C>
cudaError_t launch_fwd(const Args& p, cudaStream_t stream) {
  TailArgs a = tail_args(p);
  a.out = p.out;
  return launch_mlp_tail<C, false, true, false>(p.x, nullptr, p.w1, p.w2, a, stream);
}

// f32 scratch of K7 and K9: the row pass's partials, the hidden pass's db1
// partials and the weight grads' row-slice partials, one after the other.
template <int C>
long long bwd_scratch(long long rows) {
  long long n = 3LL * 4 * tail_grid(rows) * C;  // also holds the hidden pass's db1 partials
  if ((long long)COLSUM_BLOCKS * C > n) n = (long long)COLSUM_BLOCKS * C;
  const long long w = (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C;
  return w > n ? w : n;
}

// The hidden pass, db1, then dW2 (C, 4C) = dy^T a and dW1 (4C, C) = dh^T x
// over the rows (dy = gy and no residual in dx for K9).
template <int C>
cudaError_t hidden_and_weight_grads(const Args& p, const bf16* dy, const bf16* gy,
                                    cudaStream_t stream) {
  cudaError_t err = launch_hidden<C, bf16>(p.x, dy, gy, p.w1, p.b1, p.w2, p.a, p.dh, p.out,
                                           p.part, p.rows, stream);
  if (err != cudaSuccess ||
      (err = reduce_partials(p.part, tail_grid(p.rows), 4LL * C, p.db1, nullptr, stream)) !=
          cudaSuccess ||
      (err = gemm<false, true>(dy, C, p.a, 4 * C, C, 4 * C, p.rows,
                               weight_grad_splits(C, 4 * C, p.rows), nullptr, p.dw2, p.part,
                               stream)) != cudaSuccess)
    return err;
  return gemm<false, true>(p.dh, 4 * C, p.x, C, 4 * C, C, p.rows,
                           weight_grad_splits(4 * C, C, p.rows), nullptr, p.dw1, p.part, stream);
}

// K7: the row pass (ds, dy and the partials of dgamma, dbeta and db2, four
// per CTA), their sums in order, then the hidden pass and the weight grads.
template <int C>
cudaError_t launch_bwd(const Args& p, cudaStream_t stream) {
  TailArgs a = tail_args(p);
  a.out = p.dy;
  a.part = p.part;
  cudaError_t err = launch_mlp_tail<C, false, true, false, true>(p.x, nullptr, p.w1, p.w2, a,
                                                                 stream);
  const int parts = 4 * tail_grid(p.rows);
  if (err != cudaSuccess ||
      (err = reduce_partials(p.part, parts, C, nullptr, p.dgamma, stream)) != cudaSuccess ||
      (err = reduce_partials(p.part + (long long)parts * C, parts, C, nullptr, p.dbeta, stream)) !=
          cudaSuccess ||
      (err = reduce_partials(p.part + 2LL * parts * C, parts, C, p.db2, nullptr, stream)) !=
          cudaSuccess)
    return err;
  return hidden_and_weight_grads<C>(p, p.dy, p.gy, stream);
}

// K8: out = bf16(y), the row kernel's raw mode.
template <int C>
cudaError_t launch_raw_fwd(const Args& p, cudaStream_t stream) {
  TailArgs a{};
  a.x = p.x;
  a.b1 = p.b1;
  a.b2 = p.b2;
  a.out = p.out;
  a.rows = p.rows;
  a.rows_per_scale = 1;
  return launch_mlp_tail<C, false, true, false, false, true>(p.x, nullptr, p.w1, p.w2, a, stream);
}

// K9: the hidden pass on g (no residual in dx), db1, db2 = sum of g, dW2 = g^T
// a and dW1 = dh^T x over the rows.
template <int C>
cudaError_t launch_raw_bwd(const Args& p, cudaStream_t stream) {
  cudaError_t err = colsum(p.gy, p.rows, C, p.part, p.db2, stream);
  if (err != cudaSuccess) return err;
  return hidden_and_weight_grads<C>(p, p.gy, nullptr, stream);
}

// Every kernel here takes any multiple of 48 rows (the wgmma kernels mask the
// last 64-row tile).
bool rows_ok(long long rows) { return rows > 0 && rows % 48 == 0; }

}  // namespace

extern "C" {

// K6 on `stream`: out = bf16(x + s * LN(GELU(x W1^T + b1) W2^T + b2)), s one f32
// per row. C 192 or 384 and rows a multiple of 48, else cudaErrorInvalidValue.
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
// and rows a multiple of 48, else cudaErrorInvalidValue.
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
    case 192: return (int)launch_fwd<192>(p, st);
    case 384: return (int)launch_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_mlp_postnorm_bwd needs (0: C or rows not
// taken: C 192 or 384, rows a multiple of 48).
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
// a multiple of 48, else cudaErrorInvalidValue.
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

// f32 elements of scratch that pangu_mlp_bwd needs (0: C or rows not taken: C
// 192 or 384, rows a multiple of 48).
long long pangu_mlp_bwd_scratch(long long rows, int C) {
  if (!rows_ok(rows)) return 0;
  switch (C) {
    case 192: return bwd_scratch<192>(rows);
    case 384: return bwd_scratch<384>(rows);
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
