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
// and ds1/ds2 across its sequential grid. Hopper's CTAs run in no order, so K12
// is the chain of the unfused route's Hopper kernels, each rounding point of
// the Pallas body a bf16 slab (dx1 f32) between two launches:
//
//  1. window_attention_kernel recomputes the attention output: acc (bf16).
//  2. the row pass, mlp_tail_kernel<C, true, true, true, true> (mlp_wg.cuh,
//     K11's tail with K7's LN2 backward): a = bf16(acc Wproj^T + bproj) and x1
//     = bf16(x + s1 LN1(a)) (both written: the a and x1 slabs), y2 = the MLP
//     of x1, then dy2 = the LN2 backward of s2 g (the dy2 slab, bf16), ds2 per
//     row and per-CTA partials of dgamma2, dbeta2 and db2.
//  3. the hidden pass, mlp_hidden_bwd_kernel<C, float> (mlp_hidden.cuh, K7's):
//     from x1 and dy2, GELU(h) and dh (bf16 slabs, (rows, 4C)), the db1
//     partials, and dx1 = g + dh W1 in f32, unrounded (the dx1 slab).
//  4. the LN1 backward, residual_postnorm_bwd_kernel<C / 64, float, true>
//     (residual_postnorm.cuh, K5's on the f32 gradient): from a and dx1, da
//     (the da slab, bf16), ds1 per row and the dgamma1 and dbeta1 partials.
//  5. the attention backward, attention_bwd_regs_kernel<false> (attention_bwd.cuh,
//     K3's, from da as K3 runs from its cotangent): per (window type, head),
//     q|k|v and dO = bf16(da Wproj[:, head]) recomputed, the dqkv slab, dbias
//     (one writer per tile) and the dbqkv and dbproj partials; acc is not
//     written again.
//  6. gemm.cuh's wgmma products: dx = bf16(dqkv Wqkv + dx1) (the f32 addend in
//     the epilogue, one rounding), and the row-split weight grads dWqkv =
//     dqkv^T x, dWproj = da^T acc, dW1 = dh^T x1 and dW2 = dy2^T GELU(h).
//  Every partial is summed in a fixed order (reduce_partials; ds1 and ds2 per
//  sample by segment_sum_kernel): the same bits on every run.
//
// Slabs per call (rows = B Z Hp W): acc, a, x1, dy2, da (rows, C) and dqkv
// (rows, 3C) bf16, GELU(h) and dh (rows, 4C) bf16, dx1 (rows, C) f32, ds1 and
// ds2 per row; 3.7 GB written at the outer stage, each slab read once or
// twice (~5.6 GB). No launch is a wmma kernel and no weight grad is a
// read-modify-write of a partial in device memory.
//
// Rounding: as the Pallas body, except two sums. D = rowsum(dP p) is formed by
// K3's kernel as rowsum(dO O) with O = P v from the bf16 P (equal up to P's
// rounding; K3's departure, within the kernel bounds of tests/test_torch_gpu.py), and
// dbproj is the column sum of the bf16 da that feeds the attention backward
// rather than of the f32 da.
//
// What bounds it on an H100: an outer-stage block is ~0.53 TFLOP forward and
// ~1.9 TFLOP backward (the forward recomputed, dO, four score-sized products,
// the MLP's three and the deep products), ~1.9 ms at the bf16 peak, against
// ~9 GB of slab traffic, ~2.8 ms at 3.35 TB/s: the slabs between the
// launches and the kernels' own limits (each described in its file: the L2
// weight feed of the row and hidden passes, the attention backward's
// recompute) hold it, not the tensor-core peak.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_train.py; the plain PyTorch versions are
// fused_earth_block_train_reference and fused_earth_block_train_bwd_reference.

#include "attention_bwd.cuh"
#include "gemm.cuh"
#include "mlp_hidden.cuh"
#include "residual_postnorm.cuh"

namespace {

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
         g.B >= 1 && g.Z % g.wz == 0 && g.Hp % g.wh == 0 && g.W % g.ww == 0 &&
         rows % ROW_TILE == 0;
}

struct BwdArgs {
  const bf16 *x, *gy, *wqkv, *bqkv, *wproj, *bproj, *w1, *b1, *w2, *b2;
  const float *bias, *mask, *ln1_s, *ln1_b, *ln2_s, *ln2_b, *s1, *s2;
  bf16 *acc, *a, *x1, *dy, *act, *dh, *da, *dqkv;
  float *dx1, *ds_rows, *part;
  bf16 *dx, *dwqkv, *dbqkv, *dwproj, *dbproj, *dw1, *db1, *dw2, *db2;
  float *dbias, *dln1_s, *dln1_b, *dln2_s, *dln2_b, *ds1, *ds2;
};

// f32 scratch of K12: the partials of each step in turn (the row pass's,
// the hidden pass's db1, the LN1 backward's, the attention's dbqkv and
// dbproj, the weight grads' row slices), the largest of them.
template <int C>
long long bwd_scratch(const Geom& g) {
  const long long rows = (long long)g.B * g.Z * g.Hp * g.W;
  const long long types = (long long)(g.Z / g.wz) * (g.Hp / g.wh);
  const long long grid = tail_grid(rows);
  const long long sizes[] = {
      3LL * 4 * grid * C, grid * 4LL * C, 2LL * EPI_BWD_BLOCKS * C, types * 4 * C,
      (long long)weight_grad_splits(3 * C, C, rows) * 3 * C * C,
      (long long)weight_grad_splits(C, C, rows) * C * C,
      (long long)weight_grad_splits(4 * C, C, rows) * 4 * C * C,
      (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C};
  long long n = 0;
  for (long long v : sizes) n = v > n ? v : n;
  return n;
}

template <int C>
cudaError_t launch_bwd(const BwdArgs& p, const Geom& g, float scale, cudaStream_t s) {
  const long long rows = (long long)g.B * g.Z * g.Hp * g.W;
  const long long rps = rows / g.B;
  const int n_types = (g.Z / g.wz) * (g.Hp / g.wh);

  // 1. the attention output, recomputed
  cudaError_t err =
      launch_window_attention(p.x, p.wqkv, p.bqkv, p.bias, p.mask, p.acc, g, scale, s);
  if (err != cudaSuccess) return err;

  // 2. the row pass: a, x1, dy2, ds2 per row; dgamma2, dbeta2, db2 summed in order
  TailArgs t{};
  t.x = p.x;
  t.bproj = p.bproj;
  t.b1 = p.b1;
  t.b2 = p.b2;
  t.gy = p.gy;
  t.ln1_s = p.ln1_s;
  t.ln1_b = p.ln1_b;
  t.ln2_s = p.ln2_s;
  t.ln2_b = p.ln2_b;
  t.s1 = p.s1;
  t.s2 = p.s2;
  t.out = p.dy;
  t.a_out = p.a;
  t.x1_out = p.x1;
  t.ds = p.ds_rows + rows;
  t.part = p.part;
  t.rows = rows;
  t.rows_per_scale = rps;
  const int parts = 4 * tail_grid(rows);
  if ((err = launch_mlp_tail<C, true, true, true, true>(p.acc, p.wproj, p.w1, p.w2, t, s)) !=
          cudaSuccess ||
      (err = reduce_partials(p.part, parts, C, nullptr, p.dln2_s, s)) != cudaSuccess ||
      (err = reduce_partials(p.part + (long long)parts * C, parts, C, nullptr, p.dln2_b, s)) !=
          cudaSuccess ||
      (err = reduce_partials(p.part + 2LL * parts * C, parts, C, p.db2, nullptr, s)) !=
          cudaSuccess)
    return err;

  // 3. the hidden pass: GELU(h), dh, dx1 = g + dh W1 (f32); db1 summed in order
  if ((err = launch_hidden<C, float>(p.x1, p.dy, p.gy, p.w1, p.b1, p.w2, p.act, p.dh, p.dx1,
                                     p.part, rows, s)) != cudaSuccess ||
      (err = reduce_partials(p.part, tail_grid(rows), 4LL * C, p.db1, nullptr, s)) !=
          cudaSuccess)
    return err;

  // 4. the LN1 backward from dx1: da, ds1 per row, dgamma1 and dbeta1; ds1 and
  // ds2 summed per sample
  if ((err = launch_residual_bwd<C / 64, float, true>(p.a, p.dx1, p.ln1_s, p.ln1_b, p.s1, rps,
                                                      p.da, p.ds_rows, p.part, p.dln1_s,
                                                      p.dln1_b, rows, s)) != cudaSuccess)
    return err;
  segment_sum_kernel<<<g.B, 256, 0, s>>>(p.ds_rows, rps, p.ds1);
  segment_sum_kernel<<<g.B, 256, 0, s>>>(p.ds_rows + rows, rps, p.ds2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 5. the attention backward from da (K3's kernel; acc is not written again)
  if ((err = cudaFuncSetAttribute(attention_bwd_regs_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM)) !=
      cudaSuccess)
    return err;
  attention_bwd_regs_kernel<false><<<(unsigned)(n_types * g.heads), BWD_THREADS, K3_SMEM, s>>>(
      p.x, p.da, p.wqkv, p.bqkv, p.wproj, p.bias, p.mask, p.dqkv, nullptr, p.dbias, p.part,
      p.part + (long long)n_types * 3 * C, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = reduce_partials(p.part, n_types, 3LL * C, p.dbqkv, nullptr, s)) != cudaSuccess ||
      (err = reduce_partials(p.part + (long long)n_types * 3 * C, n_types, C, p.dbproj, nullptr,
                             s)) != cudaSuccess)
    return err;

  // 6. dx = bf16(dqkv Wqkv + dx1) (Wqkv (3C, C) the (k, n) operand as it lies);
  // dWqkv = dqkv^T x, dWproj = da^T acc, dW1 = dh^T x1, dW2 = dy2^T GELU(h)
  if ((err = gemm<true, true>(p.dqkv, 3 * C, p.wqkv, C, (int)rows, C, 3 * C, 1, nullptr, p.dx,
                              nullptr, s, p.dx1)) != cudaSuccess ||
      (err = gemm<false, true>(p.dqkv, 3 * C, p.x, C, 3 * C, C, rows,
                               weight_grad_splits(3 * C, C, rows), nullptr, p.dwqkv, p.part, s)) !=
          cudaSuccess ||
      (err = gemm<false, true>(p.da, C, p.acc, C, C, C, rows, weight_grad_splits(C, C, rows),
                               nullptr, p.dwproj, p.part, s)) != cudaSuccess ||
      (err = gemm<false, true>(p.dh, 4 * C, p.x1, C, 4 * C, C, rows,
                               weight_grad_splits(4 * C, C, rows), nullptr, p.dw1, p.part, s)) !=
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

// K12 on `stream`, from g = dL/dout (gy). Scratch: acc_buf, a_buf, x1_buf,
// dy_buf, da_buf (rows, C), act_buf, dh_buf (rows, 4C), dqkv_buf (rows, 3C),
// all bf16; dx1_buf (rows, C) and ds_rows (2 x rows) f32; scratch
// pangu_block_train_bwd_scratch(...) f32. Outputs: dx (rows, C), dwqkv (3C,
// C), dbqkv (3C), dwproj (C, C), dbproj (C), dw1 (4C, C), db1 (4C), dw2 (C,
// 4C), db2 (C) bf16; dbias (n_types, heads, T, T), dln1_s, dln1_b, dln2_s,
// dln2_b (C) and ds1, ds2 (B) f32.
int pangu_block_train_bwd(const void* x, const void* gy, const void* wqkv, const void* bqkv,
                          const void* wproj, const void* bproj, const void* bias,
                          const void* mask, const void* ln1_s, const void* ln1_b, const void* w1,
                          const void* b1, const void* w2, const void* b2, const void* ln2_s,
                          const void* ln2_b, const void* s1, const void* s2, void* acc_buf,
                          void* a_buf, void* x1_buf, void* dy_buf, void* da_buf, void* act_buf,
                          void* dh_buf, void* dqkv_buf, void* dx1_buf, void* ds_rows,
                          void* scratch, void* dx, void* dwqkv, void* dbqkv, void* dwproj,
                          void* dbproj, void* dbias, void* dln1_s, void* dln1_b, void* dw1,
                          void* db1, void* dw2, void* db2, void* dln2_s, void* dln2_b, void* ds1,
                          void* ds2, int B, int Z, int Hp, int W, int C, int heads, int wz,
                          int wh, int ww, float scale, void* stream) {
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
  p.a = static_cast<bf16*>(a_buf);
  p.x1 = static_cast<bf16*>(x1_buf);
  p.dy = static_cast<bf16*>(dy_buf);
  p.da = static_cast<bf16*>(da_buf);
  p.act = static_cast<bf16*>(act_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.dqkv = static_cast<bf16*>(dqkv_buf);
  p.dx1 = static_cast<float*>(dx1_buf);
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
