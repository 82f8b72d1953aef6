// Windowed attention for training, bf16 -- CUDA for Hopper (sm_90a): the forward
// and its flash backward.
//
// Replaces pangu_tpu/ops/fused_block_attention.py::fused_block_attention (K2,
// the Pallas kernel _make_kernel, both modes) and its custom-vjp backward
// _backward_pallas (K3, _make_bwd_kernel). On the (rolled, window-padded)
// token grid x (B, Z, Hp, W, C):
//
//   forward   y = bf16(attn(x) @ Wproj^T + bproj), attn as in K1 (window_attention.cuh),
//             the projection on gemm.cuh's wgmma product (Wproj read K-major as
//             it lies, the bias added to the f32 sums before the one rounding)
//   LN mode   y = bf16(x + LN1(attn(x) @ Wproj^T + bproj)), projection, LayerNorm
//             and residual in f32 (with_epilogue=True; K1's token tail without the
//             MLP, mlp_wg.cuh)
//   backward  from the cotangent g of y: dx, dWqkv, dbqkv, dWproj, dbproj, dbias
//             (the LN mode's backward is XLA in the JAX package: no kernel)
//
// with the rounding points of the Pallas bodies: q|k|v, the probabilities fed
// to the products, dO = bf16(g @ Wproj), dS and dqkv are rounded to bf16; p,
// dP, dS for dbias and every sum stay f32. Weights come in nn.Linear's (out,
// in) layout; the weight and bias grads come back in it, rounded to bf16 as
// the Pallas wrapper rounds them to the argument dtype; dbias is f32.
//
// Backward design. The Pallas kernel runs one (z-window, h-window) slab per
// sequential grid step and carries dbias, the weight grads and the dbproj sum
// in VMEM from one step to the next; Hopper's CTAs run in no order, so:
//
//  * attention_bwd_regs_kernel (attention_bwd.cuh): one CTA per (window type,
//    head), 9 warps, looping over the batch and the lon windows of its type
//    (30 outer, 15 inner), so its dbias tile (T x T f32) has one writer. Per
//    window it recomputes that head's q|k|v and dO_h = g @ Wproj[:, head]
//    from the gathered 144 tokens (wmma, 32 channels a stage), then each warp
//    keeps its 16 query rows in mma.sync registers (FlashAttention-2's
//    layout, the m16n8k16 C fragments reused as A fragments): S = q k^T, the
//    f32 softmax, O = P v (-> the acc slab), D = rowsum(dO O), and per 16-key
//    block dP = dO v^T once, dS = p (dP - D) added to the dbias tile held in
//    shared memory across all the CTA's windows (written once at the end),
//    dq += bf16(dS) k. P and dS go to shared memory as bf16 rows, from which
//    warp w forms dk = dS^T q and dv = P^T dO for its 16 key rows. dq|dk|dv go
//    to a bf16 (rows, 3C) slab; the f32 column sums of dq|dk|dv (dbqkv) and
//    of the head's 32 channels of g (dbproj, the stage of the recompute that
//    holds them) are per-(type, head) partials. 213,120 B of shared memory,
//    one CTA per SM.
//  * the products over all rows, gemm.cuh's wgmma kernels: dx = dqkv @ Wqkv,
//    dWqkv = dqkv^T @ x and dWproj = g^T @ acc (split over the rows, f32
//    partials summed in order).
//
// Rounding: as the Pallas body, except D. The body forms rowsum(dP p) from
// the f32 probabilities; here D = rowsum(dO O) with O = P v from the bf16 P
// of the acc slab, equal up to P's rounding (an f32 sum of 144 terms each
// off by at most 2^-9 relative): within the kernel bounds of tests/test_torch_gpu.py.
//
// What bounds it on an H100: the backward of an outer block is ~1.2 TFLOP of
// products (the recomputed forward, dO, the four score-sized products and the
// three deep products) against ~1.5 GB of traffic (x, g, the slabs; dbias
// once): operations. The attention kernel is held by the feed of its 16-row
// mma.sync tiles from shared memory (ldmatrix) and the wmma recompute; the
// products by bytes.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_attention.py; the plain PyTorch versions are
// fused_block_attention_reference and fused_block_attention_bwd_reference there.

#include "attention_bwd.cuh"
#include "mlp_wg.cuh"
#include "gemm.cuh"

namespace {

bool geometry_ok(int B, int Z, int Hp, int W, int C, int heads, int wz, int wh, int ww) {
  const long long rows = (long long)B * Z * Hp * W;
  return wz * wh * ww == T && C == heads * D && C % 64 == 0 && C <= 1024 && B >= 1 &&
         Z % wz == 0 && Hp % wh == 0 && W % ww == 0 && rows % ROW_TILE == 0;
}

}  // namespace

extern "C" {

// K2: y = bf16(attn(x) @ Wproj^T + bproj) on `stream`; attn_buf is (rows, C) bf16
// scratch. Returns a cudaError_t (cudaErrorInvalidValue for a geometry the
// kernels do not take). `mask` may be null.
int pangu_block_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                              const void* wproj, const void* bproj, const void* bias,
                              const void* mask, void* attn_buf, void* out, int B, int Z, int Hp,
                              int W, int C, int heads, int wz, int wh, int ww, float scale,
                              void* stream) {
  if (!geometry_ok(B, Z, Hp, W, C, heads, wz, wh, ww)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const long long windows = (long long)B * (Z / wz) * (Hp / wh) * (W / ww);
  cudaError_t err = launch_window_attention(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), g, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<true, false>(static_cast<const bf16*>(attn_buf), C,
                                static_cast<const bf16*>(wproj), C, (int)(windows * T), C, C, 1,
                                static_cast<const bf16*>(bproj), static_cast<bf16*>(out), nullptr,
                                s);
}

// K2's LN-epilogue mode: y = bf16(x + LN1(attn(x) @ Wproj^T + bproj)) on `stream`;
// attn_buf is (rows, C) bf16 scratch; C 192 or 384. `mask` may be null.
int pangu_block_attention_ln_fwd(const void* x, const void* wqkv, const void* bqkv,
                                 const void* wproj, const void* bproj, const void* bias,
                                 const void* mask, const void* ln_s, const void* ln_b,
                                 void* attn_buf, void* out, int B, int Z, int Hp, int W, int C,
                                 int heads, int wz, int wh, int ww, float scale, void* stream) {
  if (!geometry_ok(B, Z, Hp, W, C, heads, wz, wh, ww) || (C != 192 && C != 384))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const long long windows = (long long)B * (Z / wz) * (Hp / wh) * (W / ww);
  cudaError_t err = launch_window_attention(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), g, scale, s);
  if (err != cudaSuccess) return (int)err;
  const long long rows = windows * T;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ab = static_cast<const bf16*>(attn_buf);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* bp = static_cast<const bf16*>(bproj);
  const float* ls = static_cast<const float*>(ln_s);
  const float* lb = static_cast<const float*>(ln_b);
  bf16* ob = static_cast<bf16*>(out);
  err = (C == 192) ? launch_tail<192, false, false>(rows, s, xb, ab, wp, bp, ls, lb, nullptr,
                                                    nullptr, nullptr, nullptr, nullptr, nullptr,
                                                    nullptr, nullptr, rows, ob)
                   : launch_tail<384, false, false>(rows, s, xb, ab, wp, bp, ls, lb, nullptr,
                                                    nullptr, nullptr, nullptr, nullptr, nullptr,
                                                    nullptr, nullptr, rows, ob);
  return (int)err;
}

// f32 elements of scratch that pangu_block_attention_bwd needs.
long long pangu_block_attention_bwd_scratch(long long rows, int C, int n_types) {
  const long long a = (long long)weight_grad_splits(3 * C, C, rows) * 3 * C * C;
  const long long b = (long long)weight_grad_splits(C, C, rows) * C * C;
  long long n = (long long)n_types * 4 * C;  // the dbqkv and dbproj partials
  if (a > n) n = a;
  if (b > n) n = b;
  return n;
}

// K3: from gy = dL/dy, the grads of K2's inputs, on `stream`. dqkv_buf (rows, 3C)
// and acc_buf (rows, C) are bf16 scratch, scratch has
// pangu_block_attention_bwd_scratch(...) floats. dwqkv (3C, C), dbqkv (3C),
// dwproj (C, C), dbproj (C) are bf16; dbias (n_types, heads, T, T) f32. C 192
// or 384 (the wgmma products take widths in multiples of 192).
int pangu_block_attention_bwd(const void* x, const void* gy, const void* wqkv, const void* bqkv,
                              const void* wproj, const void* bias, const void* mask,
                              void* dqkv_buf, void* acc_buf, void* scratch, void* dx,
                              void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias,
                              int B, int Z, int Hp, int W, int C, int heads, int wz, int wh,
                              int ww, float scale, void* stream) {
  if (!geometry_ok(B, Z, Hp, W, C, heads, wz, wh, ww) || C % WG_BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const int n_types = (Z / wz) * (Hp / wh);
  const long long rows = (long long)B * Z * Hp * W;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gy);
  bf16* dq = static_cast<bf16*>(dqkv_buf);
  bf16* ac = static_cast<bf16*>(acc_buf);
  float* part = static_cast<float*>(scratch);

  cudaError_t err = cudaFuncSetAttribute(attention_bwd_regs_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_regs_kernel<true><<<(unsigned)(n_types * heads), BWD_THREADS, K3_SMEM, s>>>(
      xb, gb, static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
      static_cast<const bf16*>(wproj), static_cast<const float*>(bias),
      static_cast<const float*>(mask), dq, ac, static_cast<float*>(dbias), part,
      part + (long long)n_types * 3 * C, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = reduce_partials(part, n_types, 3LL * C, static_cast<bf16*>(dbqkv), nullptr, s)) !=
          cudaSuccess ||
      (err = reduce_partials(part + (long long)n_types * 3 * C, n_types, C,
                             static_cast<bf16*>(dbproj), nullptr, s)) != cudaSuccess)
    return (int)err;
  // dx = dqkv @ Wqkv: Wqkv (3C, C) is the (k, n) operand as it lies
  if ((err = gemm<true, true>(dq, 3 * C, static_cast<const bf16*>(wqkv), C, (int)rows, C, 3 * C,
                              1, nullptr, static_cast<bf16*>(dx), nullptr, s)) != cudaSuccess)
    return (int)err;
  // dWqkv (3C, C) = dqkv^T @ x, over the rows
  if ((err = gemm<false, true>(dq, 3 * C, xb, C, 3 * C, C, rows,
                               weight_grad_splits(3 * C, C, rows), nullptr,
                               static_cast<bf16*>(dwqkv), part, s)) != cudaSuccess)
    return (int)err;
  // dWproj (C_out, C_in) = g^T @ acc, over the rows
  return (int)gemm<false, true>(gb, C, ac, C, C, C, rows, weight_grad_splits(C, C, rows),
                                nullptr, static_cast<bf16*>(dwproj), part, s);
}

}  // extern "C"
