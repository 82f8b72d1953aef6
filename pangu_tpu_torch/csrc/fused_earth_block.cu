// Whole Earth-Specific transformer block, inference, bf16 -- CUDA for Hopper (sm_90a).
//
// Replaces pangu_tpu/ops/fused_block_attention.py::fused_earth_block (the Pallas
// megakernel _block_forward / _make_kernel(with_epilogue=True, with_mlp=True)).
// One call computes, on the window-padded token grid x (B, Z, Hp, W, C) read
// as the block sees it (see Fold mode below):
//
//   qkv = x @ Wqkv + bqkv                                  (per window, bf16)
//   a   = softmax(q k^T * scale + bias[type, head] (+ mask[type])) @ v   (f32 softmax)
//   x1  = x + LN1(a @ Wproj + bproj)                       (f32)
//   out = x1 + LN2(bf16(GELU(bf16(x1) @ W1 + b1)) @ W2 + b2)   -> bf16
//
// with the rounding points of the Pallas body: qkv, the probabilities, the
// attention output and the GELU hidden are rounded to bf16; x1 stays f32 and
// only the MLP input is rounded; LayerNorm uses E[y^2] - mu^2 and eps 1e-5.
// The weights come in nn.Linear's (out, in) layout -- Wqkv (3C, C), Wproj (C, C),
// W1 (4C, C), W2 (C, 4C) -- and are read as column-major B fragments, so the
// caller passes the module's parameters (cast to bf16) without a transpose.
//
// What bounds it on an H100: an outer-stage block (8 x 186 x 360 grid, C = 192,
// 6 heads, 124 window types x 30 lon windows of T = 144 tokens) is about
// 533 GFLOP of matmul against about 0.5 GB of compulsory HBM traffic (x in and
// out, 206 MB each in bf16; the f32 earth bias, 61.7 MB). That is ~1000 FLOP per
// byte, far above the card's ~295 FLOP/B ridge: the block is bound by the tensor
// cores, not by memory. The split below adds one bf16 round trip of the
// attention output (2 x 206 MB), which keeps it compute-bound.
//
// Design. The Pallas kernel keeps a whole (wz, wh, W, C) slab in VMEM (1.66 MB at
// the outer stage); a CTA has at most 227 KB of shared memory, so the block is
// two kernels instead:
//
//  * window_attention_kernel (window_attention.cuh, where its design is
//    described; shared with K2, K2's LN mode, K11 and K12, which run its
//    unfolded instantiation): one CTA per (batch, window, head), 9 warps. It
//    gathers the window's 144 tokens straight from the grid by index (no
//    partition transpose; in fold mode at their shifted, wrapped positions),
//    forms that head's q, k, v (144 x 32 each) on mma.sync from a three-stage
//    cp.async ring, then each warp keeps its 16 query rows' scores, f32
//    softmax and bf16 probabilities in registers and forms P @ v, and stores
//    the head's 32 columns of a bf16 (B, Z, Hp, W, C) attention-output buffer.
//    Consecutive CTAs are the heads of one window and then the lon windows of
//    one type, so a window's x rows and a (type, head) bias tile are reused
//    from L2 (the bias tile by the 30 or 15 lon windows of its type).
//    103,680 B of shared memory: two CTAs per SM.
//  * mlp_tail_kernel<C, true, true, false> (mlp_wg.cuh, the token tail, shared
//    with the training block K11, K2's LN mode and the MLP tail K6): a
//    persistent CTA per SM walks 64-row tiles of the flattened grid. A
//    producer warp loads the tile's attention output by TMA and streams
//    64-channel chunks of Wproj, then 64-column chunks of W1 and W2, through
//    a ring of mbarrier-guarded slots; two consumer warpgroups each own half
//    of the C output columns on wgmma: the out-projection, LN1 and the f32
//    residual x1 (kept per thread in a local array), bf16(x1) into shared
//    memory as the MLP input, then the MLP streamed over 64-column chunks of
//    the 4C hidden (h on wgmma, GELU in registers, the bf16 hidden tile in
//    shared memory, y accumulated on wgmma), so the (64, 4C) hidden never
//    exists whole; then LN2 and the final residual in f32. The LayerNorm row
//    statistics add both warpgroups' halves in a fixed order.
//
// Fold mode (a whole grid: every block of the forecast step). A shifted block
// sees its input rolled by -(wz/2, wh/2, ww/2), and every block sees the pad
// lat rows (>= h, the stage's real rows) as zeros. Both are token addresses,
// not passes over the grid: the attention kernel's folded instantiation reads
// token i of rolled-frame window (zi, hi, wi) at ((zi wz + dz + sz) mod Z,
// (hi wh + dh + sh) mod Hp, (wi ww + dw + sw) mod W), copies a pad row as
// zeros (cp.async with no source bytes, never a product, so whatever a pad row
// of x holds does not reach a real row), and stores the token's output at the
// position it read; the bias and mask tiles are the rolled frame's window
// type's. The tail then works row by row on the un-rolled x and attention
// output, so `out` is the block's output in the un-rolled frame. Its real rows
// are the bits of the unfolded route (re-zero, roll, this call, roll back): the
// same tokens in the same order within each window. Its pad rows hold values
// the caller discards (the next block reads them as zeros, the layer crops
// them).
//
// The attention kernel's products are mma.sync m16n8k16 (bf16, f32
// accumulate) from ldmatrix fragments of tiles staged by cp.async; the tail's
// are wgmma from TMA tiles; the weights are shared by every CTA and come from
// L2.

// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_attention.py; the plain PyTorch version of the
// same function is fused_earth_block_reference there.

#include "mlp_wg.cuh"
#include "window_attention.cuh"

extern "C" {

// Runs the whole block on `stream`. Returns a cudaError_t: cudaErrorInvalidValue
// for a geometry the kernels do not take, else the launch status of the last
// kernel (cudaGetLastError after each launch). `mask` may be null. (sz, sh, sw)
// is the block's shift (each in [0, its window dim)) and h its real lat rows
// (1..Hp); a shift or h < Hp runs the attention folded (see the header).
int pangu_fused_earth_block(const void* x, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, const void* bias,
                            const void* mask, const void* ln1_s, const void* ln1_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* ln2_s, const void* ln2_b, void* attn_buf, void* out,
                            int B, int Z, int Hp, int W, int C, int heads, int wz, int wh,
                            int ww, int sz, int sh, int sw, int h, float scale,
                            void* stream) {
  if (wz * wh * ww != T || C != heads * D || (C != 192 && C != 384) || B < 1 ||
      Z % wz || Hp % wh || W % ww)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const long long windows = (long long)B * (Z / wz) * (Hp / wh) * (W / ww);
  const Fold fold{sz, sh, sw, h};
  const bool folded = sz || sh || sw || h != Hp;

  cudaError_t err = launch_window_attention(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), g, scale, s,
      folded ? &fold : nullptr);
  if (err != cudaSuccess) return (int)err;

  const long long rows = windows * T;
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
  bf16* ob = static_cast<bf16*>(out);
  err = (C == 192) ? launch_tail<192, false>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b,
                                             b2b, l2s, l2b, nullptr, nullptr, rows, ob)
                   : launch_tail<384, false>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b,
                                             b2b, l2s, l2b, nullptr, nullptr, rows, ob);
  return (int)err;
}

}  // extern "C"