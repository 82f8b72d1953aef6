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
// across the windows of its program. Here attention_bwd_kernel<false>
// (attention_bwd.cuh, K3's earlier schedule): one CTA per (window type,
// head), as K3, which after each window adds its head's dWqkv slice
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
      rows % GM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const int n_types = (Z / wz) * (Hp / wh);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gy);
  bf16* dq = static_cast<bf16*>(dqkv_buf);
  float* wpart = static_cast<float*>(scratch);
  float* sums = wpart + (long long)n_types * 4 * C * C;

  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<false><<<(unsigned)(n_types * heads), BWD_THREADS, BWD_SMEM, s>>>(
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
