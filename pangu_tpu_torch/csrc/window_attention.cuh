// The window-attention kernel: per (batch, window, head), softmax(q k^T * scale
// + earth bias (+ shift mask)) @ v with the Pallas body's rounding points
// (pangu_tpu/ops/fused_block_attention.py::_make_kernel):
//
//   q|k|v = bf16(x Wqkv^T + bqkv)                          f32 sums
//   s     = (q k^T) scale + bias[type, head] (+ mask[type])  in that order, f32
//   p     = exp(s - max) / sum                               f32, over all T keys
//   O     = bf16(bf16(p) v)                                   f32 sums
//
// Shared by the inference block (fused_earth_block.cu, K1), the training
// attention forward and its LN mode (block_attention.cu, K2), and the training
// block (fused_block_train.cu: K11, and K12's recompute of the attention
// output), all through launch_window_attention.
//
// Two instantiations. window_attention_kernel<false>, which K2, K2 LN, K11 and
// K12 run, reads window (b, zi, hi, wi) at its own rows. <true>, fold mode,
// which K1 runs on a whole grid, folds the block's cyclic shift and its pad
// rows' re-zero into the addressing:
//
//  * gather: token i = (dz, dh, dw) of rolled-frame window (b, zi, hi, wi) is
//    read at ((zi wz + dz + sz) mod Z, (hi wh + dh + sh) mod Hp,
//    (wi ww + dw + sw) mod W), i.e. from x rolled by -(sz, sh, sw) (the
//    shifted block's -window/2; zeros for an unshifted block); the bias and
//    mask are the rolled frame's window type's, as without the fold;
//  * zero pad rows: a token whose source lat row is >= h is copied as zeros
//    (cp.async with no source bytes), a select and not a product, so a pad
//    row of x may hold anything, NaN included;
//  * store: the token's output row goes to the position it was read from.
//
// The rows wrap at the grid's edges, so the unfolded kernel's copy offsets
// (relative to the window's first row, the same for every window) do not
// hold. Fold mode forms the window's 144 source rows once a CTA into a 576-B
// table beside the ring, from which each thread's copy offsets (within the
// batch image, bit 31 marking a pad row) and its store rows are read. Formed
// per thread and kept in registers through the scores, they spilled 228 B
// against the unfolded 36 and cost 10-18% of the kernel (PERF.md).
//
// Design. A CTA of 9 warps runs one (window, head):
//
//  * the q|k|v product (144 x C) (C x 96) on mma.sync m16n8k16: x and this
//    head's 96 Wqkv rows are staged 64 channels at a time through a
//    three-stage cp.async ring, two chunks in flight ahead of the one
//    multiplied; warp w forms rows 48 (w / 3).. and the 32 columns of q, k
//    or v (w % 3) from ldmatrix fragments (5 ldmatrix per 12 MMAs), adds
//    bqkv to the C fragments and writes bf16 q|k|v to the qkv tile;
//  * each warp then keeps its 16 query rows in registers, in the layout of
//    K3's backward (attention_bwd.cuh; FlashAttention-2's): S as 18 n8 tiles
//    (72 f32 a thread), each tile scaled and given its bias (and mask) from
//    8-byte loads right after its MMAs; the softmax over all 144 keys in one
//    pass (T is small: no online rescaling, the Pallas rounding point of p),
//    row max and sum through quad shuffles; P packed to bf16 A fragments in
//    registers, v's B fragments by ldmatrix.trans; O from the C fragments to
//    the head's 32 columns of the (rows, C) bf16 output. No score or
//    probability goes to shared memory.
//
// Shared memory: a ring of three stages of 34,560 B, 103,680 B, the q|k|v
// tile (29,952 B) written over it (fold mode: 576 B more); two CTAs (18
// warps) per SM, at 96 registers a thread (five warps per SM quarter).
//
// What bounds it on an H100: the products, 2 T C 96 + 4 T T 32 FLOP per
// (window, head) (0.18 / 0.155 ms at the outer / inner stage at the bf16
// peak), against x and Wqkv read per (window, head) from the L2 and the f32
// bias (and mask) tile of its type: mma.sync from ldmatrix fragments and the L2
// feed hold it well above that.

#pragma once

#include "common.cuh"

namespace {

// ---- window attention --------------------------------------------------------
constexpr int ATT_WARPS = T / 16;               // one 16-row query tile per warp
constexpr int ATT_THREADS = ATT_WARPS * 32;     // 288
constexpr int QKV_LD = 3 * D + 8;               // bf16 row stride of the q|k|v tile
constexpr int KC = 64;                          // x channels staged per step
constexpr int XS_LD = KC + 8;
constexpr int WT_LD = KC + 8;                   // row stride of a staged (96, KC) Wqkv chunk
constexpr int XS_ELEMS = T * XS_LD;             // x chunk, then the Wqkv chunk
constexpr int ATT_STAGE_ELEMS = XS_ELEMS + 3 * D * WT_LD;  // 34,560 B per stage
constexpr int ATT_STAGES = 3;
constexpr int QKV_BYTES = T * QKV_LD * 2;       // 29,952 B
// the q|k|v tile is written over the ring once its last chunk is read
constexpr int ATT_SMEM = cmax(ATT_STAGES * ATT_STAGE_ELEMS * 2, QKV_BYTES);  // 103,680 B

static_assert(ATT_WARPS == 9 && T == 3 * 48, "3 x 3 warps tile the q|k|v product");
static_assert(T * (KC / 8) == 4 * ATT_THREADS && 3 * D * (KC / 8) <= 3 * ATT_THREADS &&
                  ATT_THREADS % (KC / 8) == 0,
              "a thread's copies of a chunk: 4 of x, at most 3 of Wqkv, one column");
static_assert(QKV_BYTES % 128 == 0 && (ATT_STAGE_ELEMS * 2) % 128 == 0, "aligned tiles");
static_assert(2 * (ATT_SMEM + 1024) <= 233472, "two CTAs per SM");
// fold mode: the window's source rows (T x 4 B) beside the ring
constexpr int ATT_SMEM_FOLDED = ATT_SMEM + T * 4;
static_assert(2 * (ATT_SMEM_FOLDED + 1024) <= 233472, "two CTAs per SM, folded");

template <bool Folded>
__global__ void __launch_bounds__(ATT_THREADS, 2)
window_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ attn_out,
                        Geom g, float scale, Fold f) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qkv = ring;  // after the last chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int zn = g.Z / g.wz, hn = g.Hp / g.wh, wn = g.W / g.ww;
  const int C = g.C, nc = C / KC;
  const int head = blockIdx.x % g.heads;
  const int idx = blockIdx.x / g.heads;  // ((b zn + zi) hn + hi) wn + wi
  const int type = (idx / wn) % (zn * hn);
  // the window b wn + wi of its type; b and wi are formed from it where they
  // are used (kept live from the start, they or the window's 64-bit offset
  // cost 170-200 B of spills against 36 and up to 16%; PERF.md)
  const int win = idx / (wn * zn * hn) * wn + idx % wn;
  const int zi = type / hn, hi = type - zi * hn;

  // chunk `chunk` of the ring: KC channels of the window's x rows and the same
  // channels of this head's 96 Wqkv rows (its q, k and v outputs). Thread i
  // copies the 16 bytes at column 8 (i % 8) of x rows (i + 288 k) / 8, k < 4,
  // and of Wqkv rows (i + 288 k) / 8 below 96. The element offsets of those
  // rows are formed once, from the window's first row: 32-bit (the caller
  // checks wz Hp W C < 2^31, which bounds an x row's offset in its window).
  const int cv = (threadIdx.x % (KC / 8)) * 8;
  uint32_t xrel[4], woff[3];
  // folded: the offsets come from the window's source-row table (see the
  // header), within the batch image (the caller checks Z Hp W C < 2^31), bit
  // 31 kept: a pad row is copied as zeros
  uint32_t* const src_rows = reinterpret_cast<uint32_t*>(smem + ATT_SMEM);
  if constexpr (Folded) {
    if (threadIdx.x < T) src_rows[threadIdx.x] = folded_row(g, f, zi, hi, idx % wn, threadIdx.x);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t r = src_rows[(threadIdx.x + ATT_THREADS * k) / (KC / 8)];
      xrel[k] = ((r & 0x7fffffffu) * C + cv) | (r & 0x80000000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      xrel[k] = (uint32_t)((token_row(g, 0, 0, 0, 0, (threadIdx.x + ATT_THREADS * k) / (KC / 8)) *
                            C) + cv);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int r = (threadIdx.x + ATT_THREADS * k) / (KC / 8), sg = r / D;
    woff[k] = (uint32_t)((sg * C + head * D + r - sg * D) * C + cv);
  }
  auto load = [&](int chunk, bf16* st) {
    const int k0 = chunk * KC;
    if constexpr (Folded) {
      const bf16* xb = x + (long long)(win / wn) * g.Z * g.Hp * g.W * C + k0;  // the batch image
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = (threadIdx.x + ATT_THREADS * k) / (KC / 8);
        cp_async16_zfill(st + t * XS_LD + cv, xb + (xrel[k] & 0x7fffffffu),
                         (xrel[k] >> 31) ? 0u : 16u);
      }
    } else {
      const int b = win / wn, wi = win - b * wn;
      const bf16* xw = x + token_row(g, b, zi, hi, wi, 0) * C + k0;  // the window's first row
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = (threadIdx.x + ATT_THREADS * k) / (KC / 8);
        cp_async16(st + t * XS_LD + cv, xw + xrel[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int r = (threadIdx.x + ATT_THREADS * k) / (KC / 8);
      if (r < 3 * D) cp_async16(st + XS_ELEMS + r * WT_LD + cv, wqkv + woff[k] + k0);
    }
  };

  const int rg = warp / 3, seg = warp - 3 * rg;  // q|k|v: rows 48 rg.., columns of q, k or v
  const int q0 = warp * 16;                       // scores: the warp's query rows
  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T + 2 * tq;
  const float* mask_rows = mask ? mask + ((long long)type * T + q0) * T + 2 * tq : nullptr;
  // the ring: ATT_STAGES - 1 chunks in flight ahead of the one multiplied
  // (one commit group per chunk, empty past the last)
  for (int p = 0; p < ATT_STAGES - 1; ++p) {
    if (p < nc) load(p, ring + p * ATT_STAGE_ELEMS);
    cp_async_commit();
  }
  {
    float acc[3][4][4] = {};
    for (int chunk = 0; chunk < nc; ++chunk) {
      const int ahead = chunk + ATT_STAGES - 1;
      if (ahead < nc) load(ahead, ring + (ahead % ATT_STAGES) * ATT_STAGE_ELEMS);
      cp_async_commit();
      cp_async_wait<ATT_STAGES - 1>();
      __syncthreads();
      const bf16* st = ring + (chunk % ATT_STAGES) * ATT_STAGE_ELEMS;
      // ---- q|k|v += x chunk (rows 48 rg..) Wqkv chunk^T (the 32 rows of seg)
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[3][4], w[2][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(a[i], afrag_at(st, XS_LD, 48 * rg + 16 * i, 16 * kk, lane));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          ldsm_x4(w[nb], bfrag_nk(st + XS_ELEMS, WT_LD, D * seg + 16 * nb, 16 * kk, lane));
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            mma_bf16(acc[i][f], a[i], w[f >> 1][2 * (f & 1)], w[f >> 1][2 * (f & 1) + 1]);
      }
      __syncthreads();  // the stage is read: the next load (or the q|k|v tile) may overwrite it
    }

    // ---- bf16(q|k|v + bqkv) -> the qkv tile
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int col = D * seg + 8 * f + 2 * tq;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bqkv + seg * C + head * D + 8 * f + 2 * tq));
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(qkv + (48 * rg + 16 * i + gq + 8 * h) * QKV_LD + col) =
              __floats2bfloat162_rn(acc[i][f][2 * h] + bb.x, acc[i][f][2 * h + 1] + bb.y);
    }
    __syncthreads();  // q|k|v of every row are in place
  }

  const int b = win / wn, wi = win - b * wn;

  // ---- S = q k^T of the warp's 16 rows, then s = S scale + bias (+ mask)
  float s[T / 8][4];
  {
    uint32_t qa[2][4];
#pragma unroll
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
#pragma unroll
      for (int j = 2 * nb; j < 2 * nb + 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 bv =
              __ldg(reinterpret_cast<const float2*>(bias_rows + (gq + 8 * h) * T + 8 * j));
          s[j][2 * h] = s[j][2 * h] * scale + bv.x;
          s[j][2 * h + 1] = s[j][2 * h + 1] * scale + bv.y;
          if (mask_rows) {
            const float2 mv =
                __ldg(reinterpret_cast<const float2*>(mask_rows + (gq + 8 * h) * T + 8 * j));
            s[j][2 * h] += mv.x;
            s[j][2 * h + 1] += mv.y;
          }
        }
    }
  }
  // ---- p = exp(s - max) / sum over the 144 keys of each row (gq, gq + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < T / 8; ++j) m = fmaxf(m, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
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
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      s[j][2 * h] /= sum;
      s[j][2 * h + 1] /= sum;
    }
  }
  // ---- O = bf16(p) v: P from the score registers, v by ldmatrix.trans
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
    // folded: at the position the token was read from (a pad row too)
    bf16* row;
    if constexpr (Folded)
      row = attn_out +
            ((long long)b * g.Z * g.Hp * g.W + (src_rows[q0 + gq + 8 * h] & 0x7fffffffu)) * C +
            head * D + 2 * tq;
    else
      row = attn_out + token_row(g, b, zi, hi, wi, q0 + gq + 8 * h) * C + head * D + 2 * tq;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
      *reinterpret_cast<uint32_t*>(row + 8 * nn) = pack_bf16(o[nn][2 * h], o[nn][2 * h + 1]);
  }
}

// CTAs of window_attention_kernel at geometry g.
inline long long window_attention_ctas(const Geom& g) {
  return (long long)g.B * (g.Z / g.wz) * (g.Hp / g.wh) * (g.W / g.ww) * g.heads;
}

template <bool Folded>
inline cudaError_t launch_window_attention_as(const bf16* x, const bf16* wqkv, const bf16* bqkv,
                                              const float* bias, const float* mask, bf16* attn,
                                              const Geom& g, float scale, const Fold& f,
                                              cudaStream_t stream) {
  constexpr int smem = Folded ? ATT_SMEM_FOLDED : ATT_SMEM;
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<Folded>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(window_attention_kernel<Folded>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  window_attention_kernel<Folded>
      <<<(unsigned)window_attention_ctas(g), ATT_THREADS, smem, stream>>>(
          x, wqkv, bqkv, bias, mask, attn, g, scale, f);
  return cudaGetLastError();
}

// The attention output (rows, C) bf16 of x on `stream` (C a multiple of KC,
// wz Hp W C below 2^31); `mask` may be null. With `fold` (K1 on a whole grid)
// the folded instantiation reads x rolled by -(sz, sh, sw) with its lat rows
// >= h as zeros and stores each token's output where it was read (each shift
// in [0, its window dim), 1 <= h <= Hp, Z Hp W C below 2^31); without it, the
// unfolded one, which every other caller runs.
inline cudaError_t launch_window_attention(const bf16* x, const bf16* wqkv, const bf16* bqkv,
                                           const float* bias, const float* mask, bf16* attn,
                                           const Geom& g, float scale, cudaStream_t stream,
                                           const Fold* fold = nullptr) {
  if (g.C % KC || (long long)g.wz * g.Hp * g.W * g.C >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (!fold)
    return launch_window_attention_as<false>(x, wqkv, bqkv, bias, mask, attn, g, scale, Fold{},
                                             stream);
  const Fold& f = *fold;
  if ((long long)g.Z * g.Hp * g.W * g.C >= (1LL << 31) || f.sz < 0 || f.sz >= g.wz ||
      f.sh < 0 || f.sh >= g.wh || f.sw < 0 || f.sw >= g.ww || f.h < 1 || f.h > g.Hp)
    return cudaErrorInvalidValue;
  return launch_window_attention_as<true>(x, wqkv, bqkv, bias, mask, attn, g, scale, f, stream);
}

}  // namespace
