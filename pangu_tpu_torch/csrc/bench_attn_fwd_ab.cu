// Attention-forward A/B over fat windows -- CUDA for Hopper (sm_90a).
//
// Replaces the `batched`, `dbl` and `quad` variants of scripts/bench_attn_fwd_ab.py
// (S1, the Pallas body _make_kernel run by _variant_call; `shipped` is K2,
// block_attention.cu). On the outer-stage grid x (B, Z, Hp, W, 192), 6 heads,
// window (2, 6, 12), a fat window is NW consecutive lon windows, its TN = NW x
// 144 tokens in the order of the contiguous (wz, wh, NW x ww) slice (the NW
// windows interleaved ww tokens at a time). Per fat window and head:
//
//   qkv = bf16(x @ Wqkv^T + bqkv)
//   p   = bf16(softmax(q k^T * scale + bias[type, head]))   (TN x TN, f32 softmax)
//   a   = bf16(p v)
//   y   = bf16(a @ Wproj^T + bproj)
//
// with bias the (n_types, 6, TN, TN) f32 table that holds the earth bias on
// pairs of one window and -1e9 on cross-window pairs, so their probabilities
// are exactly 0: the result is K2's, at NW x the score work (the cost the TPU
// A/B weighed against fatter matrix-unit tiles). Every key tile is scored,
// the all -1e9 ones too.
//
// Design: fat_attention_kernel<NW>, on the engine of K2's window attention
// (window_attention.cuh). One CTA per fat window, 9 warps, looping over the
// six heads; the CTAs of one window type are adjacent in the grid, so its
// fat windows share the type's bias tiles in the L2 (one type's six heads
// are 8 MB at NW = 4).
//
//  * q|k|v on mma.sync m16n8k16 from ldmatrix fragments: the head's 96 Wqkv
//    rows are staged once per head (38,400 B, cp.async, loaded during the
//    previous head's attention) and serve all TN rows; warp (rg, seg) forms
//    rows 48 rg.. of each 144-row block and the 32 columns of q, k or v,
//    adds bqkv to the C fragments and writes bf16 q|k|v to the (TN, 96) tile.
//    At NW = 1 (`batched`) and NW = 2 the fat window's x rows stay in shared
//    memory for all six heads (57,600 / 115,200 B); at NW = 4 they do not
//    fit beside the head's q|k|v (119,808 B) and stream per head from the L2
//    in (144 rows, 64 channels) chunks through a three-stage ring.
//  * The scores as in K2: each warp keeps 16 query rows at a time in
//    registers, S of a 144-key block as 18 n8 tiles (72 f32 a thread), each
//    tile scaled and given its bias from 8-byte loads right after its MMAs,
//    row max and sum through quad shuffles, P packed to bf16 A fragments, v
//    by ldmatrix.trans. No score or probability goes to shared memory.
//  * Register budget: at NW = 1 the 144 keys fit and one softmax pass forms
//    p. At NW >= 2 a row's TN scores do not (144 or 288 f32 a thread against
//    the 168 registers of a 9-warp CTA), so a first pass over the NW key
//    blocks keeps the row max and sum online (a block's max rescales the
//    running sum; a block of cross-window keys alone would set a max near
//    -1e9 that the next real block rescales away exactly), and a second pass
//    recomputes the scores and forms p = exp(s - max) (1 / sum), rounded to
//    bf16 before p v: the Pallas rounding point of p (the product by the
//    reciprocal differs from the quotient by at most an f32 ulp before that
//    rounding), at twice the q k^T products.
//
// The attention output goes to a (rows, C) bf16 buffer and the projection is
// K2's (gemm.cuh's wgmma product with its bias), so the variants differ from
// `shipped` in the attention schedule only.
//
// Shared memory: x (resident, or the ring), the head's Wqkv rows and the q|k|v
// tile: 125,952 / 213,504 / 220,416 B at NW = 1 / 2 / 4, one CTA per SM.
//
// What bounds it on an H100: the products, 8 rows C^2 + 4 rows TN C FLOP (the
// score work grows with NW; the second pass adds 2 rows TN C), against x in
// and out and the bias table (0.99 GB at NW = 4, more than x, read twice from
// the L2 at NW >= 2); the exp of every score (NW x K2's, twice at NW >= 2)
// on the SFU.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_attn_fwd_ab.py; the plain PyTorch version is
// fat_attention_reference there.

#include "gemm.cuh"

namespace {

constexpr int FC = 192;                  // channels (the outer stage)
constexpr int FH = FC / D;               // heads
constexpr int F_WARPS = T / 16;
constexpr int F_THREADS = F_WARPS * 32;  // 288
constexpr int FX_LD = FC + 8;            // resident x rows and the head's Wqkv rows
constexpr int FQ_LD = 3 * D + 8;         // q|k|v tile rows
constexpr int FKC = 64;                  // channels of a streamed x chunk (NW = 4)
constexpr int FXS_LD = FKC + 8;
constexpr int F_STAGES = 3;
constexpr int FW_BYTES = 3 * D * FX_LD * 2;  // 38,400 B

template <int NW>
struct FatLayout {
  static constexpr int TN = NW * T;
  static constexpr bool RESIDENT = NW <= 2;  // x stays for all six heads
  static constexpr int X_BYTES = RESIDENT ? TN * FX_LD * 2 : F_STAGES * T * FXS_LD * 2;
  static constexpr int W_OFF = X_BYTES;
  static constexpr int QKV_OFF = W_OFF + FW_BYTES;
  static constexpr int SMEM = QKV_OFF + TN * FQ_LD * 2;
  static constexpr int CHUNKS = NW * (FC / FKC);  // streamed chunks per head
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
  static_assert(X_BYTES % 128 == 0 && FW_BYTES % 128 == 0, "aligned tiles");
};
static_assert(F_WARPS == 9 && T == 3 * 48, "3 x 3 warps tile a 144-row block of q|k|v");

// Grid row of token i of fat window (b, zi, hi, wf) of NW lon windows: the
// contiguous (wz, wh, NW ww) slice in (z, h, w) order.
__device__ __forceinline__ long long fat_row(const Geom& g, int b, int zi, int hi, int wf,
                                             int nw, int i) {
  const int wwn = nw * g.ww;
  const int zh = i / wwn, r = i - zh * wwn;
  const int dz = zh / g.wh, dh = zh - dz * g.wh;
  return ((long long)(b * g.Z + zi * g.wz + dz) * g.Hp + hi * g.wh + dh) * g.W + wf * wwn + r;
}

// s = (q k^T) scale + bias for the warp's 16 query rows (qa) and the 144 keys
// of block kb (18 n8 tiles), the bias from the rows' entries of the table.
template <int TN>
__device__ __forceinline__ void fat_scores(float (&s)[T / 8][4], const uint32_t (&qa)[2][4],
                                           const bf16* qkv, const float* brow, int kb,
                                           float scale, int lane) {
#pragma unroll
  for (int nb = 0; nb < T / 16; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * nb][e] = s[2 * nb + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, bfrag_nk(qkv, FQ_LD, kb * T + 16 * nb, D + 16 * kk, lane));
      mma_bf16(s[2 * nb], qa[kk], kf[0], kf[1]);
      mma_bf16(s[2 * nb + 1], qa[kk], kf[2], kf[3]);
    }
#pragma unroll
    for (int j = 2 * nb; j < 2 * nb + 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bv =
            __ldg(reinterpret_cast<const float2*>(brow + h * 8 * TN + kb * T + 8 * j));
        s[j][2 * h] = s[j][2 * h] * scale + bv.x;
        s[j][2 * h + 1] = s[j][2 * h + 1] * scale + bv.y;
      }
  }
}

template <int NW>
__global__ void __launch_bounds__(F_THREADS, 1)
fat_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                     const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                     bf16* __restrict__ attn_out, Geom g, float scale) {
  using L = FatLayout<NW>;
  constexpr int TN = L::TN, C = FC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + L::W_OFF);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L::QKV_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int hn = g.Hp / g.wh, wfn = g.W / (g.ww * NW);
  const int wf = blockIdx.x % wfn;  // type-major: ((type B + b) wfn + wf)
  const int b = blockIdx.x / wfn % g.B, type = blockIdx.x / wfn / g.B;
  const int zi = type / hn, hi = type - zi * hn;

  auto load_w = [&](int head) {  // the head's q, k and v rows of Wqkv, all C channels
    for (int v = threadIdx.x; v < 3 * D * (C / 8); v += F_THREADS) {
      const int r = v / (C / 8), cv = (v - r * (C / 8)) * 8, seg = r / D;
      cp_async16(ws + r * FX_LD + cv,
                 wqkv + (long long)(seg * C + head * D + r - seg * D) * C + cv);
    }
  };
  auto load_chunk = [&](int c) {  // NW = 4: x rows 144 blk.., channels 64 kc.. -> stage c % 3
    const int blk = c / (C / FKC), k0 = (c - blk * (C / FKC)) * FKC;
    bf16* st = xs + (c % F_STAGES) * T * FXS_LD;
    for (int v = threadIdx.x; v < T * (FKC / 8); v += F_THREADS) {
      const int t = v / (FKC / 8), cv = (v - t * (FKC / 8)) * 8;
      cp_async16(st + t * FXS_LD + cv,
                 x + fat_row(g, b, zi, hi, wf, NW, blk * T + t) * C + k0 + cv);
    }
  };
  // one commit group per ring chunk; the head's Wqkv rows ride with its first
  auto start_head = [&](int head) {
    load_w(head);
    if (!L::RESIDENT) {
      load_chunk(0);
      cp_async_commit();
      load_chunk(1);
    }
    cp_async_commit();
  };

  if (L::RESIDENT)  // the fat window's x rows, once for all heads (with head 0's group)
    for (int v = threadIdx.x; v < TN * (C / 8); v += F_THREADS) {
      const int t = v / (C / 8), cv = (v - t * (C / 8)) * 8;
      cp_async16(xs + t * FX_LD + cv, x + fat_row(g, b, zi, hi, wf, NW, t) * C + cv);
    }
  start_head(0);

  const int rg = warp / 3, seg = warp - 3 * rg;  // q|k|v: rows 48 rg.., columns of q, k or v
  for (int head = 0; head < FH; ++head) {
    if (L::RESIDENT) {
      cp_async_wait<0>();
      __syncthreads();
    }
    // ---- q|k|v of the TN rows, one 144-row block at a time
    for (int blk = 0; blk < NW; ++blk) {
      float acc[3][4][4] = {};
      for (int kc = 0; kc < C / FKC; ++kc) {
        const bf16* xa;
        int xld, xc;
        if (L::RESIDENT) {
          xa = xs + blk * T * FX_LD;
          xld = FX_LD;
          xc = kc * FKC;
        } else {
          const int c = blk * (C / FKC) + kc;
          if (c + 2 < L::CHUNKS) load_chunk(c + 2);
          cp_async_commit();
          cp_async_wait<2>();
          __syncthreads();
          xa = xs + (c % F_STAGES) * T * FXS_LD;
          xld = FXS_LD;
          xc = 0;
        }
#pragma unroll
        for (int kk = 0; kk < FKC / 16; ++kk) {
          uint32_t a[3][4], w[2][4];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            ldsm_x4(a[i], afrag_at(xa, xld, 48 * rg + 16 * i, xc + 16 * kk, lane));
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            ldsm_x4(w[nb], bfrag_nk(ws, FX_LD, D * seg + 16 * nb, kc * FKC + 16 * kk, lane));
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int f = 0; f < 4; ++f)
              mma_bf16(acc[i][f], a[i], w[f >> 1][2 * (f & 1)], w[f >> 1][2 * (f & 1) + 1]);
        }
        if (!L::RESIDENT) __syncthreads();  // the stage is read: a later chunk may overwrite it
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int col = D * seg + 8 * f + 2 * tq;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bqkv + seg * C + head * D + 8 * f + 2 * tq));
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                qkv + (blk * T + 48 * rg + 16 * i + gq + 8 * h) * FQ_LD + col) =
                __floats2bfloat162_rn(acc[i][f][2 * h] + bb.x, acc[i][f][2 * h + 1] + bb.y);
      }
    }
    __syncthreads();  // q|k|v of every row in place; the Wqkv rows (and the ring) are free
    if (head + 1 < FH) start_head(head + 1);  // lands during this head's attention

    // ---- the warp's 16-row query tiles against all TN keys
    const float* bias_h = bias + (long long)(type * FH + head) * TN * TN;
    for (int qt = warp; qt < TN / 16; qt += F_WARPS) {
      const int q0 = qt * 16;
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], afrag_at(qkv, FQ_LD, q0, 16 * kk, lane));
      const float* brow = bias_h + (long long)(q0 + gq) * TN + 2 * tq;
      float s[T / 8][4], m[2], l[2];
      if constexpr (NW == 1) {  // one pass: p = exp(s - max) / sum over the 144 keys
        fat_scores<TN>(s, qa, qkv, brow, 0, scale, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < T / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < T / 8; ++j) {
            s[j][2 * h] = expf(s[j][2 * h] - mx);
            s[j][2 * h + 1] = expf(s[j][2 * h + 1] - mx);
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
      } else {  // pass 1: the row max m and sum l of exp(s - m), online over the key blocks
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h] = -INFINITY, l[h] = 0.f;
#pragma unroll 1
        for (int kb = 0; kb < NW; ++kb) {
          fat_scores<TN>(s, qa, qkv, brow, kb, scale, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = m[h];
#pragma unroll
            for (int j = 0; j < T / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < T / 8; ++j)
              sum += expf(s[j][2 * h] - mx) + expf(s[j][2 * h + 1] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[h] = l[h] * expf(m[h] - mx) + sum;
            m[h] = mx;
          }
        }
      }
      // ---- O = bf16(p) v; at NW >= 2 pass 2 recomputes each block's p
      float o[4][4] = {};
      if constexpr (NW > 1) l[0] = 1.f / l[0], l[1] = 1.f / l[1];
#pragma unroll 1
      for (int kb = 0; kb < NW; ++kb) {
        if constexpr (NW > 1) {
          fat_scores<TN>(s, qa, qkv, brow, kb, scale, lane);
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) * l[e >> 1];
        }
#pragma unroll
        for (int kt = 0; kt < T / 16; ++kt) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                  pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                  pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                  pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
          for (int dn = 0; dn < 2; ++dn) {
            uint32_t vb[4];
            ldsm_x4_t(vb, bfrag_kn(qkv, FQ_LD, kb * T + 16 * kt, 2 * D + 16 * dn, lane));
            mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
            mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* row = attn_out + fat_row(g, b, zi, hi, wf, NW, q0 + gq + 8 * h) * C + head * D +
                    2 * tq;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          *reinterpret_cast<uint32_t*>(row + 8 * nn) = pack_bf16(o[nn][2 * h], o[nn][2 * h + 1]);
      }
    }
    __syncthreads();  // this head's q|k|v is read: the next head overwrites it
  }
}

template <int NW>
cudaError_t launch_fat(const Geom& g, const bf16* x, const bf16* wqkv, const bf16* bqkv,
                       const float* bias, bf16* attn, float scale, cudaStream_t s) {
  using L = FatLayout<NW>;
  if (g.W % (g.ww * NW)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fat_attention_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)g.B * (g.Z / g.wz) * (g.Hp / g.wh) * (g.W / (g.ww * NW));
  fat_attention_kernel<NW><<<(unsigned)ctas, F_THREADS, L::SMEM, s>>>(x, wqkv, bqkv, bias, attn,
                                                                       g, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fat-window variant (nw 1, 2 or 4) on `stream`: y = bf16(attn(x) @ Wproj^T
// + bproj) with the (n_types, 6, nw 144, nw 144) f32 bias table; attn_buf is
// (rows, C) bf16 scratch. C 192 and 6 heads, 144-token windows, W a multiple of
// nw ww and rows of 64, else cudaErrorInvalidValue.
int pangu_attn_fat_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                       const void* bproj, const void* bias, void* attn_buf, void* out, int nw,
                       int B, int Z, int Hp, int W, int C, int heads, int wz, int wh, int ww,
                       float scale, void* stream) {
  const long long rows = (long long)B * Z * Hp * W;
  if (C != FC || heads != FH || wz * wh * ww != T || B < 1 || Z % wz || Hp % wh || W % ww ||
      rows % ROW_TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* bq = static_cast<const bf16*>(bqkv);
  const float* bi = static_cast<const float*>(bias);
  bf16* ab = static_cast<bf16*>(attn_buf);
  cudaError_t err;
  switch (nw) {
    case 1: err = launch_fat<1>(g, xb, wq, bq, bi, ab, scale, s); break;
    case 2: err = launch_fat<2>(g, xb, wq, bq, bi, ab, scale, s); break;
    case 4: err = launch_fat<4>(g, xb, wq, bq, bi, ab, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<true, false>(ab, C, static_cast<const bf16*>(wproj), C, (int)rows, C, C, 1,
                                static_cast<const bf16*>(bproj), static_cast<bf16*>(out),
                                nullptr, s);
}

}  // extern "C"
