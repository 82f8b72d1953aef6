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
// A/B weighed against fatter matrix-unit tiles).
//
// Design. fat_attention_kernel<NW>: one CTA per fat window, 9 warps, looping
// over the heads. At NW = 1 (`batched`, the JAX question of one operation over
// all heads) the window's x rows are staged in shared memory once and read by
// every head, where K2 runs one CTA per (window, head) and stages x per head.
// At NW = 2, 4 x no longer fits beside the head's q|k|v (TN x 96 bf16, 120 KB
// at NW = 4), so it is streamed per head in 144-row blocks from L2. A (TN, TN)
// f32 score tile cannot fit either (1.3 MB at NW = 4), so each warp streams its
// 16-row query tiles over 16-key tiles in two passes: pass 1 keeps the row max
// and sum online (a tile whose keys are all cross-window sets a running max
// near -1e9, and the next real tile rescales that sum by exp(-1e9 - m) = 0 in
// f32); pass 2 recomputes the scores and forms p = exp(s - m) / sum, rounded to
// bf16 before the p v product -- the Pallas rounding point of p, at twice the
// score products. The attention output goes to a (rows, C) bf16 buffer and
// the projection is K2's (gemm.cuh's wgmma product with its bias), so the
// variants differ from `shipped` in the attention schedule only.
//
// What bounds it on an H100: the products, 8 rows C^2 + 4 rows TN C FLOP (the
// score work grows with NW), against x in and out and the bias table (0.99 GB
// at NW = 4, more than x).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_attn_fwd_ab.py; the plain PyTorch version is
// fat_attention_reference there.

#include "gemm.cuh"
#include "window_attention.cuh"

namespace {

constexpr int FC = 192;                  // channels (the outer stage)
constexpr int FH = FC / D;               // heads
constexpr int F_WARPS = T / 16;
constexpr int F_THREADS = F_WARPS * 32;  // 288
constexpr int XR_LD = FC + 8;            // resident x rows (NW = 1)
constexpr int F_WARP_BYTES = 16 * 3 * D * 4;  // per warp: its f32 q|k|v rows, then S, P, O
constexpr int FP_LD = 24;                // bf16 16 x 16 probability tile
constexpr int F_P_OFF = 1024, F_O_OFF = 2048;

constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int NW>
struct FatLayout {
  static constexpr int TN = NW * T;
  static constexpr int XR_BYTES = NW == 1 ? T * XR_LD * 2 : 0;
  static constexpr int QKV_B = TN * QKV_LD * 2;
  static constexpr int X_ELEMS = NW == 1 ? 0 : T * XS_LD;       // streamed x chunk
  static constexpr int STAGE_ELEMS = X_ELEMS + 3 * D * WT_LD;    // + the Wqkv chunk
  static constexpr int WORK = imax(2 * STAGE_ELEMS * 2, F_WARPS * F_WARP_BYTES);
  static constexpr int SMEM = XR_BYTES + QKV_B + WORK;
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
  static_assert(XR_BYTES % 32 == 0 && QKV_B % 32 == 0 && (STAGE_ELEMS * 2) % 32 == 0 &&
                    (X_ELEMS * 2) % 32 == 0,
                "wmma needs 256-bit aligned tiles");
};

// Grid row of token i of fat window (b, zi, hi, wf) of NW lon windows: the
// contiguous (wz, wh, NW ww) slice in (z, h, w) order.
__device__ __forceinline__ long long fat_row(const Geom& g, int b, int zi, int hi, int wf,
                                             int nw, int i) {
  const int wwn = nw * g.ww;
  const int zh = i / wwn, r = i - zh * wwn;
  const int dz = zh / g.wh, dh = zh - dz * g.wh;
  return ((long long)(b * g.Z + zi * g.wz + dz) * g.Hp + hi * g.wh + dh) * g.W + wf * wwn + r;
}

template <int NW>
__global__ void __launch_bounds__(F_THREADS, 1)
fat_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                     const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                     bf16* __restrict__ attn_out, Geom g, float scale) {
  using L = FatLayout<NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xr = reinterpret_cast<bf16*>(smem);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L::XR_BYTES);
  unsigned char* work = smem + L::XR_BYTES + L::QKV_B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zn = g.Z / g.wz, hn = g.Hp / g.wh, wfn = g.W / (g.ww * NW);
  int idx = blockIdx.x;
  const int wf = idx % wfn;
  idx /= wfn;
  const int hi = idx % hn;
  idx /= hn;
  const int zi = idx % zn;
  const int b = idx / zn;
  const int type = zi * hn + hi;
  constexpr int C = FC;

  if (NW == 1) {  // the window's x rows, once for all heads (completed by the first wait)
    for (int v = threadIdx.x; v < T * (C / 8); v += F_THREADS) {
      const int t = v / (C / 8), cv = v - t * (C / 8);
      cp_async16(xr + t * XR_LD + cv * 8, x + fat_row(g, b, zi, hi, wf, NW, t) * C + cv * 8);
    }
    cp_async_commit();
  }

  for (int head = 0; head < FH; ++head) {
    // ---- this head's q|k|v for the TN tokens, 144 rows at a time
    for (int blk = 0; blk < NW; ++blk) {
      FragC acc[6];
      for (int n = 0; n < 6; ++n) wmma::fill_fragment(acc[n], 0.f);
      bf16* st0 = reinterpret_cast<bf16*>(work);
      pipelined(
          C / KC, st0, st0 + L::STAGE_ELEMS,
          [&](int i, bf16* st) {
            const int k0 = i * KC;
            if (NW > 1)
              for (int v = threadIdx.x; v < T * (KC / 8); v += F_THREADS) {
                const int t = v / (KC / 8), cv = v - t * (KC / 8);
                cp_async16(st + t * XS_LD + cv * 8,
                           x + fat_row(g, b, zi, hi, wf, NW, blk * T + t) * C + k0 + cv * 8);
              }
            for (int v = threadIdx.x; v < 3 * D * (KC / 8); v += F_THREADS) {
              const int r = v / (KC / 8), cv = v - r * (KC / 8);
              const int seg = r / D, j = r - seg * D;
              cp_async16(st + L::X_ELEMS + r * WT_LD + cv * 8,
                         wqkv + (long long)(seg * C + head * D + j) * C + k0 + cv * 8);
            }
          },
          [&](int i, bf16* st) {
            for (int kk = 0; kk < KC; kk += 16) {
              FragA a;
              if (NW == 1)
                wmma::load_matrix_sync(a, xr + warp * 16 * XR_LD + i * KC + kk, XR_LD);
              else
                wmma::load_matrix_sync(a, st + warp * 16 * XS_LD + kk, XS_LD);
              for (int n = 0; n < 6; ++n) {
                FragBt w;
                wmma::load_matrix_sync(w, st + L::X_ELEMS + n * 16 * WT_LD + kk, WT_LD);
                wmma::mma_sync(acc[n], a, w, acc[n]);
              }
            }
          });
      // the stages are dead: each warp adds the bias to its rows in its region
      float* ws = reinterpret_cast<float*>(work + warp * F_WARP_BYTES);
      for (int n = 0; n < 6; ++n)
        wmma::store_matrix_sync(ws + n * 16, acc[n], 3 * D, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 3 * D; e += 32) {
        const int r = e / (3 * D), cidx = e - r * (3 * D);
        const int seg = cidx / D, j = cidx - seg * D;
        const float v = ws[e] + __bfloat162float(bqkv[seg * C + head * D + j]);
        qkv[(blk * T + warp * 16 + r) * QKV_LD + cidx] = __float2bfloat16(v);
      }
      __syncthreads();  // qkv rows visible; the regions are stages again
    }

    // ---- the warp's 16-row query tiles against all TN keys, 16 keys at a time
    const float* bias_h = bias + (long long)(type * FH + head) * L::TN * L::TN;
    float* S = reinterpret_cast<float*>(work + warp * F_WARP_BYTES);
    bf16* P = reinterpret_cast<bf16*>(work + warp * F_WARP_BYTES + F_P_OFF);
    float* O = reinterpret_cast<float*>(work + warp * F_WARP_BYTES + F_O_OFF);
    const int r = lane >> 1, c0 = (lane & 1) * 8;  // the lane's row and 8 columns of a tile
    for (int qt = warp; qt < L::TN / 16; qt += F_WARPS) {
      const int q0 = qt * 16;
      FragA qa[2];
      wmma::load_matrix_sync(qa[0], qkv + q0 * QKV_LD, QKV_LD);
      wmma::load_matrix_sync(qa[1], qkv + q0 * QKV_LD + 16, QKV_LD);
      auto scores = [&](int kt) {  // S = the (16, 16) tile q k^T of key tile kt
        FragC s;
        wmma::fill_fragment(s, 0.f);
        for (int kk = 0; kk < 2; ++kk) {
          FragBt kb;
          wmma::load_matrix_sync(kb, qkv + kt * 16 * QKV_LD + D + kk * 16, QKV_LD);
          wmma::mma_sync(s, qa[kk], kb, s);
        }
        wmma::store_matrix_sync(S, s, 16, wmma::mem_row_major);
        __syncwarp();
      };
      const float* brow = bias_h + (long long)(q0 + r) * L::TN + c0;
      // pass 1: the row max m and sum l of exp(s - m), online over the key tiles
      float m = -INFINITY, l = 0.f;
      for (int kt = 0; kt < L::TN / 16; ++kt) {
        scores(kt);
        float v[8], tm = -INFINITY;
        for (int e = 0; e < 8; ++e) {
          v[e] = S[r * 16 + c0 + e] * scale + brow[kt * 16 + e];
          tm = fmaxf(tm, v[e]);
        }
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        const float mn = fmaxf(m, tm);
        float ps = 0.f;
        for (int e = 0; e < 8; ++e) ps += expf(v[e] - mn);
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        l = l * expf(m - mn) + ps;
        m = mn;
        __syncwarp();  // S is read before the next tile overwrites it
      }
      // pass 2: p = bf16(exp(s - m) / l), o += p v
      FragC o[2];
      wmma::fill_fragment(o[0], 0.f);
      wmma::fill_fragment(o[1], 0.f);
      for (int kt = 0; kt < L::TN / 16; ++kt) {
        scores(kt);
        __align__(16) bf16 pv[8];
        for (int e = 0; e < 8; ++e)
          pv[e] = __float2bfloat16(expf(S[r * 16 + c0 + e] * scale + brow[kt * 16 + e] - m) / l);
        *reinterpret_cast<uint4*>(P + r * FP_LD + c0) = *reinterpret_cast<const uint4*>(pv);
        __syncwarp();
        FragA pa;
        wmma::load_matrix_sync(pa, P, FP_LD);
        for (int n = 0; n < 2; ++n) {
          FragB vb;
          wmma::load_matrix_sync(vb, qkv + kt * 16 * QKV_LD + 2 * D + n * 16, QKV_LD);
          wmma::mma_sync(o[n], pa, vb, o[n]);
        }
        __syncwarp();  // S and P are read before the next tile
      }
      wmma::store_matrix_sync(O, o[0], D, wmma::mem_row_major);
      wmma::store_matrix_sync(O + 16, o[1], D, wmma::mem_row_major);
      __syncwarp();
      {
        const int rr = lane >> 1, cc = (lane & 1) * 16;
        const long long row = fat_row(g, b, zi, hi, wf, NW, q0 + rr);
        __align__(16) bf16 tmp[16];
        for (int j = 0; j < 16; ++j) tmp[j] = __float2bfloat16(O[rr * D + cc + j]);
        uint4* dst = reinterpret_cast<uint4*>(attn_out + row * C + head * D + cc);
        dst[0] = reinterpret_cast<const uint4*>(tmp)[0];
        dst[1] = reinterpret_cast<const uint4*>(tmp)[1];
      }
      __syncwarp();
    }
    __syncthreads();  // this head's qkv is read: the next head overwrites it
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
