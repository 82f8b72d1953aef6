// Whole Earth-Specific transformer block, inference, bf16 -- CUDA for Hopper (sm_90a).
//
// Replaces pangu_tpu/ops/fused_block_attention.py::fused_earth_block (the Pallas
// megakernel _block_forward / _make_kernel(with_epilogue=True, with_mlp=True)).
// One call computes, on the (rolled, window-padded) token grid x (B, Z, Hp, W, C):
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
//  * window_attention_kernel: one CTA per (batch, window, head), 9 warps, one
//    16-row query tile per warp. It gathers the window's 144 tokens straight
//    from the grid by index (no partition transpose), forms that head's q, k, v
//    (144 x 32 each) with bf16 tensor-core MMAs (nvcuda::wmma, f32 accumulate),
//    then each warp computes its 16 x 144 score tile, the f32 softmax (written
//    back over the scores as bf16 probabilities) and P @ v, and stores the
//    head's 32 columns of a bf16 (B, Z, Hp, W, C) attention-output buffer.
//    Consecutive CTAs are the heads of one window and then the lon windows of
//    one type, so a window's x rows and a (type, head) bias tile are reused
//    from L2 (the bias tile by the 30 or 15 lon windows of its type).
//    112,896 B of shared memory: two CTAs per SM.
//  * token_tail_kernel<C>: one CTA per 48 rows of the flattened grid, 12
//    warps. out-projection, LN1 and residual into an f32 x1 tile in shared
//    memory; then the MLP streamed over 64-column chunks of the 4C hidden, the
//    W2 product accumulating in registers, so the (48, 4C) hidden never exists
//    whole; then LN2 and the final residual in f32.
//
// All products are the kernels' own (wmma 16x16x16 bf16 fragments, f32
// accumulate). Every operand tile is staged in shared memory by cp.async
// through a two-stage ring, the next chunk's copy in flight while the current
// one is multiplied; the weights are shared by every CTA and come from L2.
// wgmma, TMA and persistence are left for later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_attention.py; the plain PyTorch version of the
// same function is fused_earth_block_reference there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLnEps = 1e-5f;

// ---- window attention --------------------------------------------------------
constexpr int T = 144;                          // tokens per window (2 x 6 x 12)
constexpr int D = 32;                           // head dim
constexpr int ATT_WARPS = T / 16;               // one 16-row query tile per warp
constexpr int ATT_THREADS = ATT_WARPS * 32;     // 288
constexpr int QKV_LD = 3 * D + 8;               // bf16 row stride of the q|k|v tile
constexpr int KC = 64;                          // x channels staged per step
constexpr int XS_LD = KC + 8;
constexpr int S_LD = T;                         // f32 score row stride
constexpr int P_LD = T + 8;                     // bf16 prob row stride (over the scores)
constexpr int WARP_SCRATCH = 16 * S_LD * 4;     // 9,216 B per warp
constexpr int QKV_BYTES = T * QKV_LD * 2;       // 29,952 B
constexpr int ATT_SMEM = QKV_BYTES + ATT_WARPS * WARP_SCRATCH;  // 112,896 B
constexpr int O_OFFSET = 16 * P_LD * 2;         // P @ v tile after the probs
constexpr int WT_LD = KC + 8;                   // row stride of a staged (96, KC) Wqkv chunk
constexpr int XS_ELEMS = T * XS_LD;             // x chunk, then the Wqkv chunk
constexpr int ATT_STAGE_ELEMS = XS_ELEMS + 3 * D * WT_LD;  // 34,560 B per stage

static_assert(2 * ATT_STAGE_ELEMS * 2 <= ATT_WARPS * WARP_SCRATCH, "two stages fit the scratch");
static_assert((XS_ELEMS * 2) % 32 == 0 && (ATT_STAGE_ELEMS * 2) % 32 == 0,
              "wmma needs 256-bit aligned tiles");
static_assert(16 * 3 * D * 4 <= WARP_SCRATCH, "qkv staging fits a warp's scratch");
static_assert(O_OFFSET + 16 * D * 4 <= WARP_SCRATCH, "probs + output fit a warp's scratch");
static_assert(O_OFFSET % 32 == 0, "wmma needs 256-bit aligned tiles");

struct Geom {
  int B, Z, Hp, W, C, heads, wz, wh, ww;
};

// Flattened grid row of token i of window (b, zi, hi, wi); token order (z, h, w).
__device__ __forceinline__ long long token_row(const Geom& g, int b, int zi, int hi,
                                               int wi, int i) {
  const int dz = i / (g.wh * g.ww);
  const int r = i - dz * g.wh * g.ww;
  const int dh = r / g.ww;
  const int dw = r - dh * g.ww;
  return ((long long)(b * g.Z + zi * g.wz + dz) * g.Hp + hi * g.wh + dh) * g.W +
         wi * g.ww + dw;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- cp.async: 16-byte global -> shared copies, completed by group ----------------
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a rows x cols bf16 tile (cols a multiple of 8) from global memory (row
// stride gld) into shared memory (row stride sld), all threads of the CTA.
__device__ __forceinline__ void stage_tile(bf16* s, int sld, const bf16* g, long long gld,
                                           int rows, int cols) {
  const int vpr = cols >> 3;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, c = (v - r * vpr) << 3;
    cp_async16(s + r * sld + c, g + r * gld + c);
  }
}

// Two-stage ring over n chunks: load(i, buf) issues chunk i's copies, compute(i,
// buf) consumes it; chunk i + 1 is in flight while chunk i is multiplied. Ends
// with a barrier, so the buffers and everything read from them are free again.
template <class Load, class Compute>
__device__ __forceinline__ void pipelined(int n, bf16* buf0, bf16* buf1, Load load,
                                          Compute compute) {
  load(0, buf0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    bf16* cur = (i & 1) ? buf1 : buf0;
    if (i + 1 < n) {
      load(i + 1, (i & 1) ? buf0 : buf1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(i, cur);
    __syncthreads();
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(ATT_THREADS, 2)
window_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ attn_out,
                        Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qkv = reinterpret_cast<bf16*>(smem);
  unsigned char* scratch = smem + QKV_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zn = g.Z / g.wz, hn = g.Hp / g.wh, wn = g.W / g.ww;
  int idx = blockIdx.x;
  const int head = idx % g.heads;
  idx /= g.heads;
  const int wi = idx % wn;
  idx /= wn;
  const int hi = idx % hn;
  idx /= hn;
  const int zi = idx % zn;
  const int b = idx / zn;
  const int type = zi * hn + hi;
  const int C = g.C;

  // ---- q | k | v of this head: (144, C) @ (C, 96), KC channels of x and the
  // same KC input columns of this head's 96 Wqkv rows (its q, k and v outputs)
  // per stage
  bf16* stage0 = reinterpret_cast<bf16*>(scratch);
  FragC acc[6];
  for (int n = 0; n < 6; ++n) wmma::fill_fragment(acc[n], 0.f);
  pipelined(
      C / KC, stage0, stage0 + ATT_STAGE_ELEMS,
      [&](int i, bf16* st) {
        const int k0 = i * KC;
        for (int v = threadIdx.x; v < T * (KC / 8); v += ATT_THREADS) {
          const int t = v / (KC / 8), cv = v - t * (KC / 8);
          cp_async16(st + t * XS_LD + cv * 8,
                     x + token_row(g, b, zi, hi, wi, t) * C + k0 + cv * 8);
        }
        for (int v = threadIdx.x; v < 3 * D * (KC / 8); v += ATT_THREADS) {
          const int r = v / (KC / 8), cv = v - r * (KC / 8);
          const int seg = r / D, j = r - seg * D;  // seg 0,1,2: q, k, v
          cp_async16(st + XS_ELEMS + r * WT_LD + cv * 8,
                     wqkv + (long long)(seg * C + head * D + j) * C + k0 + cv * 8);
        }
      },
      [&](int, bf16* st) {
        for (int kk = 0; kk < KC; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, st + warp * 16 * XS_LD + kk, XS_LD);
          for (int n = 0; n < 6; ++n) {  // n = 0,1: q columns; 2,3: k; 4,5: v
            FragBt w;
            wmma::load_matrix_sync(w, st + XS_ELEMS + n * 16 * WT_LD + kk, WT_LD);
            wmma::mma_sync(acc[n], a, w, acc[n]);
          }
        }
      });
  // the stages are dead: the scratch is now per warp
  float* ws = reinterpret_cast<float*>(scratch + warp * WARP_SCRATCH);
  for (int n = 0; n < 6; ++n)
    wmma::store_matrix_sync(ws + n * 16, acc[n], 3 * D, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * 3 * D; e += 32) {
    const int r = e / (3 * D), cidx = e - r * (3 * D);
    const int seg = cidx / D, j = cidx - seg * D;
    const float v = ws[e] + __bfloat162float(bqkv[seg * C + head * D + j]);
    qkv[(warp * 16 + r) * QKV_LD + cidx] = __float2bfloat16(v);
  }
  __syncthreads();

  // ---- this warp's 16 query rows: scores, softmax, P @ v
  const int q0 = warp * 16;
  float* S = ws;
  bf16* P = reinterpret_cast<bf16*>(ws);  // written over S, row r after row r is read
  float* O = reinterpret_cast<float*>(scratch + warp * WARP_SCRATCH + O_OFFSET);
  {
    FragA qa[2];
    wmma::load_matrix_sync(qa[0], qkv + q0 * QKV_LD, QKV_LD);
    wmma::load_matrix_sync(qa[1], qkv + q0 * QKV_LD + 16, QKV_LD);
    for (int j = 0; j < T / 16; ++j) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
      for (int kk = 0; kk < 2; ++kk) {
        FragBt kt;  // k^T: column n of the tile is key token 16 j + n
        wmma::load_matrix_sync(kt, qkv + j * 16 * QKV_LD + D + kk * 16, QKV_LD);
        wmma::mma_sync(s, qa[kk], kt, s);
      }
      wmma::store_matrix_sync(S + j * 16, s, S_LD, wmma::mem_row_major);
    }
  }
  __syncwarp();

  const float* bias_rows = bias + ((long long)(type * g.heads + head) * T + q0) * T;
  const float* mask_rows = mask ? mask + ((long long)type * T + q0) * T : nullptr;
  constexpr int PER_LANE = (T + 31) / 32;
  for (int r = 0; r < 16; ++r) {
    float v[PER_LANE];
    float m = -INFINITY;
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      v[i] = -INFINITY;
      if (c < T) {
        float s = S[r * S_LD + c] * scale + bias_rows[r * T + c];
        if (mask_rows) s += mask_rows[r * T + c];
        v[i] = s;
        m = fmaxf(m, s);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = (lane + 32 * i < T) ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // score row r is read by every lane before probs overwrite it
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      if (c < T) P[r * P_LD + c] = __float2bfloat16(v[i] / sum);
    }
  }
  __syncwarp();

  {
    FragC o[2];
    wmma::fill_fragment(o[0], 0.f);
    wmma::fill_fragment(o[1], 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, P + kk * 16, P_LD);
      for (int n = 0; n < 2; ++n) {
        FragB vb;
        wmma::load_matrix_sync(vb, qkv + kk * 16 * QKV_LD + 2 * D + n * 16, QKV_LD);
        wmma::mma_sync(o[n], pa, vb, o[n]);
      }
    }
    wmma::store_matrix_sync(O, o[0], D, wmma::mem_row_major);
    wmma::store_matrix_sync(O + 16, o[1], D, wmma::mem_row_major);
  }
  __syncwarp();
  {
    const int r = lane >> 1, c0 = (lane & 1) * 16;
    const long long row = token_row(g, b, zi, hi, wi, q0 + r);
    __align__(16) bf16 tmp[16];
    for (int j = 0; j < 16; ++j) tmp[j] = __float2bfloat16(O[r * D + c0 + j]);
    uint4* dst = reinterpret_cast<uint4*>(attn_out + row * C + head * D + c0);
    dst[0] = reinterpret_cast<const uint4*>(tmp)[0];
    dst[1] = reinterpret_cast<const uint4*>(tmp)[1];
  }
}

// ---- token tail: out-projection, LN1, MLP, LN2 ----------------------------------
constexpr int TAIL_ROWS = 48;  // divides every grid: rows = windows * 144
constexpr int TAIL_WARPS = 12;  // 3 row tiles x 4 column groups
constexpr int TAIL_THREADS = TAIL_WARPS * 32;
constexpr int HC = 64;  // hidden columns per MLP chunk

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C>
struct TailLayout {
  static constexpr int Y_LD = C + 4;      // f32 rows: y, then x1; the MLP output
  static constexpr int XB_LD = C + 8;     // bf16 rows: the attention output, then bf16(x1)
  static constexpr int H_LD = HC + 4;     // f32 hidden chunk
  static constexpr int HB_LD = HC + 8;    // bf16 hidden chunk
  static constexpr int WT_LD = 32 + 8;    // staged (C, 32) chunk of Wproj or W2 rows
  static constexpr int W1_LD = 64 + 8;    // staged (64, 64) chunk of W1 rows
  static constexpr int Y_BYTES = TAIL_ROWS * Y_LD * 4;
  static constexpr int XB_BYTES = TAIL_ROWS * XB_LD * 2;
  static constexpr int H_BYTES = TAIL_ROWS * H_LD * 4;
  static constexpr int HB_BYTES = TAIL_ROWS * HB_LD * 2;
  static constexpr int STAGE_BYTES = cmax(C * WT_LD * 2, HC * W1_LD * 2);
  static constexpr int WORK_BYTES = XB_BYTES + H_BYTES + HB_BYTES + 2 * STAGE_BYTES;
  // the MLP output reuses the work area once the MLP is done
  static constexpr int SMEM = Y_BYTES + cmax(WORK_BYTES, Y_BYTES);
  static constexpr int NT = C / 64;  // 16-column output tiles per warp
  static_assert(C % 64 == 0, "C must be a multiple of 64");
  static_assert(Y_BYTES % 32 == 0 && XB_BYTES % 32 == 0 && H_BYTES % 32 == 0 &&
                    HB_BYTES % 32 == 0 && STAGE_BYTES % 32 == 0,
                "wmma needs 256-bit aligned tiles");
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
};

// v[j] holds column lane + 32 j of one row; LayerNorm over the C columns.
template <int C>
__device__ __forceinline__ void layer_norm_row(float (&v)[C / 32], const float* __restrict__ s,
                                               const float* __restrict__ t, int lane) {
  float sum = 0.f, sq = 0.f;
  for (int j = 0; j < C / 32; ++j) {
    sum += v[j];
    sq += v[j] * v[j];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float rs = rsqrtf(sq / C - mu * mu + kLnEps);
  for (int j = 0; j < C / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = (v[j] - mu) * rs * s[c] + t[c];
  }
}

template <int C>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
token_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                  const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                  const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                  const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                  bf16* __restrict__ out) {
  using L = TailLayout<C>;
  constexpr int H4 = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Y = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + L::Y_BYTES;
  bf16* XB = reinterpret_cast<bf16*>(work);
  float* H = reinterpret_cast<float*>(work + L::XB_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(work + L::XB_BYTES + L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(work + L::XB_BYTES + L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE_BYTES / 2;
  float* Zs = reinterpret_cast<float*>(work);  // after the MLP
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp >> 2, ng = warp & 3;  // row tile, column group
  const long long row0 = (long long)blockIdx.x * TAIL_ROWS;

  // ---- y = attn @ Wproj: the attention rows are staged with the first chunk
  {
    FragC acc[L::NT];
    for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(acc[i], 0.f);
    pipelined(
        C / 32, S0, S1,
        [&](int i, bf16* st) {
          if (i == 0) stage_tile(XB, L::XB_LD, attn + row0 * C, C, TAIL_ROWS, C);
          stage_tile(st, L::WT_LD, wproj + i * 32, C, C, 32);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 32; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, XB + mt * 16 * L::XB_LD + i * 32 + kk, L::XB_LD);
            for (int j = 0; j < L::NT; ++j) {
              FragBt w;
              wmma::load_matrix_sync(w, st + (ng + 4 * j) * 16 * L::WT_LD + kk, L::WT_LD);
              wmma::mma_sync(acc[j], a, w, acc[j]);
            }
          }
        });
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Y + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, acc[j], L::Y_LD,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // ---- x1 = x + LN1(y + bproj), kept f32; bf16(x1) is the MLP input
  for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
    float v[C / 32];
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = Y[r * L::Y_LD + c] + __bfloat162float(bproj[c]);
    }
    layer_norm_row<C>(v, ln1_s, ln1_b, lane);
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      const float x1 = v[j] + __bfloat162float(x[(row0 + r) * C + c]);
      Y[r * L::Y_LD + c] = x1;
      XB[r * L::XB_LD + c] = __float2bfloat16(x1);
    }
  }
  __syncthreads();

  // ---- z = GELU(x1 @ W1 + b1) @ W2, over 64-column chunks of the hidden
  FragC zacc[L::NT];
  for (int i = 0; i < L::NT; ++i) wmma::fill_fragment(zacc[i], 0.f);
  for (int h0 = 0; h0 < H4; h0 += HC) {
    FragC hacc;
    wmma::fill_fragment(hacc, 0.f);
    pipelined(
        C / 64, S0, S1,
        [&](int i, bf16* st) {
          stage_tile(st, L::W1_LD, w1 + (long long)h0 * C + i * 64, C, HC, 64);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 64; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, XB + mt * 16 * L::XB_LD + i * 64 + kk, L::XB_LD);
            FragBt w;
            wmma::load_matrix_sync(w, st + ng * 16 * L::W1_LD + kk, L::W1_LD);
            wmma::mma_sync(hacc, a, w, hacc);
          }
        });
    float* Ht = H + mt * 16 * L::H_LD + ng * 16;
    wmma::store_matrix_sync(Ht, hacc, L::H_LD, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      float h = Ht[r * L::H_LD + c] + __bfloat162float(b1[h0 + ng * 16 + c]);
      h = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
      HB[(mt * 16 + r) * L::HB_LD + ng * 16 + c] = __float2bfloat16(h);
    }
    // the first barrier inside makes every warp's hidden tile visible
    pipelined(
        HC / 32, S0, S1,
        [&](int i, bf16* st) {
          stage_tile(st, L::WT_LD, w2 + h0 + i * 32, H4, C, 32);
        },
        [&](int i, bf16* st) {
          for (int kk = 0; kk < 32; kk += 16) {
            FragA a;
            wmma::load_matrix_sync(a, HB + mt * 16 * L::HB_LD + i * 32 + kk, L::HB_LD);
            for (int j = 0; j < L::NT; ++j) {
              FragBt w;
              wmma::load_matrix_sync(w, st + (ng + 4 * j) * 16 * L::WT_LD + kk, L::WT_LD);
              wmma::mma_sync(zacc[j], a, w, zacc[j]);
            }
          }
        });
  }
  for (int j = 0; j < L::NT; ++j)
    wmma::store_matrix_sync(Zs + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, zacc[j], L::Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // ---- out = x1 + LN2(z + b2), the add in f32
  for (int r = warp; r < TAIL_ROWS; r += TAIL_WARPS) {
    float v[C / 32];
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = Zs[r * L::Y_LD + c] + __bfloat162float(b2[c]);
    }
    layer_norm_row<C>(v, ln2_s, ln2_b, lane);
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      out[(row0 + r) * C + c] = __float2bfloat16(Y[r * L::Y_LD + c] + v[j]);
    }
  }
}

template <int C>
cudaError_t launch_tail(long long rows, cudaStream_t stream, const bf16* x, const bf16* attn,
                        const bf16* wproj, const bf16* bproj, const float* ln1_s,
                        const float* ln1_b, const bf16* w1, const bf16* b1, const bf16* w2,
                        const bf16* b2, const float* ln2_s, const float* ln2_b, bf16* out) {
  using L = TailLayout<C>;
  cudaError_t err = cudaFuncSetAttribute(token_tail_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  token_tail_kernel<C><<<(unsigned)(rows / TAIL_ROWS), TAIL_THREADS, L::SMEM, stream>>>(
      x, attn, wproj, bproj, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the whole block on `stream`. Returns a cudaError_t: cudaErrorInvalidValue
// for a geometry the kernels do not take, else the launch status of the last
// kernel (cudaGetLastError after each launch). `mask` may be null.
int pangu_fused_earth_block(const void* x, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, const void* bias,
                            const void* mask, const void* ln1_s, const void* ln1_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* ln2_s, const void* ln2_b, void* attn_buf, void* out,
                            int B, int Z, int Hp, int W, int C, int heads, int wz, int wh,
                            int ww, float scale, void* stream) {
  if (wz * wh * ww != T || C != heads * D || (C != 192 && C != 384) || B < 1 ||
      Z % wz || Hp % wh || W % ww)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Geom g{B, Z, Hp, W, C, heads, wz, wh, ww};
  const long long windows = (long long)B * (Z / wz) * (Hp / wh) * (W / ww);

  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(window_attention_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<<<(unsigned)(windows * heads), ATT_THREADS, ATT_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), g, scale);
  err = cudaGetLastError();
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
  err = (C == 192)
            ? launch_tail<192>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b, b2b, l2s, l2b, ob)
            : launch_tail<384>(rows, s, xb, ab, wp, bp, l1s, l1b, w1b, b1b, w2b, b2b, l2s, l2b, ob);
  return (int)err;
}

}  // extern "C"
