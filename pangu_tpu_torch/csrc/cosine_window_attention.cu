// FuXi's scaled cosine window attention (Swin V2), inference, bf16 -- CUDA for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no FuXi. It replaces the port's
// chain of library calls inside SwinV2Block (pangu_tpu_torch/model/fuxi.py)
// between the qkv and the output projections: the q/k norms and their in-place
// scaling, the window gather, the shifted blocks' bias + mask table, SDPA
// (cuDNN's attention) and the inverse gather. Its plain PyTorch version is that
// chain, cosine_window_attention_reference in
// pangu_tpu_torch/ops/cosine_attention.py. Per (window, head), with the chain's
// rounding points:
//
//   q|k|v = qkv rows order[w T + i]                        (the window gather)
//   q     = bf16(q * temp / max(|q|, 1e-12)), k = bf16(k / max(|k|, 1e-12))
//                                                          (f32 norms, rounded once)
//   s     = q k^T + bias[head] (+ mask)                    f32; the mask -100 where
//                                                          two places' region labels
//                                                          differ (the shifted blocks)
//   p     = bf16(exp(s - max))                             f32 softmax over the T keys,
//   o     = bf16(p v / sum) -> output rows order[w T + i]  f32 sums; the inverse gather
//
// (p unnormalized in bf16 and the sum applied to p v, as SDPA's flash kernels do).
//
// What bounds it on an H100: bytes. At FuXi-Short's shape (a 90 x 180 token
// grid of 200 9 x 9 windows, C 1536, 48 heads of 32) a call reads qkv once
// (16,200 x 4,608 bf16, 149.3 MB) and writes o once (49.8 MB), with the bias
// (48 x 81 x 81 bf16), the order (int32) and the labels (int8) beside them:
// 0.060 ms at 3.35 TB/s, against 8.1 GFLOP of products (0.008 ms at the bf16
// peak).
//
// Design. A persistent CTA of 6 warps owns one head and walks windows slot,
// slot + slots, ... (grid = heads x slots, slots as many as fill the card at
// its occupancy), so the head's bias tile is staged to shared memory once and
// the CTAs of one step read whole qkv rows of the same windows together. Two
// stages in shared memory (common.cuh's `pipelined`): while one window is
// computed the next one's q, k and v (81 rows x 3 x 64 B, gathered by index
// with 16-byte cp.async, each qkv byte read once) are in flight. The places'
// token rows are read from the order table one window ahead into a register
// and kept per stage in shared memory, where the stores read them too.
//
//  * cosine: one thread a q or k row (2 T <= 192 threads) forms the f32 sum of
//    squares, the factor and the bf16 row in place;
//  * scores: warp w keeps query rows 16 w.. (T padded to 96) in registers, in
//    window_attention.cuh's layout: S as 12 n8 tiles of keys (48 f32 a thread)
//    on mma.sync m16n8k16 from ldmatrix fragments, the accumulators starting
//    from the bias (the staged bf16 tile in f32); then the mask (two labels
//    compared) in f32 and keys >= T set to -inf, over the KT tiles that hold a
//    real key only;
//  * softmax over all keys in one pass (T is small: no online rescaling), row
//    max and sum through quad shuffles, P packed to bf16 A fragments in
//    registers; O = P v with v's B fragments by ldmatrix.trans, scaled by the
//    row's 1 / sum; no score or probability goes to shared memory;
//  * O goes to the warp's own q rows in shared memory, then as 16-byte stores
//    to the output rows of the places' tokens (the inverse gather folded into
//    the store).
//
// Shared memory: two stages of 23,552 B (q, k and v tiles of 96 rows at an
// 80-byte stride, the places' tokens and labels) and the bias tile (96 x 96
// bf16 at a 208-byte stride, 19,968 B): 67,072 B, three CTAs (18 warps) per SM
// at 93 registers a thread. What keeps it above its bound is the arithmetic
// around the products at that occupancy, not the gather: the same loads and
// stores without it take two thirds of the time (PERF.md, the kernel A/Bs).

#include "common.cuh"

namespace {

constexpr int CW_ROWS = 96;                    // places, padded to six 16-row tiles
constexpr int CW_WARPS = CW_ROWS / 16;
constexpr int CW_THREADS = CW_WARPS * 32;      // 192
constexpr int CW_LD = D + 8;                   // bf16 row stride of q, k, v: 80 B
constexpr int CW_TILE = CW_ROWS * CW_LD;       // elements of one of q, k, v
constexpr int CW_KEYS = CW_ROWS / 8;           // n8 tiles of keys in S
constexpr int CW_BIAS_LD = CW_ROWS + 8;        // bias row stride: 208 B, conflict-free pairs
constexpr int CW_TOKENS = 3 * CW_TILE * 2;     // byte offset of a stage's tokens
constexpr int CW_LABELS = CW_TOKENS + CW_ROWS * 4;
constexpr int CW_STAGE = CW_LABELS + 128;      // 23,552 B
constexpr int CW_BIAS = 2 * CW_STAGE;
constexpr int CW_SMEM = CW_BIAS + CW_ROWS * CW_BIAS_LD * 2;  // 67,072 B
constexpr int CW_CHUNKS = 3 * (D / 8);         // 16-byte pieces of a place's q, k, v
constexpr int CW_MIN_CTAS = 3;
constexpr float MASKED = -100.f;                // Swin V2's shift mask
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static_assert(CW_STAGE % 128 == 0 && CW_BIAS % 16 == 0, "aligned stages");
static_assert(2 * CW_ROWS <= CW_THREADS, "a thread per q or k row");
static_assert(CW_MIN_CTAS * (CW_SMEM + 1024) <= 233472, "three CTAs per SM");

// KT: the n8 tiles of keys that hold a real key (ceil(nt / 8), 11 or 12)
template <int KT>
__global__ void __launch_bounds__(CW_THREADS, CW_MIN_CTAS)
cosine_window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                               const bf16* __restrict__ bias, const int* __restrict__ order,
                               const int8_t* __restrict__ labels, bf16* __restrict__ out,
                               int N, int C, int heads, int nt, int windows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int head = blockIdx.x % heads;
  const int slot = blockIdx.x / heads, slots = gridDim.x / heads;
  const int nw = N / nt;  // windows of one batch image
  const int n = (windows - slot + slots - 1) / slots;  // this CTA's windows (>= 1)
  const long long row3 = 3LL * C;
  bf16* const bias_s = reinterpret_cast<bf16*>(smem + CW_BIAS);

  // rows >= nt of q, k and v stay zero (no load writes them: finite scores and
  // products); the head's bias tile, zero past nt
  for (int i = tid; i < CW_STAGE / 4; i += CW_THREADS) {
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;
    reinterpret_cast<uint32_t*>(smem + CW_STAGE)[i] = 0u;
  }
  const bf16* bias_h = bias + (long long)head * nt * nt;
#pragma unroll 8
  for (int i = tid; i < CW_ROWS * CW_BIAS_LD; i += CW_THREADS) {
    const int r = i / CW_BIAS_LD, c = i - r * CW_BIAS_LD;
    bias_s[i] = (r < nt && c < nt) ? bias_h[r * nt + c] : __float2bfloat16(0.f);
  }
  const float temp_q = scale[head], temp_k = scale[heads + head];  // q's temperature, k's 1

  // window i of this CTA: (batch image, window of the image)
  auto window_of = [&](int i) { return slot + i * slots; };
  // the place's token and label of the next window to load, read one load ahead
  int pend_tok = 0, pend_lab = 0;
  if (tid < nt) {
    const int w = window_of(0) % nw;
    pend_tok = __ldg(order + w * nt + tid);
    if (labels) pend_lab = __ldg(labels + w * nt + tid);
  }
  __syncthreads();

  auto load = [&](int i, bf16* st) {
    int* toks = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(st) + CW_TOKENS);
    int8_t* labs = reinterpret_cast<int8_t*>(reinterpret_cast<unsigned char*>(st) + CW_LABELS);
    if (tid < nt) {
      toks[tid] = pend_tok;
      labs[tid] = (int8_t)pend_lab;
      if (i + 1 < n) {
        const int w = window_of(i + 1) % nw;
        pend_tok = __ldg(order + w * nt + tid);
        if (labels) pend_lab = __ldg(labels + w * nt + tid);
      }
    }
    __syncthreads();  // the tokens are in place
    const bf16* src = qkv + (long long)(window_of(i) / nw) * N * row3 + head * D;
    // piece f of the window: place f / 12, q, k or v (f % 12 / 4), 16 bytes f % 4;
    // consecutive threads read a row's consecutive pieces
    for (int f = tid; f < nt * CW_CHUNKS; f += CW_THREADS) {
      const int p = f / CW_CHUNKS, c = f - p * CW_CHUNKS, which = c >> 2, piece = c & 3;
      cp_async16(st + which * CW_TILE + p * CW_LD + piece * 8,
                 src + toks[p] * row3 + which * C + piece * 8);
    }
  };

  auto compute = [&](int i, bf16* st) {
    const int* toks = reinterpret_cast<const int*>(reinterpret_cast<unsigned char*>(st) + CW_TOKENS);
    const int8_t* labs =
        reinterpret_cast<const int8_t*>(reinterpret_cast<unsigned char*>(st) + CW_LABELS);
    bf16* qs = st;
    const bf16* ks = st + CW_TILE;
    const bf16* vs = st + 2 * CW_TILE;

    // ---- q = temp q / max(|q|, 1e-12), k = k / max(|k|, 1e-12): f32, rounded once
    if (tid < 2 * nt) {
      const int which = tid >= nt;
      uint4* row = reinterpret_cast<uint4*>(st + which * CW_TILE + (tid - which * nt) * CW_LD);
      uint4 v[D / 8];
      float ss[4] = {};  // four partial sums: short dependent chains
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        v[j] = row[j];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(h[e]);
          ss[e] = fmaf(x.y, x.y, fmaf(x.x, x.x, ss[e]));
        }
      }
      const float norm = sqrtf((ss[0] + ss[1]) + (ss[2] + ss[3]));
      const float factor = (which ? temp_k : temp_q) / fmaxf(norm, 1e-12f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn(x.x * factor, x.y * factor);
        }
        row[j] = v[j];
      }
    }
    __syncthreads();

    // ---- s = q k^T + bias (+ mask) of the warp's 16 query rows, keys >= nt -inf:
    // the MMAs start from the bias; keys from 8 KT on are pad in every window
    const int q0 = warp * 16;
    float s[CW_KEYS][4];
#pragma unroll
    for (int j = 0; j < CW_KEYS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 b = make_float2(0.f, 0.f);
        if (j < KT)
          b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              bias_s + (q0 + gq + 8 * h) * CW_BIAS_LD + 8 * j + 2 * tq));
        s[j][2 * h] = b.x;
        s[j][2 * h + 1] = b.y;
      }
    {
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], afrag_at(qs, CW_LD, q0, 16 * kk, lane));
#pragma unroll
      for (int nb = 0; nb < CW_KEYS / 2; ++nb)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, bfrag_nk(ks, CW_LD, 16 * nb, 16 * kk, lane));
          mma_bf16(s[2 * nb], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * nb + 1], qa[kk], kb[2], kb[3]);
        }
    }
    // ---- per half of the rows (gq, gq + 8): the mask, then p = exp(s - max) over
    // the keys, exp as exp2 of s log2(e) less the max's, and 1 / sum, which scales
    // the row's P v. A half of pad rows only (the last warp's second) keeps s = 0
    // (q and bias zero there): nothing of it is stored
    float inv[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q0 + 8 * h >= nt) continue;
      const int lq = labs[q0 + gq + 8 * h];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int key = 8 * j + 2 * tq;
        if (labels) {
          const uint16_t lk = *reinterpret_cast<const uint16_t*>(labs + key);
          s[j][2 * h] += (int)(lk & 0xff) != lq ? MASKED : 0.f;
          s[j][2 * h + 1] += (int)(lk >> 8) != lq ? MASKED : 0.f;
        }
        if (8 * j + 8 > nt) {
          if (key >= nt) s[j][2 * h] = -INFINITY;
          if (key + 1 >= nt) s[j][2 * h + 1] = -INFINITY;
        }
        m = fmaxf(m, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float ml = m * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j][2 * h] = ex2(fmaf(s[j][2 * h], kLog2e, -ml));
        s[j][2 * h + 1] = ex2(fmaf(s[j][2 * h + 1], kLog2e, -ml));
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = 1.f / sum;
#pragma unroll
      for (int j = KT; j < CW_KEYS; ++j) s[j][2 * h] = s[j][2 * h + 1] = 0.f;
    }
    // ---- O = bf16(p) v / sum: P from the score registers, v by ldmatrix.trans
    float o[4][4] = {};
#pragma unroll
    for (int kb = 0; kb < CW_KEYS / 2; ++kb) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                              pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                              pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                              pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(vb, bfrag_kn(vs, CW_LD, 16 * kb, 16 * dn, lane));
        mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    // ---- O over the warp's own q rows, then 16-byte stores to the tokens' rows
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q0 + gq + 8 * h < nt)  // the pad rows of q stay zero
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          *reinterpret_cast<uint32_t*>(qs + (q0 + gq + 8 * h) * CW_LD + 8 * nn + 2 * tq) =
              pack_bf16(o[nn][2 * h] * inv[h], o[nn][2 * h + 1] * inv[h]);
    __syncwarp();
    bf16* dst = out + (long long)(window_of(i) / nw) * N * C + head * D;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k, r = q0 + (c >> 2), piece = c & 3;
      if (r < nt)
        *reinterpret_cast<uint4*>(dst + (long long)toks[r] * C + piece * 8) =
            *reinterpret_cast<const uint4*>(qs + r * CW_LD + piece * 8);
    }
  };

  pipelined(n, reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + CW_STAGE), load,
            compute);
}

template <int KT>
cudaError_t launch_as(const void* qkv, const void* scale, const void* bias, const void* order,
                      const void* labels, void* out, int B, int N, int C, int heads, int nt,
                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(cosine_window_attention_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CW_SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, cosine_window_attention_kernel<KT>, CW_THREADS, CW_SMEM)) != cudaSuccess)
    return err;
  // the windows each head's CTAs share out: as many as fill the card, at least one
  const int windows = B * (N / nt);
  int slots = per_sm * sms / heads;
  slots = slots < 1 ? 1 : (slots > windows ? windows : slots);
  cosine_window_attention_kernel<KT><<<(unsigned)(heads * slots), CW_THREADS, CW_SMEM,
                                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(scale),
      static_cast<const bf16*>(bias), static_cast<const int*>(order),
      static_cast<const int8_t*>(labels), static_cast<bf16*>(out), N, C, heads, nt, windows);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/cosine_attention.py.

extern "C" {

// o (B, N, C) bf16 in token order from qkv (B, N, 3C) bf16 on `stream`: scale
// (2, heads) f32 (q's temperature, k's 1), bias (heads, T, T) bf16, order (N,)
// int32 (the token at each place, windows of T places in turn), labels (N,)
// int8 in the order's places or null (no mask). Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel does not take (head dim 32, T
// in [1, 96], N a multiple of T), else the launch status.
int fuxi_cosine_window_attention(const void* qkv, const void* scale, const void* bias,
                                 const void* order, const void* labels, void* out, int B,
                                 int N, int C, int heads, int T_, void* stream) {
  if (B < 1 || heads < 1 || C != heads * D || T_ < 1 || T_ > CW_ROWS || N % T_)
    return (int)cudaErrorInvalidValue;
  // keys 88.. hold a real key only past 88 places
  return (int)(T_ <= 88 ? launch_as<11>(qkv, scale, bias, order, labels, out, B, N, C, heads, T_,
                                        stream)
                        : launch_as<12>(qkv, scale, bias, order, labels, out, B, N, C, heads, T_,
                                        stream));
}

}  // extern "C"
