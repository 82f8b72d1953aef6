// The forward MLP row engine on wgmma and TMA (sm_90a), and the row kernel
// built on it: the MLP tail K6 / K10 and the raw MLP K8 (fused_mlp.cu), the
// row pass of the MLP-tail backward K7 (fused_mlp.cu) and of the block
// backward K12 (fused_block_train.cu), and the token tail of the blocks K1
// (fused_earth_block.cu), K11 (fused_block_train.cu) and K2's LN-epilogue mode
// (block_attention.cu).
//
// mlp_tail_kernel<C, PROJ, MLP, TRAIN, BWD, RAW> computes, per token row of
// `in` (rows, C) bf16:
//
//   PROJ    a   = in Wproj^T + bproj          (the attention output projected;
//                                               TRAIN: rounded to bf16)
//           x1  = x + s1 LN1(a)                (f32; TRAIN: rounded to bf16)
//           out = bf16(x1)                     (MLP false: K2's LN mode)
//   MLP     y   = bf16(GELU(u W1^T + b1)) W2^T + b2,   u = bf16(x1) (PROJ) or in
//           out = bf16(r + s2 LN2(y)),         r = x1 (PROJ) or in (K6, K10)
//   RAW     out = bf16(y)                      (MLP without PROJ: K8)
//   BWD     the LayerNorm-2 backward of gy instead of `out` (K7's row pass;
//           with PROJ and TRAIN, K12's, which also writes a and x1)
//
// with the rounding points of the Pallas bodies: the hidden is rounded to bf16
// after an f32 GELU; the products, LayerNorm (E[y^2] - mu^2, eps 1e-5), the
// residuals and every sum stay f32; in K1 x1 stays f32 and only the MLP input
// is rounded. s1 and s2 are f32 scales, one per `rows_per_scale` rows (K6: a
// per-row branch scale; K11: one per sample), or null for 1.
//
// Design. A persistent CTA per SM walks 64-row tiles (one wgmma row block):
//
//  * a producer warp keeps the tile's input (x, or the attention output) in
//    shared memory, loaded once by TMA, and streams the weights through a ring
//    of equal chunks (C x 128 bytes: a 64-channel slice of Wproj or W2, or 64
//    rows of W1) guarded by mbarriers, 4 slots at C = 192 and 3 at C = 384, so
//    the next chunks load while the current ones are multiplied. Its
//    warpgroup hands its registers to the consumers (setmaxnreg: 232 a
//    thread there, against 168 for an even split);
//  * two consumer warpgroups each own half of the C output columns (y in
//    registers, 48 or 96 f32 a thread). Per 64-column chunk of the 4C hidden,
//    each forms h for 32 of the chunk's columns (wgmma m64n32 from the x tile
//    and the W1 chunk), adds b1 and applies the GELU in registers, writes its
//    half of the bf16 hidden tile to shared memory (double-buffered), and after
//    a named barrier accumulates y[:, its half] += hidden W2[its half, chunk]^T
//    (m64n96 or m64n192). The y product of one chunk runs while the next
//    chunk's h is issued; W1 and W2 slots are released as soon as their
//    product is done;
//  * the out-projection (PROJ) runs the same y product over C / 64 chunks of
//    Wproj, from the attention tile;
//  * the LayerNorm statistics of a row are summed over both warpgroups'
//    halves through a small exchange in shared memory, in a fixed order; the
//    residual, scale and bf16 store follow per row. x1 (PROJ with MLP) is kept
//    by each thread for the final residual in a local array: at C = 384 it
//    does not fit the registers beside y, nor the shared memory beside the
//    tiles (64 x 384 f32 = 96 KB), so it goes to the L1/L2 (48 or 96 KB per
//    tile, against the 2.6 MB of weights a tile streams); bf16(x1), the MLP
//    input, replaces the attention tile in shared memory.
//
// Rows past `rows` are read as zeros (TMA) and not stored, so any row count
// is taken. Every sum is in a fixed order: the same bits on every run.
//
// What bounds it on an H100: ~16 rows C^2 FLOP for the MLP (+2 rows C^2 for
// the projection) against a few (rows, C) bf16 passes: the tensor cores. Each
// 64-row tile streams all of W1 and W2 (16 C^2 bytes) from the L2, 64 FLOP
// per byte of L2 traffic, so the L2 feed, and the GELU epilogue between the
// two products, hold it below the tensor-core peak.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int WG_TAIL_ROWS = 64;        // rows per tile (one wgmma row block)
constexpr int WG_TAIL_THREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup
// registers per thread: the producer warpgroup gives its share to the consumers
// (128 x 40 + 256 x 232 of the SM's 65,536)
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;

// Shared memory (byte offsets; every box on a 1024-byte boundary): the input
// tile (C / 64 boxes of 64 rows x 64 channels, 128-byte swizzle), the weight
// ring, two 64 x 64 bf16 hidden tiles (128-byte swizzle), the row sums
// exchanged between the warpgroups ([exchange][tile parity][warpgroup][row][4]
// floats), the barriers.
template <int C>
struct WgTailLayout {
  static constexpr int HALF = C / 2;             // output columns per consumer warpgroup
  static constexpr int XBOX = 64 * 64 * 2, WBOX = 64 * 32 * 2;
  static constexpr int CHUNK = C * 128;          // one weight chunk
  static constexpr int STAGES = C == 192 ? 4 : 3;
  static constexpr int X = 0, RING = X + C / 64 * XBOX, HID = RING + STAGES * CHUNK;
  static constexpr int STATS = HID + 2 * XBOX, BAR = STATS + 2 * 2 * 2 * 64 * 4 * 4;
  static constexpr int SMEM = BAR + (2 + 2 * STAGES) * 8;
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
};

// in: (C, rows) boxes 64 x 64, 128-byte swizzle; wproj (C, C) the same; w1 (C,
// 4C) boxes of 32 channels x 64 rows, 64-byte swizzle (K-major B of h); w2 (4C,
// C) boxes of 64 hidden columns x 64 rows, 128-byte swizzle (K-major B of y).
struct TailMaps {
  CUtensorMap in, wproj, w1, w2;
};

// d (64 x C/2 f32) += A (64 x 16) B (16 x C/2), both K-major in shared memory.
template <int C>
__device__ __forceinline__ void wgmma_half(float (&d)[C / 4], uint64_t da, uint64_t db) {
  if constexpr (C == 192)
    wgmma_m64n96<0, 0>(d, da, db);
  else
    wgmma_m64n192<0, 0>(d, da, db);
}

// The producer: per tile the input tile, then the weight chunks in the order
// the consumers use them (Wproj 0.., then W1 0, W2 0, W1 1, W2 1, ...).
template <int C, bool PROJ, bool MLP>
__device__ __forceinline__ void tail_feed(const TailMaps& maps, unsigned char* smem,
                                          long long tiles) {
  using L = WgTailLayout<C>;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t *x_full = bar, *x_empty = bar + 1, *full = bar + 2, *empty = bar + 2 + L::STAGES;
  uint32_t px = 0, seq = 0;
  auto next = [&](uint64_t*& b) {  // the next ring slot, once it is free
    const uint32_t i = seq % L::STAGES;
    mbar_wait(&empty[i], ((seq / L::STAGES) & 1) ^ 1);
    ++seq;
    b = &full[i];
    mbar_expect_tx(b, L::CHUNK);
    return smem + L::RING + i * L::CHUNK;
  };
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (int)(tile * WG_TAIL_ROWS);
    mbar_wait(x_empty, px ^ 1);
    px ^= 1;
    mbar_expect_tx(x_full, C / 64 * L::XBOX);
    for (int cb = 0; cb < C / 64; ++cb)
      tma_load(smem + L::X + cb * L::XBOX, &maps.in, x_full, 64 * cb, row0);
    uint64_t* b;
    if (PROJ)
      for (int kc = 0; kc < C / 64; ++kc) {
        unsigned char* s = next(b);
        for (int ob = 0; ob < C / 64; ++ob)
          tma_load(s + ob * L::XBOX, &maps.wproj, b, 64 * kc, 64 * ob);
      }
    if (MLP)
      for (int j0 = 0; j0 < 4 * C; j0 += 64) {
        unsigned char* s = next(b);
        for (int cb = 0; cb < C / 32; ++cb) tma_load(s + cb * L::WBOX, &maps.w1, b, 32 * cb, j0);
        s = next(b);
        for (int cb = 0; cb < C / 64; ++cb) tma_load(s + cb * L::XBOX, &maps.w2, b, j0, 64 * cb);
      }
  }
}

// The consumers' wait for ring chunk `seq`: its slot.
template <int C>
__device__ __forceinline__ unsigned char* ring_chunk(unsigned char* smem, uint64_t* full,
                                                     uint32_t seq) {
  using L = WgTailLayout<C>;
  const uint32_t i = seq % L::STAGES;
  mbar_wait(&full[i], (seq / L::STAGES) & 1);
  return smem + L::RING + i * L::CHUNK;
}

// Release ring chunk `seq` (lane 0 of every consumer warp).
template <int C>
__device__ __forceinline__ void ring_release(uint64_t* empty, uint32_t seq, int lane) {
  if (lane == 0) mbar_arrive(&empty[seq % WgTailLayout<C>::STAGES]);
}

// y (the warpgroup's half of the columns) = A Wproj^T over C / 64 chunks of
// Wproj, A the 64 x C tile at X; ring chunks seq, seq + 1, ...
template <int C>
__device__ __forceinline__ void tail_projection(unsigned char* smem, uint64_t* full,
                                                uint64_t* empty, uint32_t& seq, int w, int lane,
                                                float (&y)[C / 4]) {
  using L = WgTailLayout<C>;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) y[i] = 0.f;
  for (int kc = 0; kc < C / 64; ++kc, ++seq) {
    const unsigned char* wp = ring_chunk<C>(smem, full, seq);
    reg_fence(y);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_half<C>(y, gmma_desc(smem + L::X + kc * L::XBOX + k * 32, 16, 1024, SW128),
                    gmma_desc(wp + w * L::HALF * 128 + k * 32, 16, 1024, SW128));
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();  // the previous chunk's product is done: release it
      ring_release<C>(empty, seq - 1, lane);
    }
  }
  wgmma_wait<0>();
  reg_fence(y);
  ring_release<C>(empty, seq - 1, lane);
}

// y (the warpgroup's half of the columns) = bf16(GELU(X W1^T + b1)) W2^T,
// over the 4C / 64 chunks of the hidden; ring chunks W1, W2 alternate from
// seq. nh counts the hidden tiles this CTA has written (the double buffer).
// Releases the input tile (x_empty) after the last h.
template <int C>
__device__ __forceinline__ void tail_mlp(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                         uint64_t* x_empty, uint32_t& seq, uint32_t& nh,
                                         const bf16* __restrict__ b1, int w, int lane, int rl,
                                         float (&y)[C / 4]) {
  using L = WgTailLayout<C>;
  constexpr int NCH = 4 * C / 64;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) y[i] = 0.f;
  for (int ch = 0; ch < NCH; ++ch, seq += 2, ++nh) {
    const int j0 = 64 * ch;
    // h = X W1[j0 + 32 w .., :]^T: A K-major (X), B K-major (the W1 chunk's rows 32 w ..)
    const unsigned char* w1s = ring_chunk<C>(smem, full, seq);
    float h[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = 0.f;
    reg_fence(h);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < C / 16; ++k)
      wgmma_m64n32<0, 0>(
          h, gmma_desc(smem + L::X + (k / 4) * L::XBOX + (k % 4) * 32, 16, 1024, SW128),
          gmma_desc(w1s + (k / 2) * L::WBOX + 2048 * w + (k % 2) * 32, 16, 512, SW64));
    wgmma_commit();
    if (ch > 0) {
      wgmma_wait<1>();  // the previous chunk's y product is done: release its W2
      ring_release<C>(empty, seq - 1, lane);
    }
    wgmma_wait<0>();
    reg_fence(h);
    ring_release<C>(empty, seq, lane);
    if (ch == NCH - 1 && lane == 0) mbar_arrive(x_empty);  // X is read for this tile
    // the hidden: bf16(GELU(h + b1)) -> this warpgroup's 32 columns of the tile
    unsigned char* hid = smem + L::HID + (nh & 1) * L::XBOX;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int cl = 32 * w + 8 * g + 2 * (lane & 3);  // column in the chunk
      const float2 bb =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + j0 + cl));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = rl + 8 * hr;
        const int off = r * 128 + (((cl >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2;
        *reinterpret_cast<__nv_bfloat162*>(hid + off) = __floats2bfloat162_rn(
            gelu(h[4 * g + 2 * hr] + bb.x), gelu(h[4 * g + 2 * hr + 1] + bb.y));
      }
    }
    fence_async_smem();     // the hidden is read by wgmma (async proxy)
    named_barrier(1, 256);  // both halves of the hidden tile are written
    // y[:, w HALF ..] += hidden W2[w HALF .., j0 ..]^T: A and B K-major
    const unsigned char* w2s = ring_chunk<C>(smem, full, seq + 1);
    reg_fence(y);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_half<C>(y, gmma_desc(hid + k * 32, 16, 1024, SW128),
                    gmma_desc(w2s + w * L::HALF * 128 + k * 32, 16, 1024, SW128));
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(y);
  ring_release<C>(empty, seq - 1, lane);
}

// v += the bf16 bias at the thread's columns (c0 + 8 g, + 1).
template <int C>
__device__ __forceinline__ void add_bias(float (&v)[C / 4], const bf16* __restrict__ bias,
                                         int c0) {
#pragma unroll
  for (int g = 0; g < C / 16; ++g) {
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c0 + 8 * g));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      v[4 * g + 2 * hr] += b.x;
      v[4 * g + 2 * hr + 1] += b.y;
    }
  }
}

// Sums over the C columns of the thread's two rows (rl, rl + 8), both
// warpgroups' halves: v[hr][k] holds the thread's part of sum k of row rl + 8
// hr. Each row's four lanes reduce their columns, lane 0 of the four writes
// the warpgroup's sums to `buf` ([warpgroup][row][4] floats), and after a
// barrier of the consumers both halves are added in a fixed order; v holds
// the totals.
template <int K>
__device__ __forceinline__ void row_sums(float (&v)[2][K], float* buf, int w, int rl, int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (int o = 1; o < 4; o <<= 1) v[hr][k] += __shfl_xor_sync(0xffffffffu, v[hr][k], o);
      if ((lane & 3) == 0) buf[(w * 64 + rl + 8 * hr) * 4 + k] = v[hr][k];
    }
  named_barrier(2, 256);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[hr][k] = buf[(rl + 8 * hr) * 4 + k] + buf[(64 + rl + 8 * hr) * 4 + k];
}

// LayerNorm statistics of the thread's two rows of v: mu and rstd per row,
// variance E[v^2] - mu^2, eps 1e-5 (row_sums of v and v^2).
template <int C>
__device__ __forceinline__ void row_stats(const float (&v)[C / 4], float* buf, int w, int rl,
                                          int lane, float (&mu)[2], float (&rs)[2]) {
  float sq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int g = 0; g < C / 16; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = v[4 * g + j];
      sq[j >> 1][0] += t;
      sq[j >> 1][1] += t * t;
    }
  row_sums<2>(sq, buf, w, rl, lane);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mu[hr] = sq[hr][0] / C;
    rs[hr] = rsqrtf(sq[hr][1] / C - mu[hr] * mu[hr] + kLnEps);
  }
}

// The row kernel's tensors (null where its mode reads nothing; see
// mlp_tail_kernel). s1, s2: one f32 per `rows_per_scale` rows. The kernel
// takes them as separate __restrict__ parameters: as members of a struct the
// compiler must assume the output may alias the inputs, and it orders every
// epilogue load after the stores before it.
struct TailArgs {
  const bf16 *x, *bproj, *b1, *b2, *gy;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b, *s1, *s2;
  bf16 *out, *a_out, *x1_out;
  float *ds, *part;
  long long rows, rows_per_scale;
};

// BWD (the row pass of an MLP-tail backward, MLP): from the output gradient gy
// and the scale s2 (K7: per row; K12: one per `rows_per_scale` rows), per row
// ds = sum gy (yhat LN2_s + LN2_b), and dy = LN backward of s2 gy written to
// `out` (bf16); the f32 column sums of s2 gy yhat, s2 gy and dy (dgamma,
// dbeta, db2) over this CTA's rows go to part[k][4 blockIdx + warp in the
// warpgroup][C], k = 0, 1, 2 (4 grid partials of each, summed in order by the
// caller). With PROJ (K12) the MLP input is recomputed first and a and x1, its
// bf16 rounding points, go to a_out and x1_out.
// RAW (K8, MLP without PROJ): out = bf16(y), no LayerNorm, scale or residual.
template <int C, bool PROJ, bool MLP, bool TRAIN, bool BWD = false, bool RAW = false>
__global__ void __launch_bounds__(WG_TAIL_THREADS, 1)
mlp_tail_kernel(const __grid_constant__ TailMaps maps, const bf16* __restrict__ x,
                const bf16* __restrict__ bproj, const bf16* __restrict__ b1,
                const bf16* __restrict__ b2, const bf16* __restrict__ gy,
                const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                const float* __restrict__ s1, const float* __restrict__ s2,
                bf16* __restrict__ out, float* __restrict__ ds, float* __restrict__ part,
                bf16* __restrict__ a_out, bf16* __restrict__ x1_out, long long rows,
                long long rows_per_scale) {
  static_assert(PROJ || MLP, "a tail projects, runs the MLP, or both");
  static_assert(!BWD || (MLP && (!PROJ || TRAIN)), "the row pass is a training MLP tail's");
  static_assert(!RAW || (MLP && !PROJ && !BWD), "the raw MLP has no tail");
  using L = WgTailLayout<C>;
  constexpr int NV = C / 4;           // f32 values of a thread's half of a 64 x C tile
  constexpr int NG = C / 16;          // its 8-column groups (two columns each)
  constexpr int OWN = (NG + 7) / 8;   // groups of the warp's column sums a lane keeps (BWD)
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t *x_full = bar, *x_empty = bar + 1, *full = bar + 2, *empty = bar + 2 + L::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (rows + WG_TAIL_ROWS - 1) / WG_TAIL_ROWS;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled boxes need 1024-byte alignment
    mbar_init(x_full, 1);                 // full: the producer's arrival with the bytes
    mbar_init(x_empty, 8);                // empty: lane 0 of every consumer warp
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= 8) {  // the producer warpgroup: one thread feeds the tiles
    setmaxnreg_dec<WG_PRODUCER_REGS>();
    if (warp == 8 && lane == 0) tail_feed<C, PROJ, MLP>(maps, smem, tiles);
    return;
  }

  // ---- consumers: warpgroup w owns output columns w HALF .. of every tile
  setmaxnreg_inc<WG_CONSUMER_REGS>();
  const int w = warp >> 2;
  const int rl = 16 * (warp & 3) + (lane >> 2);  // the thread's first row in the tile (and rl + 8)
  const int c0 = w * L::HALF + 2 * (lane & 3);    // its first column (and + 8 g, + 1)
  uint32_t px = 0, seq = 0, nh = 0, nt = 0;
  float y[NV];
  volatile float x1s[PROJ && MLP && !BWD ? NV : 1];  // x1 for the final residual (see the header)
  float colp[BWD ? OWN : 1][2][3] = {};      // BWD: the warp's column sums this lane keeps
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++nt) {
    const long long row0 = tile * WG_TAIL_ROWS;
    // the exchanges LN1 (or BWD's row sums) and LN2, of this tile's parity
    float* stats = reinterpret_cast<float*>(smem + L::STATS) + (nt & 1) * 512;
    mbar_wait(x_full, px);
    px ^= 1;
    if constexpr (PROJ) {
      tail_projection<C>(smem, full, empty, seq, w, lane, y);
      if (!MLP && lane == 0) mbar_arrive(x_empty);
      add_bias<C>(y, bproj, c0);
      if (TRAIN) {  // the attention output as the unfused chain writes it
#pragma unroll
        for (int i = 0; i < NV; ++i) y[i] = __bfloat162float(__float2bfloat16(y[i]));
      }
      float mu[2], rs[2];
      row_stats<C>(y, stats, w, rl, lane, mu, rs);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = rl + 8 * hr;
        const long long row = row0 + r;
        const bool live = row < rows;
        const float sc = TRAIN && live ? s1[row / rows_per_scale] : 1.f;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c = c0 + 8 * g;
          const float2 gm = *reinterpret_cast<const float2*>(ln1_s + c);
          const float2 bt = *reinterpret_cast<const float2*>(ln1_b + c);
          const float2 xr = live ? __bfloat1622float2(
                                       *reinterpret_cast<const __nv_bfloat162*>(x + row * C + c))
                                 : make_float2(0.f, 0.f);
          float v0 = xr.x + sc * ((y[4 * g + 2 * hr] - mu[hr]) * rs[hr] * gm.x + bt.x);
          float v1 = xr.y + sc * ((y[4 * g + 2 * hr + 1] - mu[hr]) * rs[hr] * gm.y + bt.y);
          const __nv_bfloat162 vb = __floats2bfloat162_rn(v0, v1);
          if (TRAIN) {
            v0 = __low2float(vb);
            v1 = __high2float(vb);
          }
          if constexpr (BWD) {  // a (already rounded) and x1 to their slabs
            if (live) {
              *reinterpret_cast<__nv_bfloat162*>(a_out + row * C + c) =
                  __floats2bfloat162_rn(y[4 * g + 2 * hr], y[4 * g + 2 * hr + 1]);
              *reinterpret_cast<__nv_bfloat162*>(x1_out + row * C + c) = vb;
            }
          } else if constexpr (MLP) {
            x1s[4 * g + 2 * hr] = v0;
            x1s[4 * g + 2 * hr + 1] = v1;
          }
          if constexpr (MLP) {
            *reinterpret_cast<__nv_bfloat162*>(smem + L::X + (c >> 6) * L::XBOX + r * 128 +
                                               ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                                               (c & 7) * 2) = vb;
          } else if (live) {
            *reinterpret_cast<__nv_bfloat162*>(out + row * C + c) = vb;
          }
        }
      }
      if constexpr (MLP) {
        fence_async_smem();     // bf16(x1) is read by wgmma (async proxy)
        named_barrier(1, 256);  // both halves of it are written
      }
    }
    if constexpr (MLP) {
      tail_mlp<C>(smem, full, empty, x_empty, seq, nh, b1, w, lane, rl, y);
      add_bias<C>(y, b2, c0);
      if constexpr (RAW) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = row0 + rl + 8 * hr;
          if (row >= rows) continue;
#pragma unroll
          for (int g = 0; g < NG; ++g)
            *reinterpret_cast<__nv_bfloat162*>(out + row * C + c0 + 8 * g) =
                __floats2bfloat162_rn(y[4 * g + 2 * hr], y[4 * g + 2 * hr + 1]);
        }
        continue;
      }
      float mu[2], rs[2];
      row_stats<C>(y, stats + 1024, w, rl, lane, mu, rs);
      if constexpr (BWD) {
        // yhat over y; per row ds, m1 = sum dyh and m2 = sum dyh yhat, dyh = s gy LN2_s.
        // PROJ (K12): s2 is per sample, its index (a 64-bit division) formed once a row
        float s2r[2] = {0.f, 0.f};
        if constexpr (PROJ) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const long long row = row0 + rl + 8 * hr;
            if (row < rows) s2r[hr] = s2[row / rows_per_scale];
          }
        }
        float sums[2][3] = {};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = row0 + rl + 8 * hr;
          const bool live = row < rows;
          const float sc = live ? (PROJ ? s2r[hr] : s2[row]) : 0.f;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int c = c0 + 8 * g;
            const float2 gm = *reinterpret_cast<const float2*>(ln2_s + c);
            const float2 bt = *reinterpret_cast<const float2*>(ln2_b + c);
            const float2 gv = live ? __bfloat1622float2(
                                         *reinterpret_cast<const __nv_bfloat162*>(gy + row * C + c))
                                   : make_float2(0.f, 0.f);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * g + 2 * hr + e;
              const float yh = (y[i] - mu[hr]) * rs[hr], ge = e ? gv.y : gv.x;
              const float gme = e ? gm.y : gm.x, bte = e ? bt.y : bt.x;
              y[i] = yh;
              sums[hr][0] += ge * (yh * gme + bte);
              const float dyh = ge * sc * gme;
              sums[hr][1] += dyh;
              sums[hr][2] += dyh * yh;
            }
          }
        }
        row_sums<3>(sums, stats, w, rl, lane);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = row0 + rl + 8 * hr;
          if (w == 0 && (lane & 3) == 0 && row < rows) ds[row] = sums[hr][0];
        }
        // dy = rstd (dyh - m1 / C - yhat m2 / C), stored; the column sums of
        // the warp's 16 rows, kept by the lane whose row (lane / 4) is g % 8
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c = c0 + 8 * g;
          const float2 gm = *reinterpret_cast<const float2*>(ln2_s + c);
          float p[3][2] = {};
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const long long row = row0 + rl + 8 * hr;
            const bool live = row < rows;
            const float sc = live ? (PROJ ? s2r[hr] : s2[row]) : 0.f;
            const float2 gv = live ? __bfloat1622float2(
                                         *reinterpret_cast<const __nv_bfloat162*>(gy + row * C + c))
                                   : make_float2(0.f, 0.f);
            float dy[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float yh = y[4 * g + 2 * hr + e], gb = (e ? gv.y : gv.x) * sc;
              dy[e] = rs[hr] * (gb * (e ? gm.y : gm.x) - sums[hr][1] / C - yh * (sums[hr][2] / C));
              p[0][e] += gb * yh;
              p[1][e] += gb;
              p[2][e] += live ? dy[e] : 0.f;
            }
            if (live)
              *reinterpret_cast<__nv_bfloat162*>(out + row * C + c) =
                  __floats2bfloat162_rn(dy[0], dy[1]);
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              for (int o = 4; o < 32; o <<= 1) p[k][e] += __shfl_xor_sync(0xffffffffu, p[k][e], o);
              if ((g & 7) == (lane >> 2)) colp[g >> 3][e][k] += p[k][e];
            }
        }
      } else {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = row0 + rl + 8 * hr;
          if (row >= rows) continue;
          const float sc = s2 ? s2[row / rows_per_scale] : 1.f;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int c = c0 + 8 * g;
            const float2 gm = *reinterpret_cast<const float2*>(ln2_s + c);
            const float2 bt = *reinterpret_cast<const float2*>(ln2_b + c);
            float2 res;
            if constexpr (PROJ) {
              res = make_float2(x1s[4 * g + 2 * hr], x1s[4 * g + 2 * hr + 1]);
            } else {
              res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + row * C + c));
            }
            *reinterpret_cast<__nv_bfloat162*>(out + row * C + c) = __floats2bfloat162_rn(
                res.x + sc * ((y[4 * g + 2 * hr] - mu[hr]) * rs[hr] * gm.x + bt.x),
                res.y + sc * ((y[4 * g + 2 * hr + 1] - mu[hr]) * rs[hr] * gm.y + bt.y));
          }
        }
      }
    }
  }
  if constexpr (BWD) {  // this CTA's column sums, one partial per warp of a warpgroup
    const long long parts = 4LL * gridDim.x, p = 4LL * blockIdx.x + (warp & 3);
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if ((g & 7) == (lane >> 2))
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<float2*>(part + (k * parts + p) * C + c0 + 8 * g) =
              make_float2(colp[g >> 3][0][k], colp[g >> 3][1][k]);
  }
}

// CTAs of the row kernel at `rows`: one per SM, at most one per 64-row tile.
inline int tail_grid(long long rows) {
  const long long tiles = (rows + WG_TAIL_ROWS - 1) / WG_TAIL_ROWS;
  const int sms = sm_count();
  return (int)(sms > 0 && sms < tiles ? sms : tiles);
}

// The row kernel on `stream` over a.rows rows of `in` (see mlp_tail_kernel),
// tail_grid(a.rows) CTAs. Null pointers where the mode reads nothing (Wproj
// without PROJ; W1 and W2 without MLP). Base addresses 16-byte aligned.
template <int C, bool PROJ, bool MLP, bool TRAIN, bool BWD = false, bool RAW = false>
cudaError_t launch_mlp_tail(const bf16* in, const bf16* wproj, const bf16* w1, const bf16* w2,
                            const TailArgs& a, cudaStream_t stream) {
  using L = WgTailLayout<C>;
  if (a.rows < 1 || a.rows_per_scale < 1) return cudaErrorInvalidValue;
  TailMaps maps{};
  if (!tensor_map(&maps.in, in, C, a.rows, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (PROJ && !tensor_map(&maps.wproj, wproj, C, C, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (MLP && (!tensor_map(&maps.w1, w1, C, 4 * C, C, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B) ||
               !tensor_map(&maps.w2, w2, 4 * C, C, 4 * C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_tail_kernel<C, PROJ, MLP, TRAIN, BWD, RAW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  mlp_tail_kernel<C, PROJ, MLP, TRAIN, BWD, RAW>
      <<<tail_grid(a.rows), WG_TAIL_THREADS, L::SMEM, stream>>>(
          maps, a.x, a.bproj, a.b1, a.b2, a.gy, a.ln1_s, a.ln1_b, a.ln2_s, a.ln2_b, a.s1, a.s2,
          a.out, a.ds, a.part, a.a_out, a.x1_out, a.rows, a.rows_per_scale);
  return cudaGetLastError();
}

// The token tail of a block (K1: TRAIN false; K11: TRAIN true; K2's LN mode:
// MLP false) over `rows` rows: `attn` the attention output, x the block input,
// s1 and s2 one per `rows_per_sample` rows (TRAIN) or null.
template <int C, bool TRAIN, bool MLP = true>
cudaError_t launch_tail(long long rows, cudaStream_t stream, const bf16* x, const bf16* attn,
                        const bf16* wproj, const bf16* bproj, const float* ln1_s,
                        const float* ln1_b, const bf16* w1, const bf16* b1, const bf16* w2,
                        const bf16* b2, const float* ln2_s, const float* ln2_b, const float* s1,
                        const float* s2, long long rows_per_sample, bf16* out) {
  TailArgs a{};
  a.x = x;
  a.bproj = bproj;
  a.ln1_s = ln1_s;
  a.ln1_b = ln1_b;
  a.b1 = b1;
  a.b2 = b2;
  a.ln2_s = ln2_s;
  a.ln2_b = ln2_b;
  a.s1 = TRAIN ? s1 : nullptr;
  a.s2 = TRAIN ? s2 : nullptr;
  a.out = out;
  a.rows = rows;
  a.rows_per_scale = rows_per_sample;
  return launch_mlp_tail<C, true, MLP, TRAIN>(attn, wproj, w1, w2, a, stream);
}

}  // namespace
