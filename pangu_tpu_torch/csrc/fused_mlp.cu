// MLP of an Earth-Specific block in training, bf16 -- CUDA for Hopper
// (sm_90a): the MLP tail with its post-norm residual, and the raw MLP, each
// forward and backward.
//
// Replaces pangu_tpu/ops/fused_mlp.py::fused_mlp_postnorm (K6, the Pallas
// kernel _make_postnorm_fwd_kernel) and its backward _postnorm_bwd (K7,
// _make_postnorm_bwd_kernel), fused_mlp (K8, _make_raw_fwd_kernel) with its
// backward _raw_bwd (K9, _make_raw_bwd_kernel), and the inference MLP tail
// fused_mlp_block (K10, _make_kernel; its backward is XLA in the JAX package,
// so it has no kernel here either). Per token row of x (rows, C):
//
//   K6  out = bf16(x + s * LN(GELU(x @ W1^T + b1) @ W2^T + b2))
//   K10 out = bf16(x + LN(GELU(x @ W1^T + b1) @ W2^T + b2))
//   K7  dx, dW1, db1, dW2, db2, dgamma, dbeta, ds from g = dL/dout
//   K8  out = bf16(GELU(x @ W1^T + b1) @ W2^T + b2)
//   K9  dx = bf16(dh W1), dW1, db1, dW2, db2 from g = dL/dout
//
// with the rounding points of the Pallas bodies: the GELU hidden a, the LN
// input gradient dy and the hidden gradient dh are rounded to bf16 where they
// feed a product; the pre-activation h, the MLP output y, the LayerNorm
// (E[y^2] - mu^2, eps 1e-5), the residual and every sum stay f32. Weights
// come in nn.Linear's (out, in) layout, W1 (4C, C) and W2 (C, 4C); the weight
// and bias grads come back in it, rounded to bf16 as the Pallas wrapper
// rounds them to the argument dtype; dgamma, dbeta and ds (one per row) are
// f32. s is the per-row f32 branch scale (stochastic depth).
//
// Design.
//
//  * K6 and K10 run mlp_tail_kernel<C, false, true, false> (mlp_wg.cuh, shared
//    with the token tail of K1, K11 and K2's LN mode): a persistent CTA per
//    SM walks 64-row tiles, x resident in shared memory (TMA), a producer
//    warp streaming 64-column chunks of W1 and W2 through a ring of
//    mbarrier-guarded slots, two consumer warpgroups forming the hidden chunk
//    on wgmma, GELU in registers, and y[:, their half] on wgmma; LN, scale and
//    residual per row. K10 passes no scale: with s = 1 the two give the same
//    bits. Any multiple of 48 rows: the last 64-row tile is masked.
//  * the backward K7, a row pass, a hidden pass and two products over all rows:
//    - the row pass, mlp_tail_kernel<C, false, true, false, true>: K6's
//      kernel recomputes y and, per row, forms ds and dy = LN backward of s g
//      (written bf16, (rows, C)); the column sums of dgamma, dbeta and db2
//      go over the warp's rows by shuffles, are kept across the CTA's tiles
//      by the lanes, and leave as four f32 partials per CTA;
//    - mlp_hidden_bwd_kernel<C> (wgmma): 64-row tiles, x and dy resident in
//      shared memory, one producer warp feeding the W2 and W1 chunks of each
//      64-column hidden chunk by TMA (one buffer each: W2 is released after
//      h and dP, W1 after dx, so each load overlaps the other product); two
//      consumer warpgroups each form h = x W1^T and dP = dy W2[:, chunk] for
//      32 of the chunk's columns, a = bf16(GELU(h)) and dh = bf16(dP
//      GELU'(h)) in registers, written to a double-buffered staging tile
//      (the dh tile is also the A operand of dx) and from there to the (rows,
//      4C) slabs with 16-byte stores; then each accumulates dx[:, its half]
//      += dh W1[chunk, half] (f32 registers: 48 or 96 a thread). db1: f32
//      column sums of dh, rows and warps in a fixed order, per-CTA partials.
//      A partial last tile is read as zeros and not stored.
//    - dW2 = dy^T a and dW1 = dh^T x over the rows are gemm.cuh's wgmma
//      row-split products.
//    Every cross-CTA sum goes through per-CTA partials reduced in a fixed
//    order (reduce_partials): the result is the same on every run.
//  * mlp_raw_kernel<C> (K8): the raw MLP on mlp_tile.cuh's wmma engine (48-row
//    tiles of 12 warps, the W chunks through a two-stage cp.async ring).
//  * K9 is K7 without its row pass: the hidden pass runs on g itself as the
//    output gradient and adds no residual to dx; db2 is the column sum of g
//    (gemm.cuh colsum), dW2 = g^T a and dW1 = dh^T x the row-split products.
//    The Pallas body carries dW1, dW2, db1 and db2 in VMEM across its
//    sequential grid; here they are per-CTA f32 partials summed in order.
//
// What bounds it on an H100: ~4 x rows x C x 4C FLOP forward (316 GFLOP at
// the outer stage) against two (rows, C) bf16 passes (0.4 GB): compute; the
// backward does ~3x the FLOP and moves the two hidden slabs (1.6 GB at the
// outer stage) once each way. K6, the row pass and the hidden pass stream W1
// and W2 (2 x 4C x C bf16) from the L2 for every 64-row tile, ~5 GB a call,
// and idle the tensor cores during their GELU epilogues: held by that feed
// and the epilogue rather than by the tensor-core peak. K8 is wmma fragments
// loaded from shared memory, held by those loads.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_mlp.py; the plain PyTorch versions are
// fused_mlp_postnorm_reference, fused_mlp_postnorm_bwd_reference,
// fused_mlp_reference and fused_mlp_bwd_reference there.

#include "gemm.cuh"
#include "mlp_tile.cuh"
#include "mlp_wg.cuh"

namespace {

// K8's shared memory: x, h, bf16 hidden, two stages; y (f32) reuses it all
// after the MLP
template <int C>
struct MlpLayout : MlpTile<C> {
  using M = MlpTile<C>;
  static constexpr int F_WORK = M::XB_BYTES + M::H_BYTES + M::HB_BYTES + 2 * M::STAGE_BYTES;
  static constexpr int F_SMEM = cmax(F_WORK, M::Y_BYTES);
  static_assert(F_SMEM <= 232448, "fits one CTA's shared memory");
};

// ---- Backward pass 2, the hidden pass, on wgmma -------------------------------------
constexpr int HB_ROWS = WG_TAIL_ROWS;         // rows per tile (one wgmma row block; tail_grid)
constexpr int HB_THREADS = 2 * 128 + 32;      // two consumer warpgroups + the producer warp

// Shared memory of the hidden pass (byte offsets; every box on a 1024-byte
// boundary): the x and dy tiles (64 x C, 64-channel boxes, 128-byte swizzle),
// one 64-column chunk of W1 (64 x C as (64 j, 32 c) boxes, 64-byte swizzle)
// and of W2 (C x 64 as (64 c, 32 j) boxes: [half][channel block]), two
// staging buffers of the a and dh tiles (64 x 64, 128-byte swizzle, dh also
// the A operand of dx), two db1 scratch rows per warp, the barriers.
template <int C>
struct HiddenLayout {
  static constexpr int XBOX = 64 * 64 * 2, WBOX = 64 * 32 * 2;
  static constexpr int X = 0, DY = X + C / 64 * XBOX, W1 = DY + C / 64 * XBOX;
  static constexpr int W2 = W1 + C / 32 * WBOX, STG = W2 + C / 32 * WBOX;
  static constexpr int DB1 = STG + 2 * 2 * XBOX, BAR = DB1 + 2 * 8 * 32 * 4;
  static constexpr int SMEM = BAR + 6 * 8;
  static_assert(SMEM <= 232448, "fits one CTA's shared memory");
};

struct HiddenMaps {
  CUtensorMap x, dy, w1, w2;
};

// The hidden pass of an MLP backward (K7, K9) over 64-row tiles, dy the MLP
// output's gradient: per 64-column chunk j0 of the 4C hidden, h = x W1^T + b1
// and dP = dy W2[:, j0:j0+64] (each warpgroup 32 of the columns), a =
// bf16(GELU(h)) and dh = bf16(dP GELU'(h)) to the (rows, 4C) slabs through
// the staging buffers (16-byte stores), dx[:, half w] += dh W1[j0:j0+64, half
// w] (warpgroup w, f32 in registers); dx = bf16(dx + gy) at the end of a tile
// (gy null: no residual, K9). db1 partials per CTA (f32 dh, rows and warps in
// a fixed order) in db1_part (grid x 4C). Rows past `rows` are read as zeros
// and not stored.
template <int C>
__global__ void __launch_bounds__(HB_THREADS, 1)
mlp_hidden_bwd_kernel(const __grid_constant__ HiddenMaps maps, const bf16* __restrict__ gy,
                      const bf16* __restrict__ b1, bf16* __restrict__ a_out,
                      bf16* __restrict__ dh_out, bf16* __restrict__ dx,
                      float* __restrict__ db1_part, long long rows) {
  using L = HiddenLayout<C>;
  constexpr int H4 = 4 * C, NCH = H4 / 64, HALF = C / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t *xy_full = bar, *xy_empty = bar + 1, *w1_full = bar + 2, *w1_empty = bar + 3;
  uint64_t *w2_full = bar + 4, *w2_empty = bar + 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (rows + HB_ROWS - 1) / HB_ROWS;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled boxes need 1024-byte alignment
    for (int i = 0; i < 6; i += 2) {
      mbar_init(&bar[i], 1);      // full: the producer's arrival with the bytes
      mbar_init(&bar[i + 1], 8);  // empty: lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer
    if (lane == 0) {
      uint32_t pxy = 0, pw1 = 0, pw2 = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (int)(tile * HB_ROWS);
        mbar_wait(xy_empty, pxy ^ 1);
        pxy ^= 1;
        mbar_expect_tx(xy_full, 2 * (C / 64) * L::XBOX);
        for (int cb = 0; cb < C / 64; ++cb) {
          tma_load(smem + L::X + cb * L::XBOX, &maps.x, xy_full, 64 * cb, row0);
          tma_load(smem + L::DY + cb * L::XBOX, &maps.dy, xy_full, 64 * cb, row0);
        }
        for (int ch = 0; ch < NCH; ++ch) {
          const int j0 = 64 * ch;
          mbar_wait(w2_empty, pw2 ^ 1);
          pw2 ^= 1;
          mbar_expect_tx(w2_full, C / 32 * L::WBOX);
          for (int h = 0; h < 2; ++h)
            for (int cb = 0; cb < C / 64; ++cb)
              tma_load(smem + L::W2 + (h * (C / 64) + cb) * L::WBOX, &maps.w2, w2_full,
                       j0 + 32 * h, 64 * cb);
          mbar_wait(w1_empty, pw1 ^ 1);
          pw1 ^= 1;
          mbar_expect_tx(w1_full, C / 32 * L::WBOX);
          for (int cb = 0; cb < C / 32; ++cb)
            tma_load(smem + L::W1 + cb * L::WBOX, &maps.w1, w1_full, 32 * cb, j0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w forms hidden columns j0 + 32 w .. and dx columns w HALF ..
  const int w = warp >> 2, wi = warp & 3;
  const int rl = 16 * wi + (lane >> 2);  // the thread's first row in the tile (and rl + 8)
  uint32_t pxy = 0, pw1 = 0, pw2 = 0;
  int n = 0;  // chunks done by this CTA: staging buffer n & 1
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * HB_ROWS;
    float dxa[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) dxa[i] = 0.f;
    mbar_wait(xy_full, pxy);
    pxy ^= 1;
    for (int ch = 0; ch < NCH; ++ch, ++n) {
      const int j0 = 64 * ch;
      float hacc[16], pacc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) hacc[i] = pacc[i] = 0.f;
      // dP = dy W2[:, j0 + 32 w ..]: A K-major (dy), B MN-major (W2 half w)
      mbar_wait(w2_full, pw2);
      pw2 ^= 1;
      reg_fence(pacc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < C / 16; ++k)
        wgmma_m64n32<0, 1>(
            pacc, gmma_desc(smem + L::DY + (k / 4) * L::XBOX + (k % 4) * 32, 16, 1024, SW128),
            gmma_desc(smem + L::W2 + (w * (C / 64) + k / 4) * L::WBOX + (k % 4) * 1024, L::WBOX,
                      512, SW64));
      wgmma_commit();
      // h = x W1[j0 + 32 w .., :]^T: A K-major (x), B K-major (W1 rows 32 w ..)
      mbar_wait(w1_full, pw1);
      pw1 ^= 1;
      reg_fence(hacc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < C / 16; ++k)
        wgmma_m64n32<0, 0>(
            hacc, gmma_desc(smem + L::X + (k / 4) * L::XBOX + (k % 4) * 32, 16, 1024, SW128),
            gmma_desc(smem + L::W1 + (k / 2) * L::WBOX + 2048 * w + (k % 2) * 32, 16, 512,
                      SW64));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(hacc);
      reg_fence(pacc);
      if (lane == 0) {
        mbar_arrive(w2_empty);
        if (ch == NCH - 1) mbar_arrive(xy_empty);  // x and dy are read for this tile
      }
      // a = bf16(GELU(h)), dh = dP GELU'(h) -> staging (bf16), db1 (f32)
      const int buf = n & 1;
      unsigned char* sa = smem + L::STG + buf * 2 * L::XBOX;
      unsigned char* sd = sa + L::XBOX;
      float* scr = reinterpret_cast<float*>(smem + L::DB1) + buf * 8 * 32;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int cl = 32 * w + 8 * g + 2 * (lane & 3);  // column in the chunk
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + j0 + cl));
        float colsum[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rl + 8 * hr;
          const float h0 = hacc[4 * g + 2 * hr] + bb.x, h1 = hacc[4 * g + 2 * hr + 1] + bb.y;
          const float d0 = pacc[4 * g + 2 * hr] * gelu_grad(h0);
          const float d1 = pacc[4 * g + 2 * hr + 1] * gelu_grad(h1);
          colsum[0] += d0;
          colsum[1] += d1;
          const int off = r * 128 + (((cl >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2;
          *reinterpret_cast<__nv_bfloat162*>(sa + off) = __floats2bfloat162_rn(gelu(h0), gelu(h1));
          *reinterpret_cast<__nv_bfloat162*>(sd + off) = __floats2bfloat162_rn(d0, d1);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = colsum[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) scr[warp * 32 + 8 * g + 2 * lane + e] = v;
        }
      }
      fence_async_smem();           // dh is read by wgmma (async proxy)
      named_barrier(1, 256);        // both halves of the a and dh tiles are written
      // dx[:, w HALF ..] += dh W1[j0.., w HALF ..]: A K-major (dh), B MN-major (W1 boxes)
      reg_fence(dxa);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t da = gmma_desc(sd + k * 32, 16, 1024, SW128);
        const uint64_t db =
            gmma_desc(smem + L::W1 + w * (C / 64) * L::WBOX + k * 1024, L::WBOX, 512, SW64);
        if constexpr (HALF == 96)
          wgmma_m64n96<0, 1>(dxa, da, db);
        else
          wgmma_m64n192<0, 1>(dxa, da, db);
      }
      wgmma_commit();
      // meanwhile: the a and dh tiles to the slabs (16-byte stores), db1 of the chunk
      for (int q = threadIdx.x; q < 2 * 512; q += 256) {
        const int t = q >> 9, r = (q >> 3) & 63, c16 = q & 7;
        if (row0 + r >= rows) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(sa + t * L::XBOX + r * 128 +
                                                        ((c16 ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>((t ? dh_out : a_out) + (row0 + r) * H4 + j0 + 8 * c16) = v;
      }
      if (threadIdx.x < 64) {
        const int c = threadIdx.x, base = (c >> 5) * 4;
        float v = 0.f;
        for (int k = 0; k < 4; ++k) v += scr[(base + k) * 32 + (c & 31)];
        float* dst = db1_part + (long long)blockIdx.x * H4 + j0 + c;
        *dst = tile == blockIdx.x ? v : *dst + v;
      }
      wgmma_wait<0>();
      reg_fence(dxa);
      if (lane == 0) mbar_arrive(w1_empty);
    }
    // dx = bf16(dx + gy) for the tile's rows, columns w HALF ..
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long r = row0 + rl + 8 * hr;
      if (r >= rows) continue;
#pragma unroll
      for (int g = 0; g < HALF / 8; ++g) {
        const long long at = r * C + w * HALF + 8 * g + 2 * (lane & 3);
        float2 v = make_float2(dxa[4 * g + 2 * hr], dxa[4 * g + 2 * hr + 1]);
        if (gy) {
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gy + at));
          v.x += gv.x;
          v.y += gv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + at) = __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
}

// The hidden pass on `stream`: a, dh slabs, dx and the db1 partials (grid x 4C).
template <int C>
cudaError_t launch_hidden(const bf16* x, const bf16* dy, const bf16* gy, const bf16* w1,
                          const bf16* b1, const bf16* w2, bf16* a, bf16* dh, bf16* dx,
                          float* db1_part, long long rows, cudaStream_t stream) {
  using L = HiddenLayout<C>;
  HiddenMaps maps;
  if (!tensor_map(&maps.x, x, C, rows, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&maps.dy, dy, C, rows, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&maps.w1, w1, C, 4 * C, C, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&maps.w2, w2, 4 * C, C, 4 * C, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_hidden_bwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  mlp_hidden_bwd_kernel<C><<<tail_grid(rows), HB_THREADS, L::SMEM, stream>>>(
      maps, gy, b1, a, dh, dx, db1_part, rows);
  return cudaGetLastError();
}

// K8: out = bf16(GELU(x W1^T + b1) W2^T + b2). Loops over 48-row tiles.
template <int C>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
mlp_raw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, long long tiles) {
  using L = MlpLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* XB = reinterpret_cast<bf16*>(smem);
  float* H = reinterpret_cast<float*>(smem + L::XB_BYTES);
  bf16* HB = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES);
  bf16* S0 = reinterpret_cast<bf16*>(smem + L::XB_BYTES + L::H_BYTES + L::HB_BYTES);
  bf16* S1 = S0 + L::STAGE_BYTES / 2;
  float* Ys = reinterpret_cast<float*>(smem);  // after the MLP
  const int warp = threadIdx.x >> 5;
  const int mt = warp >> 2, ng = warp & 3;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TAIL_ROWS;
    stage_tile(XB, L::XB_LD, x + row0 * C, C, TAIL_ROWS, C);
    cp_async_commit();
    FragC yacc[L::NT];
    mlp_rows<C>(XB, H, HB, S0, S1, w1, b1, w2, yacc);
    for (int j = 0; j < L::NT; ++j)
      wmma::store_matrix_sync(Ys + mt * 16 * L::Y_LD + (ng + 4 * j) * 16, yacc[j], L::Y_LD,
                              wmma::mem_row_major);
    __syncthreads();
    for (int v = threadIdx.x; v < TAIL_ROWS * C / 8; v += TAIL_THREADS) {
      const int r = v / (C / 8), c = (v - r * (C / 8)) * 8;
      __align__(16) bf16 o[8];
      for (int e = 0; e < 8; ++e)
        o[e] = __float2bfloat16(Ys[r * L::Y_LD + c + e] + __bfloat162float(b2[c + e]));
      *reinterpret_cast<uint4*>(out + (row0 + r) * C + c) = *reinterpret_cast<const uint4*>(o);
    }
    __syncthreads();  // y is read: the next tile stages over it
  }
}

struct Args {
  const bf16 *x, *gy, *w1, *b1, *w2, *b2;
  const float *gamma, *beta, *s;
  bf16 *dy, *a, *dh, *out, *dw1, *db1, *dw2, *db2;
  float *part, *dgamma, *dbeta, *ds;
  long long rows;
};

// The row kernel's arguments for the MLP tail over p's rows (s one per row).
TailArgs tail_args(const Args& p) {
  TailArgs a{};
  a.x = p.x;
  a.b1 = p.b1;
  a.b2 = p.b2;
  a.gy = p.gy;
  a.ln2_s = p.gamma;
  a.ln2_b = p.beta;
  a.s2 = p.s;
  a.ds = p.ds;
  a.rows = p.rows;
  a.rows_per_scale = 1;
  return a;
}

// K6 (s, one per row) and K10 (s null): out = bf16(x + s LN(y)).
template <int C>
cudaError_t launch_fwd(const Args& p, cudaStream_t stream) {
  TailArgs a = tail_args(p);
  a.out = p.out;
  return launch_mlp_tail<C, false, true, false>(p.x, nullptr, p.w1, p.w2, a, stream);
}

// f32 scratch of K7 and K9: the row pass's partials, the hidden pass's db1
// partials and the weight grads' row-slice partials, one after the other.
template <int C>
long long bwd_scratch(long long rows) {
  long long n = 3LL * 4 * tail_grid(rows) * C;  // also holds the hidden pass's db1 partials
  if ((long long)COLSUM_BLOCKS * C > n) n = (long long)COLSUM_BLOCKS * C;
  const long long w = (long long)weight_grad_splits(C, 4 * C, rows) * 4 * C * C;
  return w > n ? w : n;
}

// The hidden pass, db1, then dW2 (C, 4C) = dy^T a and dW1 (4C, C) = dh^T x
// over the rows (dy = gy and no residual in dx for K9).
template <int C>
cudaError_t hidden_and_weight_grads(const Args& p, const bf16* dy, const bf16* gy,
                                    cudaStream_t stream) {
  cudaError_t err = launch_hidden<C>(p.x, dy, gy, p.w1, p.b1, p.w2, p.a, p.dh, p.out, p.part,
                                     p.rows, stream);
  if (err != cudaSuccess ||
      (err = reduce_partials(p.part, tail_grid(p.rows), 4LL * C, p.db1, nullptr, stream)) !=
          cudaSuccess ||
      (err = gemm<false, true>(dy, C, p.a, 4 * C, C, 4 * C, p.rows,
                               weight_grad_splits(C, 4 * C, p.rows), nullptr, p.dw2, p.part,
                               stream)) != cudaSuccess)
    return err;
  return gemm<false, true>(p.dh, 4 * C, p.x, C, 4 * C, C, p.rows,
                           weight_grad_splits(4 * C, C, p.rows), nullptr, p.dw1, p.part, stream);
}

// K7: the row pass (ds, dy and the partials of dgamma, dbeta and db2, four
// per CTA), their sums in order, then the hidden pass and the weight grads.
template <int C>
cudaError_t launch_bwd(const Args& p, cudaStream_t stream) {
  TailArgs a = tail_args(p);
  a.out = p.dy;
  a.part = p.part;
  cudaError_t err = launch_mlp_tail<C, false, true, false, true>(p.x, nullptr, p.w1, p.w2, a,
                                                                 stream);
  const int parts = 4 * tail_grid(p.rows);
  if (err != cudaSuccess ||
      (err = reduce_partials(p.part, parts, C, nullptr, p.dgamma, stream)) != cudaSuccess ||
      (err = reduce_partials(p.part + (long long)parts * C, parts, C, nullptr, p.dbeta, stream)) !=
          cudaSuccess ||
      (err = reduce_partials(p.part + 2LL * parts * C, parts, C, p.db2, nullptr, stream)) !=
          cudaSuccess)
    return err;
  return hidden_and_weight_grads<C>(p, p.dy, p.gy, stream);
}

template <int C>
cudaError_t launch_raw_fwd(const Args& p, cudaStream_t stream) {
  using L = MlpLayout<C>;
  const long long tiles = p.rows / TAIL_ROWS;
  const int grid = resident_ctas(mlp_raw_kernel<C>, L::F_SMEM, tiles);
  if (grid < 1) return cudaErrorInvalidValue;
  mlp_raw_kernel<C><<<grid, TAIL_THREADS, L::F_SMEM, stream>>>(p.x, p.w1, p.b1, p.w2, p.b2,
                                                               p.out, tiles);
  return cudaGetLastError();
}

// K9: the hidden pass on g (no residual in dx), db1, db2 = sum of g, dW2 = g^T
// a and dW1 = dh^T x over the rows.
template <int C>
cudaError_t launch_raw_bwd(const Args& p, cudaStream_t stream) {
  cudaError_t err = colsum(p.gy, p.rows, C, p.part, p.db2, stream);
  if (err != cudaSuccess) return err;
  return hidden_and_weight_grads<C>(p, p.gy, nullptr, stream);
}

// K6, K7, K9 and K10 take any multiple of 48 rows (their wgmma kernels mask
// the last 64-row tile); K8 a multiple of 96 (its 48-row tiles, GK)
bool rows_ok(long long rows) { return rows > 0 && rows % TAIL_ROWS == 0; }
bool raw_rows_ok(long long rows) { return rows_ok(rows) && rows % GK == 0; }

}  // namespace

extern "C" {

// K6 on `stream`: out = bf16(x + s * LN(GELU(x W1^T + b1) W2^T + b2)), s one f32
// per row. C 192 or 384 and rows a multiple of 48, else cudaErrorInvalidValue.
int pangu_mlp_postnorm_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* gamma, const void* beta, const void* s,
                           void* out, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.s = static_cast<const float*>(s);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_fwd<192>(p, st);
    case 384: return (int)launch_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K10 on `stream`: out = bf16(x + LN(GELU(x W1^T + b1) W2^T + b2)). C 192 or 384
// and rows a multiple of 48, else cudaErrorInvalidValue.
int pangu_mlp_block_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* gamma, const void* beta, void* out,
                        long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_fwd<192>(p, st);
    case 384: return (int)launch_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_mlp_postnorm_bwd needs (0: C or rows not
// taken: C 192 or 384, rows a multiple of 48).
long long pangu_mlp_postnorm_bwd_scratch(long long rows, int C) {
  if (!rows_ok(rows)) return 0;
  switch (C) {
    case 192: return bwd_scratch<192>(rows);
    case 384: return bwd_scratch<384>(rows);
    default: return 0;
  }
}

// K7 on `stream`, from gy = dL/dout: dx (rows, C) bf16; dw1 (4C, C), db1 (4C),
// dw2 (C, 4C), db2 (C) bf16; dgamma, dbeta (C) and ds (rows) f32. dy_buf (rows,
// C), a_buf and dh_buf (rows, 4C) are bf16 scratch, scratch has
// pangu_mlp_postnorm_bwd_scratch(rows, C) floats.
int pangu_mlp_postnorm_bwd(const void* x, const void* gy, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma, const void* beta,
                           const void* s, void* dy_buf, void* a_buf, void* dh_buf, void* scratch,
                           void* dx, void* dw1, void* db1, void* dw2, void* db2, void* dgamma,
                           void* dbeta, void* ds, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.s = static_cast<const float*>(s);
  p.dy = static_cast<bf16*>(dy_buf);
  p.a = static_cast<bf16*>(a_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.part = static_cast<float*>(scratch);
  p.out = static_cast<bf16*>(dx);
  p.dw1 = static_cast<bf16*>(dw1);
  p.db1 = static_cast<bf16*>(db1);
  p.dw2 = static_cast<bf16*>(dw2);
  p.db2 = static_cast<bf16*>(db2);
  p.dgamma = static_cast<float*>(dgamma);
  p.dbeta = static_cast<float*>(dbeta);
  p.ds = static_cast<float*>(ds);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_bwd<192>(p, st);
    case 384: return (int)launch_bwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8 on `stream`: out = bf16(GELU(x W1^T + b1) W2^T + b2). C 192 or 384 and rows
// a multiple of 96, else cudaErrorInvalidValue.
int pangu_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                  void* out, long long rows, int C, void* stream) {
  if (!raw_rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_raw_fwd<192>(p, st);
    case 384: return (int)launch_raw_fwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_mlp_bwd needs (0: C or rows not taken: C
// 192 or 384, rows a multiple of 48).
long long pangu_mlp_bwd_scratch(long long rows, int C) {
  if (!rows_ok(rows)) return 0;
  switch (C) {
    case 192: return bwd_scratch<192>(rows);
    case 384: return bwd_scratch<384>(rows);
    default: return 0;
  }
}

// K9 on `stream`, from gy = dL/dout: dx (rows, C), dw1 (4C, C), db1 (4C), dw2
// (C, 4C), db2 (C), all bf16. a_buf and dh_buf (rows, 4C) are bf16 scratch,
// scratch has pangu_mlp_bwd_scratch(rows, C) floats.
int pangu_mlp_bwd(const void* x, const void* gy, const void* w1, const void* b1, const void* w2,
                  void* a_buf, void* dh_buf, void* scratch, void* dx, void* dw1, void* db1,
                  void* dw2, void* db2, long long rows, int C, void* stream) {
  if (!rows_ok(rows)) return (int)cudaErrorInvalidValue;
  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.a = static_cast<bf16*>(a_buf);
  p.dh = static_cast<bf16*>(dh_buf);
  p.part = static_cast<float*>(scratch);
  p.out = static_cast<bf16*>(dx);
  p.dw1 = static_cast<bf16*>(dw1);
  p.db1 = static_cast<bf16*>(db1);
  p.dw2 = static_cast<bf16*>(dw2);
  p.db2 = static_cast<bf16*>(db2);
  p.rows = rows;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (C) {
    case 192: return (int)launch_raw_bwd<192>(p, st);
    case 384: return (int)launch_raw_bwd<384>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
