// The hidden pass of the MLP backwards on wgmma and TMA (sm_90a): K7's and
// K9's (fused_mlp.cu) and K12's (fused_block_train.cu). Per 64-row tile of x
// (the MLP input) and dy (the MLP output's gradient), h = x W1^T + b1 and dP =
// dy W2 are formed per 64-column chunk of the 4C hidden, a = bf16(GELU(h))
// and dh = bf16(dP GELU'(h)) go to (rows, 4C) slabs, db1 to per-CTA partials,
// and dx = dh W1 (+ gy) leaves as bf16 (K7, K9) or unrounded f32 (K12's dx1).
// The design is described at mlp_hidden_bwd_kernel and in fused_mlp.cu.

#pragma once

#include <type_traits>

#include "mlp_wg.cuh"

namespace {

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
// and not stored. DX: bf16 (dx rounded once) or float (dx unrounded, K12's dx1).
template <int C, typename DX>
__global__ void __launch_bounds__(HB_THREADS, 1)
mlp_hidden_bwd_kernel(const __grid_constant__ HiddenMaps maps, const bf16* __restrict__ gy,
                      const bf16* __restrict__ b1, bf16* __restrict__ a_out,
                      bf16* __restrict__ dh_out, DX* __restrict__ dx,
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
    // dx = dx + gy (rounded to DX) for the tile's rows, columns w HALF ..
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
        if constexpr (std::is_same<DX, float>::value)
          *reinterpret_cast<float2*>(dx + at) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(dx + at) = __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
}

// The hidden pass on `stream`: a, dh slabs, dx and the db1 partials (grid x 4C).
template <int C, typename DX>
cudaError_t launch_hidden(const bf16* x, const bf16* dy, const bf16* gy, const bf16* w1,
                          const bf16* b1, const bf16* w2, bf16* a, bf16* dh, DX* dx,
                          float* db1_part, long long rows, cudaStream_t stream) {
  using L = HiddenLayout<C>;
  HiddenMaps maps;
  if (!tensor_map(&maps.x, x, C, rows, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&maps.dy, dy, C, rows, C, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&maps.w1, w1, C, 4 * C, C, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&maps.w2, w2, 4 * C, C, 4 * C, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_hidden_bwd_kernel<C, DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  mlp_hidden_bwd_kernel<C, DX><<<tail_grid(rows), HB_THREADS, L::SMEM, stream>>>(
      maps, gy, b1, a, dh, dx, db1_part, rows);
  return cudaGetLastError();
}

}  // namespace
