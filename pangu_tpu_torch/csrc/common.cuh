// Device helpers shared by the port's CUDA sources (sm_90a): the window
// geometry (and K1's folded addressing), the GELU, warp reductions, cp.async
// staging with a two-stage ring, the mma.sync product with its ldmatrix
// fragment loads, the wmma fragment types, and the reduction of per-CTA f32
// partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLnEps = 1e-5f;
constexpr int T = 144;                          // tokens per window (2 x 6 x 12)
constexpr int D = 32;                           // head dim

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

// K1's fold mode (window_attention.cuh): a shifted block's cyclic shift and the
// pad rows' re-zero applied in the window gather. The grid is read as if rolled
// by -(sz, sh, sw) (each shift in [0, its window dim)) with the lat rows >= h
// zeroed first.
struct Fold {
  int sz, sh, sw, h;
};

// Row, within its batch image, of the grid position that token i of
// rolled-frame window (zi, hi, wi) reads under fold f: ((zi wz + dz + sz) mod Z,
// (hi wh + dh + sh) mod Hp, (wi ww + dw + sw) mod W). Bit 31 is set when that
// lat row is a pad row (>= f.h).
__device__ __forceinline__ uint32_t folded_row(const Geom& g, const Fold& f, int zi, int hi,
                                               int wi, int i) {
  const int dz = i / (g.wh * g.ww);
  const int r = i - dz * g.wh * g.ww;
  const int dh = r / g.ww;
  const int dw = r - dh * g.ww;
  int z = zi * g.wz + dz + f.sz, y = hi * g.wh + dh + f.sh, w = wi * g.ww + dw + f.sw;
  if (z >= g.Z) z -= g.Z;
  if (y >= g.Hp) y -= g.Hp;
  if (w >= g.W) w -= g.W;
  return (uint32_t)((z * g.Hp + y) * g.W + w) | (y >= f.h ? 0x80000000u : 0u);
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// exact-erf GELU, as the Pallas bodies compute it in f32
__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// d/dh GELU(h) = Phi(h) + h phi(h), exact-erf form
__device__ __forceinline__ float gelu_grad(float h) {
  return 0.5f * (1.f + erff(h * 0.70710678118654752f)) +
         h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16-byte global -> shared copies, completed by group ----------------
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}
// the same copy of src_bytes (0 or 16) bytes, the rest of the 16 zero-filled:
// a row read as zeros without touching its values
__device__ __forceinline__ void cp_async16_zfill(void* smem_ptr, const void* gptr,
                                                 uint32_t src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gptr),
               "r"(src_bytes));
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

// mma.sync m16n8k16, bf16 in, f32 sums (lane = 4 g + t): A (16 x 16) regs
// a0..a3 hold (row g, cols 2t, 2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8,
// 2t + 8..); B (16 x 8) b0, b1 hold (rows 2t, 2t+1; col g), (rows 2t + 8..;
// col g); d (16 x 8) d0, d1 at (row g, cols 2t, 2t+1), d2, d3 at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, lane i giving the address of row
// i % 8 of matrix i / 8; .trans hands each lane the transposed elements
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Row-major storage X (ld elements a row), the 16 x 16 block at (r0, c0):
// the A fragment of X (ldsm_x4), the A fragment of X^T (ldsm_x4_t at block
// (k0, m0) = (r0, c0)); the B fragments of two n8 tiles when X is stored n x k
// (bfrag_nk: rows n0.., cols k0..) or k x n (bfrag_kn: rows k0.., cols n0..,
// ldsm_x4_t): regs 0, 1 for n0.., 2, 3 for n0 + 8...
__device__ __forceinline__ const bf16* afrag_at(const bf16* X, int ld, int r0, int c0, int lane) {
  return X + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 + 8 * (lane >> 4);
}
__device__ __forceinline__ const bf16* atfrag_at(const bf16* X, int ld, int k0, int m0, int lane) {
  return X + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ const bf16* bfrag_nk(const bf16* X, int ld, int n0, int k0, int lane) {
  return X + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ const bf16* bfrag_kn(const bf16* X, int ld, int k0, int n0, int lane) {
  return X + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[i] = sum_p part[p * n + i], in order p = 0, 1, ... (deterministic), as
// bf16 (out_bf16) or f32 (out_f32): the second pass of every cross-CTA sum.
__device__ __forceinline__ void sum_partials(const float* __restrict__ part, int parts,
                                             long long n, bf16* __restrict__ out_bf16,
                                             float* __restrict__ out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[p * n + i];
  if (out_bf16) out_bf16[i] = __float2bfloat16(s);
  else out_f32[i] = s;
}

__global__ void reduce_partials_kernel(const float* __restrict__ part, int parts, long long n,
                                       bf16* __restrict__ out_bf16, float* __restrict__ out_f32) {
  sum_partials(part, parts, n, out_bf16, out_f32);
}

cudaError_t reduce_partials(const float* part, int parts, long long n, bf16* out_bf16,
                            float* out_f32, cudaStream_t stream) {
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, parts, n,
                                                                         out_bf16, out_f32);
  return cudaGetLastError();
}

}  // namespace
