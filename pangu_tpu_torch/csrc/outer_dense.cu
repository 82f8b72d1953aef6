// The Dense products of the model's outsides on bf16 tensor cores -- CUDA for
// Hopper (sm_90a), forward and backward: the patch embedding's and the patch
// recovery's per-token projections, the downsampling's and the upsampling's
// linears, and every other bf16 Dense on the card (ops/fused_block_attention.py
// ::dense).
//
//   forward   y  = bf16(x W^T + b)     x (rows, k) bf16, W (n, k) bf16, b (n) f32
//   backward  dx = bf16(dy W), dW = bf16(dy^T x), db = sum over rows of dy (f32)
//
// with f32 sums and one rounding each: the function of the plain formula
// (dense_reference: f32 products of the bf16 operands, which are exact, the f32
// bias, one rounding), only the order of the sums differs.
//
// It replaces no Pallas kernel: the JAX package's nn.Dense is XLA's dot. What
// bounds it on an H100 is bytes: at the flagship's shapes a product moves its
// bf16 input and output once for 2 k n FLOP a row, k and n 64 to 768, 20 to
// 170 FLOP per byte, under the card's ~295 FLOP/B ridge. So the design reads
// each operand once, straight from the tensors the model holds (no cast, no
// padded copy), and fuses the f32 bias and the rounding into the epilogue.
//
// Design: gemm.cuh's wgmma product (TMA stages, three consumer warpgroups, 192
// x 192 tiles) with its TAIL mode: the outsides' widths (n 160 and 64, k 112)
// are not multiples of the tile, so the maps read zeros past every end and the
// stores are masked. The weight grad is the row-split product over the token
// rows with f32 partials summed in a fixed order, and db f32 column sums of
// row slices (bf16x2 loads, coalesced) summed the same way: the same bits on
// every run, no atomics. The entry points carry
// names of their own (outer_dense_*) and share the device code of gemm.cuh.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_block_attention.py.

#include "gemm.cuh"

namespace {

template <bool ROWSPLIT, bool BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
outer_dense_kernel(const __grid_constant__ WgMaps maps, int M, int N, long long K,
                   long long kchunk, int units, const float* __restrict__ bias,
                   const float* __restrict__ addend, float* __restrict__ part,
                   bf16* __restrict__ out) {
  wg_gemm_body<ROWSPLIT, BT, true>(maps, M, N, K, kchunk, units, bias, addend, part, out);
}

__global__ void outer_dense_reduce_kernel(const float* __restrict__ part, int parts, long long n,
                                          bf16* __restrict__ out_bf16,
                                          float* __restrict__ out_f32) {
  sum_partials(part, parts, n, out_bf16, out_f32);
}

constexpr int DB_BLOCKS = 264, DB_THREADS = 1024;

// part[b * n + c]: column c of dy (rows, n) summed over the rows [b rpb, (b + 1)
// rpb) in a fixed order: thread (j, p) sums the column pair p over the rows j,
// j + J, ... of the slice (J = DB_THREADS / (n / 2) phases, bf16x2 loads, a
// warp reading 128 contiguous bytes a row), then the J phase sums are added in
// order j = 0, 1, ... n even, at most 2 DB_THREADS.
__global__ void __launch_bounds__(DB_THREADS)
outer_dense_bias_grad_kernel(const bf16* __restrict__ dy, long long rows, int n, long long rpb,
                             float* __restrict__ part) {
  __shared__ float2 phase[DB_THREADS];
  const int P = n / 2, J = DB_THREADS / P, p = threadIdx.x % P, j = threadIdx.x / P;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  if (j < J) {
    const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(dy) + p;
    float2 s = make_float2(0.f, 0.f);
#pragma unroll 4
    for (long long r = r0 + j; r < r1; r += J) {
      const float2 v = __bfloat1622float2(src[r * P]);
      s.x += v.x;
      s.y += v.y;
    }
    phase[j * P + p] = s;
  }
  __syncthreads();
  if (j == 0) {
    float2 t = phase[p];
    for (int q = 1; q < J; ++q) {
      t.x += phase[q * P + p].x;
      t.y += phase[q * P + p].y;
    }
    *reinterpret_cast<float2*>(part + (long long)blockIdx.x * n + 2 * p) = t;
  }
}

cudaError_t reduce(const float* part, int parts, long long n, bf16* out_bf16, float* out_f32,
                   cudaStream_t stream) {
  outer_dense_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, parts, n,
                                                                             out_bf16, out_f32);
  return cudaGetLastError();
}

// Binds the calling thread to its device's primary context: the tensor-map
// encoder needs a current context, and a thread that has made no CUDA call of
// its own yet (the autograd engine's backward worker, say) may have none.
cudaError_t bind_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

bool shape_ok(long long rows, int n, int k) {
  return rows > 0 && rows < (1LL << 31) && n > 0 && k > 0 && n % 8 == 0 && k % 8 == 0;
}

}  // namespace

extern "C" {

// y (rows, n) = bf16(x W^T + b) on `stream`: x (rows, k) bf16 with row stride
// ldx, W (n, k) bf16 contiguous, b (n) f32 or null. n, k and ldx multiples of
// 8 and 16-byte aligned bases, else cudaErrorInvalidValue.
int pangu_outer_dense(const void* x, long long ldx, const void* w, const void* bias, void* out,
                      long long rows, int n, int k, void* stream) {
  if (!shape_ok(rows, n, k)) return (int)cudaErrorInvalidValue;
  cudaError_t err = bind_device();
  if (err != cudaSuccess) return (int)err;
  int parts = 1;
  return (int)wg_gemm_launch<true, false, true>(
      outer_dense_kernel<false, true>, static_cast<const bf16*>(x), ldx,
      static_cast<const bf16*>(w), (long long)k, (int)rows, n, (long long)k, 1,
      static_cast<const float*>(bias), static_cast<bf16*>(out), nullptr,
      reinterpret_cast<cudaStream_t>(stream), nullptr, &parts);
}

// f32 elements of scratch that pangu_outer_dense_bwd needs (0: a shape it
// does not take).
long long pangu_outer_dense_bwd_scratch(long long rows, int n, int k) {
  if (!shape_ok(rows, n, k)) return 0;
  return (long long)weight_grad_splits(n, k, rows) * n * k + (long long)DB_BLOCKS * n;
}

// The backward of pangu_outer_dense from dy (rows, n) bf16 contiguous on
// `stream`: dx (rows, k) bf16, dw (n, k) bf16, db (n) f32 (n at most 2048),
// each null where it is not wanted. scratch has pangu_outer_dense_bwd_scratch
// floats.
int pangu_outer_dense_bwd(const void* x, long long ldx, const void* w, const void* dy, void* dx,
                          void* dw, void* db, void* scratch, long long rows, int n, int k,
                          void* stream) {
  if (!shape_ok(rows, n, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* g = static_cast<const bf16*>(dy);
  float* part = static_cast<float*>(scratch);
  const float* no_bias = nullptr;
  int parts = 1;
  cudaError_t err = bind_device();
  if (err != cudaSuccess) return (int)err;
  if (dx &&  // dx = dy W: depth n, W read as stored (n, k)
      (err = wg_gemm_launch<true, true, true>(outer_dense_kernel<false, false>, g, (long long)n,
                                              wb, (long long)k, (int)rows, k, (long long)n, 1,
                                              no_bias, static_cast<bf16*>(dx), nullptr, st,
                                              nullptr, &parts)) != cudaSuccess)
    return (int)err;
  // dW = dy^T x over the token rows, row-split
  const int splits = weight_grad_splits(n, k, rows);
  if (dw &&
      ((err = wg_gemm_launch<false, true, true>(outer_dense_kernel<true, false>, g, (long long)n,
                                                xb, ldx, n, k, rows, splits, no_bias, nullptr,
                                                part, st, nullptr, &parts)) != cudaSuccess ||
       (err = reduce(part, parts, (long long)n * k, static_cast<bf16*>(dw), nullptr, st)) !=
           cudaSuccess))
    return (int)err;
  if (!db) return 0;
  if (n > 2 * DB_THREADS) return (int)cudaErrorInvalidValue;
  float* col = part + (long long)splits * n * k;
  const long long rpb = (rows + DB_BLOCKS - 1) / DB_BLOCKS;
  outer_dense_bias_grad_kernel<<<DB_BLOCKS, DB_THREADS, 0, st>>>(g, rows, n, rpb, col);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce(col, DB_BLOCKS, n, nullptr, static_cast<float*>(db), st);
}

}  // extern "C"
