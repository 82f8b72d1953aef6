// Tensor-core micro-benchmark of head-dim-32 score products -- CUDA for Hopper
// (sm_90a).
//
// Replaces scripts/bench_mxu_micro.py (S3, the Pallas bodies _loop_kernel,
// _blockdiag_kernel, _qblockdiag_kernel and _loop_int8_kernel run by timeit).
// From qkv (windows, 144, 3C), C = 192 = 6 heads x 32, each variant sums score
// products q k^T of its heads into one (144, 144) f32 tile, over the windows,
// `sweeps` times over:
//
//   loop        sum_r sum_h q_rh k_rh^T, heads 0-5: per head, depth 32
//   blockdiag   two 4-head packs (heads 0-3, then 2-5, as the Pallas body reuses
//               heads 2-5): Q' = the packed q lanes (144, 128) against the
//               block-diagonal K' (128, 4 x 144), the four (144, 144) blocks summed
//   qblockdiag  the same packs with the block-diagonal operand on the q side:
//               Q' (4 x 144, 128) against the packed k lanes (144, 128)
//   loop_int8   loop on int8 q, k: each window-head product exact in int32,
//               converted to f32, then summed (the Pallas body's formula)
//
// Design. The TPU question was whether a 32-deep contraction costs a full
// 128-deep pass of the matrix unit. Hopper's mma.sync takes a depth of 16 (bf16,
// m16n8k16) or 32 (int8, m16n8k32), so a head-dim-32 product is two bf16
// k-steps or one int8 k-step with nothing padded, and the packed variants issue
// their zero blocks as real products: 5.33x loop's issued FLOP. A CTA of 9
// warps stages one window's q|k columns (144 x 384) in shared memory once,
// then repeats the window `reps` times; warp w owns rows 16w..16w+15 of the
// tile, 18 n8 accumulators (72 f32 registers). The zero operand blocks are
// read from a zeroed shared tile (the Pallas body concatenates zero arrays).
// Grid: windows x split CTAs; each writes its (144, 144) f32 partial and
// reduce_partials sums them in a fixed order (no atomics: the same bits on
// every run).
//
// What bounds it on an H100: the issued products (bf16 at 989 TFLOP/s, int8 at
// 1,979 TOP/s dense); the window data (166 KB bf16) is read once per CTA.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_mxu_micro.py; the plain PyTorch version is
// mxu_micro_reference there.

#include "common.cuh"

namespace {

constexpr int MC = 192;                    // channels: 6 heads x 32
constexpr int MH = MC / D;                 // heads
constexpr int QK = 2 * MC;                 // the q|k columns of a qkv row
constexpr int LD16 = (QK + 8) * 2;         // bf16 row stride in bytes: 196 words, 4 mod 32
constexpr int LD8 = QK + 16;               // int8 row stride in bytes: 100 words, 4 mod 32
constexpr int ZLD = 80;                    // zero tile: 8 rows of 80 bytes
constexpr int M_WARPS = T / 16;
constexpr int M_THREADS = M_WARPS * 32;    // 288
constexpr int NT8 = T / 8;                 // n8 column tiles of the (144, 144) output

template <int V>
struct MicroLayout {
  static constexpr bool INT8 = V == 3;
  static constexpr int ESZ = INT8 ? 1 : 2;   // bytes per element
  static constexpr int LD = INT8 ? LD8 : LD16;
  static constexpr int SMEM = T * LD + 8 * ZLD;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V: 0 loop, 1 blockdiag, 2 qblockdiag, 3 loop_int8. CTA b works on window b / split.
template <int V>
__global__ void __launch_bounds__(M_THREADS, 1)
mxu_micro_kernel(const unsigned char* __restrict__ qkv, int split, int reps,
                 float* __restrict__ part) {
  using L = MicroLayout<V>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* zero = smem + T * L::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long win = blockIdx.x / split;

  // ---- the window's q|k columns, once
  constexpr int VPR = QK * L::ESZ / 16;  // 16-byte vectors per row
  const unsigned char* src = qkv + win * T * 3 * MC * L::ESZ;
  for (int v = threadIdx.x; v < T * VPR; v += M_THREADS) {
    const int row = v / VPR, cv = v - row * VPR;
    cp_async16(smem + row * L::LD + cv * 16, src + (long long)row * 3 * MC * L::ESZ + cv * 16);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 8 * ZLD / 4; i += M_THREADS)
    reinterpret_cast<uint32_t*>(zero)[i] = 0u;
  cp_async_wait<0>();
  __syncthreads();

  // fragment loads: A rows m0.. (row-major), B key rows n0.. (k^T, col-major),
  // column offset k0 in elements; see the PTX ISA fragment layouts of
  // mma.m16n8k16 (bf16) and mma.m16n8k32 (s8)
  auto a_frag = [&](uint32_t (&a)[4], int m0, int k0) {
    const unsigned char* p = smem + (m0 + g) * L::LD + (k0 + (L::INT8 ? 4 : 2) * t) * L::ESZ;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * L::LD);
    a[2] = ld32(p + 16);
    a[3] = ld32(p + 8 * L::LD + 16);
  };
  auto a_zero = [&](uint32_t (&a)[4]) {
    const unsigned char* p = zero + g * ZLD + 4 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 16);
    a[2] = ld32(p + 32);
    a[3] = ld32(p + 48);
  };
  auto b_frag = [&](uint32_t (&b)[2], int n0, int k0) {
    const unsigned char* p = smem + (n0 + g) * L::LD + (k0 + (L::INT8 ? 4 : 2) * t) * L::ESZ;
    b[0] = ld32(p);
    b[1] = ld32(p + 16);
  };
  auto b_zero = [&](uint32_t (&b)[2]) {
    const unsigned char* p = zero + g * ZLD + 4 * t;
    b[0] = ld32(p);
    b[1] = ld32(p + 16);
  };

  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int m0 = warp * 16;

  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (V == 0) {
      for (int h = 0; h < MH; ++h) {
        uint32_t a0[4], a1[4];
        a_frag(a0, m0, h * D);
        a_frag(a1, m0, h * D + 16);
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          uint32_t b[2];
          b_frag(b, n * 8, MC + h * D);
          mma_bf16(acc[n], a0, b[0], b[1]);
          b_frag(b, n * 8, MC + h * D + 16);
          mma_bf16(acc[n], a1, b[0], b[1]);
        }
      }
    } else if constexpr (V == 1) {
      for (int base = 0; base <= 2; base += 2) {
        uint32_t a[8][4];  // Q' = q lanes of heads base..base+3, 8 k-steps of 16
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) a_frag(a[ks], m0, base * D + ks * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)  // K' column block i: head base + i in rows 32i..
#pragma unroll
          for (int n = 0; n < NT8; ++n)
#pragma unroll
            for (int ks = 0; ks < 8; ++ks) {
              uint32_t b[2];
              if (ks / 2 == i)
                b_frag(b, n * 8, MC + (base + i) * D + (ks % 2) * 16);
              else
                b_zero(b);
              mma_bf16(acc[n], a[ks], b[0], b[1]);
            }
      }
    } else if constexpr (V == 2) {
      for (int base = 0; base <= 2; base += 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // Q' row block i: head base + i in columns 32i..
          uint32_t a[8][4];
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            if (ks / 2 == i)
              a_frag(a[ks], m0, (base + i) * D + (ks % 2) * 16);
            else
              a_zero(a[ks]);
          }
#pragma unroll
          for (int n = 0; n < NT8; ++n)
#pragma unroll
            for (int ks = 0; ks < 8; ++ks) {
              uint32_t b[2];
              b_frag(b, n * 8, MC + base * D + ks * 16);
              mma_bf16(acc[n], a[ks], b[0], b[1]);
            }
        }
      }
    } else {
      for (int h = 0; h < MH; ++h) {
        uint32_t a[4];
        a_frag(a, m0, h * D);
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          uint32_t b[2];
          b_frag(b, n * 8, MC + h * D);
          int d[4] = {0, 0, 0, 0};
          mma_s8(d, a, b[0], b[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += (float)d[e];
        }
      }
    }
  }

  // ---- this CTA's (144, 144) f32 partial
  float* out = part + (long long)blockIdx.x * T * T;
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    const int row = m0 + g, col = n * 8 + 2 * t;
    out[row * T + col] = acc[n][0];
    out[row * T + col + 1] = acc[n][1];
    out[(row + 8) * T + col] = acc[n][2];
    out[(row + 8) * T + col + 1] = acc[n][3];
  }
}

template <int V>
cudaError_t launch_micro(const void* qkv, int windows, int split, int reps, float* part,
                         float* out, cudaStream_t s) {
  using L = MicroLayout<V>;
  cudaError_t err = cudaFuncSetAttribute(mxu_micro_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  mxu_micro_kernel<V><<<(unsigned)(windows * split), M_THREADS, L::SMEM, s>>>(
      static_cast<const unsigned char*>(qkv), split, reps, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, windows * split, (long long)T * T, nullptr, out, s);
}

}  // namespace

extern "C" {

// Variant `variant` (0 loop, 1 blockdiag, 2 qblockdiag, 3 loop_int8) on `stream`:
// out (144, 144) f32 = split x reps sweeps over the `windows` windows of qkv
// (windows, 144, 576), bf16 (int8 for loop_int8). part holds windows x split x
// 144 x 144 floats.
int pangu_mxu_micro(const void* qkv, int variant, int windows, int split, int reps, void* part,
                    void* out, void* stream) {
  if (windows < 1 || split < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  switch (variant) {
    case 0: return (int)launch_micro<0>(qkv, windows, split, reps, p, o, s);
    case 1: return (int)launch_micro<1>(qkv, windows, split, reps, p, o, s);
    case 2: return (int)launch_micro<2>(qkv, windows, split, reps, p, o, s);
    case 3: return (int)launch_micro<3>(qkv, windows, split, reps, p, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
