// Tensor-core micro-benchmark of head-dim-32 score products -- CUDA for Hopper
// (sm_90a), on warpgroup matrix multiplies (wgmma).
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
//   loop_int8   loop on int8 q, k, each head's product exact in int32
//
// Design. The TPU question was whether a 32-deep contraction costs a full
// 128-deep pass of the matrix unit; on Hopper it is whether wgmma, the only
// instruction that reaches the tensor cores' full rate, runs near it at depth
// 32. A CTA (window, split) of three consumer warpgroups loads the window's q
// and k lanes once by TMA, as 12 head slabs of (rows x 32): bf16 rows of 64
// bytes with the 64-byte swizzle, int8 rows of 32 bytes with the 32-byte one.
// Each head's two slabs land on their own mbarrier (loop's first repeat starts
// on head 0 while the others arrive); then the CTA repeats the window `reps`
// times with nothing but products. Both operands are K-major and read through
// matrix descriptors: no thread loads a B fragment.
//
//   loop        warpgroup g owns rows 64g..64g+63 of the tile, one m64n144 f32
//               accumulator (72 registers); per repeat and head two
//               m64n144k16, one commit per repeat (one group kept in flight)
//   blockdiag   the same rows; per repeat 2 packs x 4 column blocks x 8 k16
//               steps, B either head (base + i)'s k slab or a zeroed slab
//   qblockdiag  Q' has 576 = 9 x 64 rows: warpgroup g takes m-tiles g, g+3,
//               g+6 in turn, A from registers (wgmma's register-A form): a
//               warp's 16 rows lie in one head's block, so its fragment of a
//               k16 step is that head's q or zero; the m-tiles straddle the
//               blocks (144 = 2.25 x 64), so each one's (64, 144) sum is added
//               into an f32 tile in shared memory, warpgroup by warpgroup in a
//               fixed order; each repeat's 16 products are waited for before
//               the next (kept in flight, ptxas serializes them for want of
//               registers)
//   loop_int8   one m64n144k32 s8 per head, the window's six heads chained in
//               one s32 accumulator (a 192-deep product), then converted and
//               added into the f32 tile once per window-repeat. The Pallas body
//               converts each head's dot, the TPU matrix unit's own result;
//               here the conversion follows the accumulator chain, 6x fewer
//               conversions. Exact: |six heads' sum| <= 6 x 128^2 x 32 =
//               3,145,728 < 2^22, so the sum converts by integer add and one
//               f32 subtract (no I2F), and at one sweep every f32 partial is an
//               exact integer: the plain version's result.
//
// M layout. 144 rows are 2.25 m64 tiles; the q slabs have 192 rows, 144-191
// zero, and the third warpgroup's rows 144-191 are thrown away. A two
// warpgroups + one mma.sync warp layout would leave the sub-partition that
// holds the extra warp as loaded as the padded one (48 rows of each k16 step on
// its tensor core against 32 on the others), so padding costs no more tensor
// time and is one code path.
//
// What bounds it on an H100: the issued products, bf16 at 989 TFLOP/s and int8
// at 1,979 TOP/s dense (the window's data, 166 KB in bf16, is read once per
// CTA). Ceilings against the bound, which counts only the products the result
// needs: loop and loop_int8 issue 4/3 of them (the padded rows), at most 75%;
// the packs also issue their zero blocks as real products (4x the needed depth;
// blockdiag with the padded rows too), at most ~19% (blockdiag) and 25%
// (qblockdiag).
//
// Grid: windows x split CTAs, one per SM (three warpgroups, up to 207 KB of
// shared memory); each writes its (144, 144) f32 partial and reduce_partials
// sums them in a fixed order (no atomics: the same bits on every run).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/scripts/bench_mxu_micro.py; the plain PyTorch version is
// mxu_micro_reference there.

#include "hopper.cuh"

namespace {

constexpr int MC = 192;                 // channels: 6 heads x 32
constexpr int MH = MC / D;              // heads
constexpr int MWG = 3;                  // consumer warpgroups
constexpr int M_THREADS = MWG * 128;    // 384
constexpr int MPAD = 64 * MWG;          // q rows of a slab: 144 + 48 zero
constexpr int NACC = T / 2;             // f32 of a thread's m64n144 accumulator

template <int V>
struct MicroLayout {
  static constexpr bool INT8 = V == 3;
  static constexpr int ROW = INT8 ? D : 2 * D;  // bytes of a head's 32 lanes
  static constexpr uint32_t SW = INT8 ? SW32 : SW64;
  static constexpr int SBO = 8 * ROW;            // 8 rows of the swizzled slab
  static constexpr int QSLAB = MPAD * ROW;       // 12,288 / 6,144 bytes
  static constexpr int KSLAB = T * ROW;          // 9,216 / 4,608
  static constexpr int Q = 0;
  static constexpr int K = Q + MH * QSLAB;
  static constexpr int ZERO = K + MH * KSLAB;                   // blockdiag's zero B
  static constexpr int OUT = ZERO + (V == 1 ? KSLAB : 0);       // qblockdiag's f32 tile
  static constexpr int BAR = OUT + (V == 2 ? T * T * 4 : 0);
  static constexpr int SMEM = BAR + MH * 8;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x as f32, exact for |x| < 2^22: 1.5 x 2^23 + x has an ulp of 1
__device__ __forceinline__ float exact_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

template <int V>
__device__ __forceinline__ uint64_t slab_desc(const unsigned char* p) {
  using L = MicroLayout<V>;
  return gmma_desc(p, 16, L::SBO, L::SW);
}

// qblockdiag: one m-tile's products over all repeats. a[p][c] is the warp's
// A fragment of pack p's k16 step 2 I0 + c (its head's q or zero); the steps
// outside 2 I0 .. 2 I0 + 3 are zero for every warp of the tile.
template <int I0>
__device__ __forceinline__ void qblockdiag_tile(float (&acc)[NACC], const uint32_t (&a)[2][4][4],
                                                const unsigned char* k, int reps) {
  using L = MicroLayout<2>;
  const uint32_t z[4] = {0u, 0u, 0u, 0u};
  for (int rep = 0; rep < reps; ++rep) {
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint64_t db = slab_desc<2>(k + (2 * p + ks / 2) * L::KSLAB + (ks % 2) * 32);
        if (ks >= 2 * I0 && ks < 2 * I0 + 4)
          wgmma_m64n144_rs(acc, a[p][(ks - 2 * I0) & 3], db);
        else
          wgmma_m64n144_rs(acc, z, db);
      }
    wgmma_commit();
    reg_fence(acc);
    wgmma_wait<0>();  // with a group kept in flight, ptxas serializes the products (registers)
  }
}

// V: 0 loop, 1 blockdiag, 2 qblockdiag, 3 loop_int8. CTA b works on window
// b / split, reps times over.
template <int V>
__global__ void __launch_bounds__(M_THREADS, 1)
mxu_micro_kernel(const __grid_constant__ CUtensorMap map, int split, int reps,
                 float* __restrict__ part) {
  using L = MicroLayout<V>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int win = blockIdx.x / split;
  const unsigned char* ks = smem + L::K;

  // ---- the window's 12 head slabs, once; the zero regions
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled slabs need 1024-byte alignment
    for (int h = 0; h < MH; ++h) mbar_init(&bar[h], 1);
    mbar_fence_init();
    for (int h = 0; h < MH; ++h) {
      mbar_expect_tx(&bar[h], 2 * L::KSLAB);
      tma_load(smem + L::Q + h * L::QSLAB, &map, &bar[h], h * D, win * T);
      tma_load(smem + L::K + h * L::KSLAB, &map, &bar[h], MC + h * D, win * T);
    }
  }
  auto zero = [&](unsigned char* p, int bytes) {
    for (int i = threadIdx.x; i < bytes / 16; i += M_THREADS)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
  };
  for (int h = 0; h < MH; ++h) zero(smem + L::Q + h * L::QSLAB + T * L::ROW, (MPAD - T) * L::ROW);
  if (V == 1) zero(smem + L::ZERO, L::KSLAB);
  if (V == 2) zero(smem + L::OUT, T * T * 4);
  fence_async_smem();
  __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int rw = 16 * (warp & 3) + (lane >> 2);  // the thread's first row of an m-tile (+ 8)
  const int cq = 2 * (lane & 3);                  // its first column (+ 8 n, + 1)
  const unsigned char* qa = smem + L::Q + wg * 64 * L::ROW;  // A: this warpgroup's rows

  if constexpr (V == 0) {
    auto head = [&](int h) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_m64n144<0, 0>(acc, slab_desc<V>(qa + h * L::QSLAB + kk * 32),
                            slab_desc<V>(ks + h * L::KSLAB + kk * 32));
    };
    wgmma_fence();
    for (int h = 0; h < MH; ++h) {  // the first repeat: head h as soon as its slabs land
      mbar_wait(&bar[h], 0);
      head(h);
    }
    wgmma_commit();
    for (int rep = 1; rep < reps; ++rep) {
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < MH; ++h) head(h);
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();
    }
  } else if constexpr (V == 1) {
    for (int h = 0; h < MH; ++h) mbar_wait(&bar[h], 0);
    const uint64_t dz = slab_desc<V>(smem + L::ZERO);
    for (int rep = 0; rep < reps; ++rep) {
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 2; ++p)      // pack: heads 2p .. 2p + 3
#pragma unroll
        for (int i = 0; i < 4; ++i)    // K' column block i: head 2p + i in depth 32i..
#pragma unroll
          for (int s = 0; s < 8; ++s)  // k16 step s of Q' = head 2p + s / 2
            wgmma_m64n144<0, 0>(
                acc, slab_desc<V>(qa + (2 * p + s / 2) * L::QSLAB + (s % 2) * 32),
                s / 2 == i ? slab_desc<V>(ks + (2 * p + i) * L::KSLAB + (s % 2) * 32) : dz);
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();
    }
  } else if constexpr (V == 2) {
    for (int h = 0; h < MH; ++h) mbar_wait(&bar[h], 0);
    float* o = reinterpret_cast<float*>(smem + L::OUT);
    for (int round = 0; round < 3; ++round) {
      const int j = 3 * round + wg;              // m-tile: Q' rows 64 j ..
      const int r = 64 * j + 16 * (warp & 3);    // the warp's first Q' row
      const int blk = r / T, r0 = r - blk * T;   // its head block, its first tile row
      const int i0 = 64 * j / T;                 // the m-tile's first block
      uint32_t a[2][4][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const unsigned char* s = smem + L::Q + (2 * p + blk) * L::QSLAB;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // the SW64 slab: 16-byte chunk ch of row y at y * 64 + (ch ^ (y / 2 % 4)) * 16
          const bool mine = (c >> 1) == blk - i0;
          const int ya = r0 + (lane >> 2), yb = ya + 8, ch = 2 * (c & 1), t4 = 4 * (lane & 3);
          a[p][c][0] = mine ? ld32(s + ya * 64 + ((ch ^ ((ya >> 1) & 3)) << 4) + t4) : 0u;
          a[p][c][1] = mine ? ld32(s + yb * 64 + ((ch ^ ((yb >> 1) & 3)) << 4) + t4) : 0u;
          a[p][c][2] = mine ? ld32(s + ya * 64 + (((ch + 1) ^ ((ya >> 1) & 3)) << 4) + t4) : 0u;
          a[p][c][3] = mine ? ld32(s + yb * 64 + (((ch + 1) ^ ((yb >> 1) & 3)) << 4) + t4) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      switch (i0) {  // uniform in the warpgroup
        case 0: qblockdiag_tile<0>(acc, a, ks, reps); break;
        case 1: qblockdiag_tile<1>(acc, a, ks, reps); break;
        case 2: qblockdiag_tile<2>(acc, a, ks, reps); break;
        default: qblockdiag_tile<3>(acc, a, ks, reps); break;
      }
      wgmma_wait<0>();
      reg_fence(acc);
      for (int g = 0; g < MWG; ++g) {  // the fixed order: warpgroup 0, 1, 2
        __syncthreads();
        if (wg != g) continue;
#pragma unroll
        for (int n = 0; n < T / 8; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2* d = reinterpret_cast<float2*>(o + (r0 + (lane >> 2) + 8 * hh) * T + 8 * n + cq);
            const float2 v = *d;
            *d = make_float2(v.x + acc[4 * n + 2 * hh], v.y + acc[4 * n + 2 * hh + 1]);
          }
      }
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(part + (long long)blockIdx.x * T * T);
    for (int i = threadIdx.x; i < T * T / 4; i += M_THREADS)
      out[i] = reinterpret_cast<const float4*>(o)[i];
    return;
  } else {
    int iacc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) iacc[i] = 0;
    const bool live = 64 * wg + 16 * (warp & 3) < T;  // the warp holds rows of the tile
    // all slabs first: waited for inside the loop, ptxas fences around each wait (16% slower)
    for (int h = 0; h < MH; ++h) mbar_wait(&bar[h], 0);
    for (int rep = 0; rep < reps; ++rep) {
      reg_fence(iacc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < MH; ++h)
        wgmma_m64n144_s8(iacc, slab_desc<V>(qa + h * L::QSLAB), slab_desc<V>(ks + h * L::KSLAB),
                         h > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(iacc);
      if (live) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] += exact_f32(iacc[i]);
      }
    }
  }

  // ---- loop, blockdiag, loop_int8: this warpgroup's rows of the (144, 144) partial
  wgmma_wait<0>();
  reg_fence(acc);
  float* out = part + (long long)blockIdx.x * T * T;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 64 * wg + rw + 8 * hh;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
      *reinterpret_cast<float2*>(out + row * T + 8 * n + cq) =
          make_float2(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
  }
}

template <int V>
cudaError_t launch_micro(const void* qkv, int windows, int split, int reps, float* part,
                         float* out, cudaStream_t s) {
  using L = MicroLayout<V>;
  CUtensorMap map;
  // qkv as (windows x 144 rows, 576), read in (32 lanes, 144 rows) boxes: one head slab each
  const bool ok = L::INT8 ? tensor_map_i8(&map, qkv, 3 * MC, (long long)windows * T, 3 * MC, D,
                                          T, CU_TENSOR_MAP_SWIZZLE_32B)
                          : tensor_map(&map, static_cast<const bf16*>(qkv), 3 * MC,
                                       (long long)windows * T, 3 * MC, D, T,
                                       CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mxu_micro_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  mxu_micro_kernel<V><<<(unsigned)(windows * split), M_THREADS, L::SMEM, s>>>(map, split, reps,
                                                                               part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, windows * split, (long long)T * T, nullptr, out, s);
}

}  // namespace

extern "C" {

// Variant `variant` (0 loop, 1 blockdiag, 2 qblockdiag, 3 loop_int8) on `stream`:
// out (144, 144) f32 = split x reps sweeps over the `windows` windows of qkv
// (windows, 144, 576), bf16 (int8 for loop_int8), 16-byte aligned. part holds
// windows x split x 144 x 144 floats. A nonzero return is a cudaError_t: the
// tensor map refused (cudaErrorInvalidValue) or the launch failed.
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
