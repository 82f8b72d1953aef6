// Post-norm residual of the attention sublayer in training, bf16 -- CUDA for
// Hopper (sm_90a), forward and backward.
//
// Replaces pangu_tpu/ops/fused_epilogue.py::fused_residual_postnorm (K4, the
// Pallas kernel _make_fwd_kernel) and its backward _res_bwd (K5,
// _make_bwd_kernel). Per token row of (rows, C):
//
//   forward   out = bf16(shortcut + s * LN(a))          (f32 inside, one rounding)
//   backward  da, dgamma, dbeta, ds from g = dL/dout     (LN statistics recomputed)
//
// with LN(a) = (a - mu) rsqrt(E[a^2] - mu^2 + 1e-5) gamma + beta and s the
// per-row f32 branch scale (stochastic depth). dshortcut is g itself and
// never touches a kernel.
//
// Design: residual_postnorm.cuh (one warp per row, the row in registers,
// per-CTA partials of dgamma and dbeta summed in a fixed order); K12 runs the
// same backward kernel on its f32 gradient.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// pangu_tpu_torch/ops/fused_epilogue.py; the plain PyTorch versions are
// fused_residual_postnorm_reference and fused_residual_postnorm_bwd_reference.

#include "residual_postnorm.cuh"

extern "C" {

// K4 on `stream`: out = bf16(shortcut + s * LN(a)); s has one f32 per row.
// C 192 or 384, else cudaErrorInvalidValue.
int pangu_residual_postnorm_fwd(const void* shortcut, const void* a, const void* gamma,
                                const void* beta, const void* s, void* out, long long rows, int C,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* sh = static_cast<const bf16*>(shortcut);
  const bf16* ab = static_cast<const bf16*>(a);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(s);
  bf16* o = static_cast<bf16*>(out);
  switch (C) {
    case 192: return (int)launch_residual_fwd<3>(sh, ab, gm, bt, sc, o, rows, st);
    case 384: return (int)launch_residual_fwd<6>(sh, ab, gm, bt, sc, o, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of scratch that pangu_residual_postnorm_bwd needs.
long long pangu_residual_postnorm_bwd_scratch(int C) { return 2LL * EPI_BWD_BLOCKS * C; }

// K5 on `stream`: da (bf16, per element), ds (f32, per row), dgamma and dbeta
// (f32, C) from gy = dL/dout.
int pangu_residual_postnorm_bwd(const void* a, const void* gy, const void* gamma,
                                const void* beta, const void* s, void* da, void* ds,
                                void* scratch, void* dgamma, void* dbeta, long long rows, int C,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* gb = static_cast<const bf16*>(gy);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(s);
  bf16* d = static_cast<bf16*>(da);
  float* dsr = static_cast<float*>(ds);
  float* part = static_cast<float*>(scratch);
  float* dgm = static_cast<float*>(dgamma);
  float* dbt = static_cast<float*>(dbeta);
  switch (C) {
    case 192:
      return (int)launch_residual_bwd<3>(ab, gb, gm, bt, sc, 1, d, dsr, part, dgm, dbt,
                                            rows, st);
    case 384:
      return (int)launch_residual_bwd<6>(ab, gb, gm, bt, sc, 1, d, dsr, part, dgm, dbt,
                                            rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
