// Per-tile DCO arithmetic of the fused IVF scan, for the device.
//
// The CUDA counterpart of repro_torch/kernels/tiles.py (plain PyTorch),
// itself the port of repro/kernels/tiles.py.  Every float operation below is
// written with an explicit round-to-nearest intrinsic, in the order the
// plain version evaluates it, so that no contraction into an FMA can change
// a result (the build also passes -fmad=false) and the kernel agrees with
// the plain version bit for bit.  sqrtf stays IEEE: no --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dade {

// --- cp.async: 16-byte global -> shared copies tracked per thread ----------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The same copy, zero-filling the 16 bytes instead where `ok` is false (a
// masked row of a ragged tile; nothing is read from `gmem` then).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- tiles.py helpers --------------------------------------------------------

// max(qn + cn - 2 dot, 0): one dim-block's clamped squared distance.
__device__ __forceinline__ float block_sq(float qn, float cn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, cn), __fmul_rn(2.0f, dot)), 0.0f);
}

// max(0, sqrt(psum) - eband)^2 * (1 - slack) * scale: the sound lower bound.
__device__ __forceinline__ float lb_penalized(float psum, float eband,
                                              float scale, float one_minus_slack) {
  const float root = fmaxf(__fsub_rn(sqrtf(psum), eband), 0.0f);
  return __fmul_rn(__fmul_rn(__fmul_rn(root, root), one_minus_slack), scale);
}

// (1 + eps)^2 * r^2, with (1 + eps)^2 precomputed per checkpoint.
__device__ __forceinline__ float dade_threshold(float one_plus_eps_sq, float rsq) {
  return __fmul_rn(one_plus_eps_sq, rsq);
}

}  // namespace dade
