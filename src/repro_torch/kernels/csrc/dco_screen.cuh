// The flat DCO screen for Hopper (sm_90a): one skeleton, two kernels.
//
// dade_dco.cu and quant_dco.cu instantiate screen_kernel<MODE>:
//   kFp32Screen  Algorithm 1 over f32 rows: at a non-final checkpoint a pair
//                retires rejected where psum·scale_s > (1+ε_s)²r²; the rest
//                retire exact at the last block, passed = est <= r²
//                (replaces repro/kernels/dade_dco.py);
//   kInt8Screen  the int8 lower-bound prefilter over per-dimension codes:
//                codes dequantize as code·scale[d], and a pair retires
//                pruned where lb_penalized(psum, E(d_s), scale_s) exceeds the
//                threshold, at every checkpoint, the last included (replaces
//                repro/kernels/quant_dco.py).
//
// Design.  The TPU kernels walk a (q_tile, c_tile, S) grid whose S axis runs
// in order and carries psum/active/retirement state in VMEM.  Here one CTA
// of 256 threads owns one (16-query, 128-candidate) tile and loops over the
// S dimension blocks itself: the candidate-tile index is blockIdx.x (whose
// limit is 2^31 - 1; gridDim.y stops at 65,535), the query tile blockIdx.y.  Per
// block the query slice (cp.async) and the candidate slice (cp.async for
// f32 rows; int8 codes read 16 at a time and dequantized with a rounded
// multiply) land in shared memory; the query norms of every block are
// summed once, in the prologue.  Each thread owns one candidate and 8 of
// the queries, keeps their psum, retirement estimate, dims and flags in
// registers, and sums the candidate norm and its 8 dot products one
// dimension at a time, in order, with __fmul_rn/__fadd_rn — the order of
// tiles.mxu_block_sq, so kernel and plain version agree bit for bit (the
// build passes -fmad=false as well).  After each checkpoint a block vote
// (__syncthreads_or) ends the loop once no pair of the tile is active: the
// tile-granular early exit of the TPU kernel, which here skips the loads as
// well as the products.  Values depend only on the block width BD (which
// fixes the checkpoints): the CTA tile and the early exit change time only.
//
// What bounds it on this card (an H100 SXM).  At the flat screen's shape
// (Q = 1024, N = 2^20, D = 256) each screen writes three (Q, N) 32-bit
// arrays, 12.9 GB, 3.8 ms at 3.35 TB/s, and the dims the data consumes cost
// one multiply-add each in fp32 outside the tensor cores (exactness rules
// out TF32), so the screens are bound by their output bytes.  The design
// issues a separate rounded multiply and add per product (no FMA, so half
// the fp32 peak at best) and re-reads each query block from shared memory
// per candidate chunk; wgmma cannot keep the exact order.  Indexing into
// the (Q, N) outputs is 64-bit: Q·N reaches 2^30 elements.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace dade {

enum ScreenMode { kFp32Screen = 0, kInt8Screen = 1 };

constexpr int kScreenThreads = 256;
constexpr int kScreenBQ = 16;                               // queries per CTA
constexpr int kScreenBC = 128;                              // candidates per CTA
constexpr int kScreenGroups = kScreenThreads / kScreenBC;   // query interleave
constexpr int kScreenQPT = kScreenBQ / kScreenGroups;       // queries per thread

struct ScreenArgs {
  const float* q;        // (Q, D) f32
  const void* c;         // (N, D) f32 rows, or int8 codes (kInt8Screen)
  const float* cscales;  // (D,) per-dimension code scales (kInt8Screen)
  const float* eps;      // (S,) blocked table
  const float* scale;    // (S,)
  const float* ecum;     // (S,) E(d_s), the cumulative error band (kInt8Screen)
  const float* rsq;      // (Q,) squared thresholds
  float* est;            // (Q, N) estimate at retirement / lower bound
  int* flag;             // (Q, N) passed (kFp32Screen) or pruned (kInt8Screen)
  int* dims;             // (Q, N) dims consumed at retirement
  int Q, N, D, S, BD;
  float one_minus_slack;
};

__host__ __device__ inline size_t screen_align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of the shared-memory regions (same function on both sides).
struct ScreenLayout {
  size_t q, c, qn, thr, scl, ecum, rsq, total;
};

__host__ __device__ inline ScreenLayout screen_layout(int S, int BD) {
  ScreenLayout L;
  size_t o = 0;
  L.q = o;    o = screen_align16(o + 4ull * kScreenBQ * BD);
  L.c = o;    o = screen_align16(o + 4ull * kScreenBC * (BD + 4));
  L.qn = o;   o = screen_align16(o + 4ull * kScreenBQ * S);
  L.thr = o;  o = screen_align16(o + 4ull * S);
  L.scl = o;  o = screen_align16(o + 4ull * S);
  L.ecum = o; o = screen_align16(o + 4ull * S);
  L.rsq = o;  o = screen_align16(o + 4ull * kScreenBQ);
  L.total = o;
  return L;
}

template <int MODE>
__device__ __forceinline__ void dco_screen(const ScreenArgs& a) {
  constexpr int T = kScreenThreads, G = kScreenGroups, QPT = kScreenQPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, S = a.S, BD = a.BD;
  const ScreenLayout L = screen_layout(S, BD);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* c_s = reinterpret_cast<float*>(smem + L.c);
  float* qn_s = reinterpret_cast<float*>(smem + L.qn);  // (S, BQ)
  float* thr_s = reinterpret_cast<float*>(smem + L.thr);
  float* scl_s = reinterpret_cast<float*>(smem + L.scl);
  float* ecum_s = reinterpret_cast<float*>(smem + L.ecum);
  float* rsq_s = reinterpret_cast<float*>(smem + L.rsq);

  const int tid = threadIdx.x;
  const int cl = tid % kScreenBC;  // this thread's candidate in the tile
  const int g = tid / kScreenBC;   // its queries: g + j·G, j < QPT
  const long long c0 = static_cast<long long>(blockIdx.x) * kScreenBC;
  const int q0 = blockIdx.y * kScreenBQ;
  const long long cand = c0 + cl;
  const int CS = BD + 4;  // candidate row stride (floats): conflict-free float4 reads

  // ---- prologue: per-checkpoint constants and the tile's thresholds ----
  for (int s = tid; s < S; s += T) {
    const float t = __fadd_rn(1.0f, a.eps[s]);
    thr_s[s] = __fmul_rn(t, t);
    scl_s[s] = a.scale[s];
    if (MODE == kInt8Screen) ecum_s[s] = a.ecum[s];
  }
  if (tid < kScreenBQ) rsq_s[tid] = q0 + tid < a.Q ? a.rsq[q0 + tid] : 0.0f;
  // The query norms of every block, each summed in dimension order.
  for (int e = tid; e < kScreenBQ * S; e += T) {
    const int s = e / kScreenBQ, r = e - s * kScreenBQ;
    float qn = 0.0f;
    if (q0 + r < a.Q) {
      const float* qv = a.q + static_cast<size_t>(q0 + r) * D + s * BD;
      for (int d = 0; d < BD; ++d) qn = __fadd_rn(qn, __fmul_rn(qv[d], qv[d]));
    }
    qn_s[e] = qn;
  }

  float psum[QPT], oest[QPT];
  int odims[QPT];
  unsigned active = 0, rejected = 0;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    psum[j] = 0.0f;
    oest[j] = 0.0f;
    odims[j] = 0;
    if (cand < a.N && q0 + g + j * G < a.Q) active |= 1u << j;
  }

  for (int s = 0; s < S; ++s) {
    // ---- stage block s: the query slice and the candidate slice ----
    const int qch = BD / 4;
    for (int e = tid; e < kScreenBQ * qch; e += T) {
      const int r = e / qch, ch = e - r * qch;
      float* dst = q_s + r * BD + ch * 4;
      if (q0 + r < a.Q)
        cp_async16(dst, a.q + static_cast<size_t>(q0 + r) * D + s * BD + ch * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if constexpr (MODE == kInt8Screen) {
      const int8_t* codes = static_cast<const int8_t*>(a.c);
      const int cch = BD / 16;
      for (int e = tid; e < kScreenBC * cch; e += T) {
        const int r = e / cch, ch = e - r * cch;
        float* dst = c_s + r * CS + ch * 16;
        if (c0 + r < a.N) {
          const int4 raw = *reinterpret_cast<const int4*>(
              codes + static_cast<size_t>(c0 + r) * D + s * BD + ch * 16);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          const float* sc = a.cscales + s * BD + ch * 16;
#pragma unroll
          for (int k = 0; k < 16; ++k) dst[k] = __fmul_rn(static_cast<float>(b[k]), __ldg(sc + k));
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) dst[k] = 0.0f;
        }
      }
    } else {
      const float* rows = static_cast<const float*>(a.c);
      for (int e = tid; e < kScreenBC * qch; e += T) {
        const int r = e / qch, ch = e - r * qch;
        float* dst = c_s + r * CS + ch * 4;
        if (c0 + r < a.N)
          cp_async16(dst, rows + static_cast<size_t>(c0 + r) * D + s * BD + ch * 4);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- the block's squared distances, summed dimension by dimension ----
    float cn = 0.0f, dot[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) dot[j] = 0.0f;
    const float* xr = c_s + cl * CS;
    for (int w = 0; w < BD; w += 4) {
      const float4 x = *reinterpret_cast<const float4*>(xr + w);
      cn = __fadd_rn(cn, __fmul_rn(x.x, x.x));
      cn = __fadd_rn(cn, __fmul_rn(x.y, x.y));
      cn = __fadd_rn(cn, __fmul_rn(x.z, x.z));
      cn = __fadd_rn(cn, __fmul_rn(x.w, x.w));
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(q_s + (g + j * G) * BD + w);
        dot[j] = __fadd_rn(dot[j], __fmul_rn(v.x, x.x));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(v.y, x.y));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(v.z, x.z));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(v.w, x.w));
      }
    }
    __syncthreads();  // every read of this block's slices is done

    // ---- checkpoint s: accumulate, test, retire ----
    const bool last = s == S - 1;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int ql = g + j * G;
      psum[j] = __fadd_rn(psum[j], block_sq(qn_s[s * kScreenBQ + ql], cn, dot[j]));
      if ((active >> j) & 1u) {
        float e;
        if constexpr (MODE == kInt8Screen)
          e = lb_penalized(psum[j], ecum_s[s], scl_s[s], a.one_minus_slack);
        else
          e = __fmul_rn(psum[j], scl_s[s]);
        // The fp32 screen's last checkpoint is the exact terminal retire;
        // the lower bound may reject at every checkpoint, the last included.
        const bool rej = (MODE == kInt8Screen || !last) &&
                         e > dade_threshold(thr_s[s], rsq_s[ql]);
        if (rej || last) {
          oest[j] = e;
          odims[j] = (s + 1) * BD;
          active &= ~(1u << j);
          if (rej) rejected |= 1u << j;
        }
      }
    }
    if (!__syncthreads_or(active != 0u)) break;
  }

  // ---- outputs: one row of the tile per j, coalesced across candidates ----
  if (cand >= a.N) return;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + g + j * G;
    if (qi >= a.Q) continue;
    const size_t o = static_cast<size_t>(qi) * static_cast<size_t>(a.N) + cand;
    a.est[o] = oest[j];
    a.dims[o] = odims[j];
    const bool rej = (rejected >> j) & 1u;
    if constexpr (MODE == kInt8Screen)
      a.flag[o] = rej;
    else
      a.flag[o] = !rej && oest[j] <= rsq_s[g + j * G];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kScreenThreads) screen_kernel(const ScreenArgs a) {
  dco_screen<MODE>(a);
}

// Launch screen_kernel<MODE> on `stream`; returns the cudaError_t.
template <int MODE>
inline int launch_screen(int device, const ScreenArgs& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.Q <= 0 || a.N <= 0) return 0;
  const size_t smem = screen_layout(a.S, a.BD).total;
  err = cudaFuncSetAttribute(screen_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.N + kScreenBC - 1) / kScreenBC),
                  static_cast<unsigned>((a.Q + kScreenBQ - 1) / kScreenBQ));
  screen_kernel<MODE><<<grid, kScreenThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dade

// One C entry point per kernel, the same signature for both: pointers a mode
// does not read may be null.
#define DADE_SCREEN_ENTRY(NAME, MODE)                                              \
  extern "C" long long NAME##_smem_bytes(int S, int BD) {                           \
    return static_cast<long long>(dade::screen_layout(S, BD).total);                \
  }                                                                                  \
  extern "C" int NAME##_launch(int device, const float* q, const void* c,          \
                               const float* cscales, const float* eps,             \
                               const float* scale, const float* ecum,              \
                               const float* rsq, float* est, int* flag, int* dims, \
                               int Q, int N, int D, int BD, float one_minus_slack, \
                               void* stream) {                                     \
    const dade::ScreenArgs a{q, c, cscales, eps, scale, ecum, rsq, est, flag,       \
                             dims, Q, N, D, D / BD, BD, one_minus_slack};           \
    return dade::launch_screen<MODE>(device, a, stream);                            \
  }
