// The FDScanning control: exact squared L2 over the full D, no screening,
// for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/l2_scan.py
// (l2_scan_kernel_call, body _kernel): the sum over dimension blocks of
// max(qn + cn − 2 q·c, 0), each block term as tiles.block_sq and
// tiles.mxu_block_sq compute it, its norms and dot product summed one
// dimension at a time, in order, with rounded multiplies and adds.
//
// What bounds it on this card (an H100 SXM).  At 1024 x 2^20 x 256 the
// products are 2.75e11 multiply-adds; the exact order forbids FFMA, TF32,
// mma and wgmma, so each costs a rounded multiply and a rounded add, two
// fp32 instructions: 5.5e11 of them, ~16.5 ms at 128 lanes x 132 SMs x
// ~1.98 GHz, against 4.3 GB of output (1.3 ms at 3.35 TB/s).  Issue slots
// bound it.
//
// Design: a register-tiled outer product.  One CTA of 256 threads owns a
// 128-query x 128-candidate tile; thread (ty, tx) owns queries ty + 16i and
// candidates tx + 16j (i, j < 8), 64 pairs whose dot products live in
// registers.  Every accumulator walks d = 0..D-1 in sequence, so each sum
// keeps the plain version's order whatever the tiling.  The query and
// candidate slices stage through shared memory 16 dimensions at a time, in
// a ring of 4 chunks filled by cp.async (the loads of the next chunks
// overlap the products of this one), rows padded to 20 floats so 8
// consecutive rows' float4 reads hit distinct banks: per 4 dimensions a
// thread reads 8 query and 8 candidate float4s for 256 products, 16
// products per 16-byte shared load.  The block norms are summed once per
// CTA row (thread t owns staged row t: queries, then candidates) into a
// two-slot array by block parity, and folded into each pair's running sum
// after the barrier that follows the block's last chunk.  Ragged Q and N
// tiles are zero-filled on load and masked on store; pad rows at 1e18 keep
// the plain version's overflow to inf because the arithmetic is the same.
// The grid is one linear index, query tile fastest, so the CTAs that share
// a candidate tile run together and the corpus streams from memory once;
// output offsets are 64-bit (Q·N reaches 2^30).
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                // queries and candidates per CTA
constexpr int kMicro = 8;                 // per thread: 8 queries x 8 candidates
constexpr int kKC = 16;                   // dimensions per staged chunk
constexpr int kStages = 4;                // chunks in flight
constexpr int kRS = kKC + 4;              // staged row stride (floats)
constexpr int kRows = 2 * kTile;          // staged rows: queries, then candidates
constexpr int kChunk = kRows * kRS;       // floats per staged chunk
constexpr size_t kSmemBytes = (static_cast<size_t>(kStages) * kChunk + 2 * kRows) * sizeof(float);

struct Args {
  const float* q;  // (Q, D)
  const float* c;  // (N, D)
  float* out;      // (Q, N)
  int Q, N, D, BD, q_tiles;
};

// cp.async chunk [d0, d0 + 16) of the tile's 256 rows into `buf`: 4
// 16-byte pieces a row, 4 per thread, a warp covering 8 whole row pieces.
__device__ __forceinline__ void stage_chunk(const Args& a, float* buf, long long q0,
                                            long long c0, int d0) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e >> 2, piece = e & 3;
    const bool isq = r < kTile;
    const long long row = isq ? q0 + r : c0 + (r - kTile);
    const bool ok = row < (isq ? a.Q : a.N);
    const float* base = isq ? a.q : a.c;
    const float* src = ok ? base + row * a.D + d0 + piece * 4 : base;
    dade::cp_async16_zfill(buf + r * kRS + piece * 4, src, ok);
  }
  dade::cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1) l2_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* nrm = smem + kStages * kChunk;  // (2, kRows) block norms by block parity
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q0 = static_cast<long long>(blockIdx.x % a.q_tiles) * kTile;
  const long long c0 = static_cast<long long>(blockIdx.x / a.q_tiles) * kTile;
  const int chunks = a.D / kKC, per_block = a.BD / kKC;

  float psum[kMicro][kMicro], dot[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) psum[i][j] = dot[i][j] = 0.0f;
  float norm = 0.0f;  // staged row tid's norm over the current block

  // psum += block_sq(qn, cn, dot) with the norms of block parity p; dot = 0.
  auto fold = [&](int p) {
    const float* qn = nrm + p * kRows;
    const float* cn = qn + kTile;
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const float qi = qn[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        psum[i][j] = __fadd_rn(psum[i][j], dade::block_sq(qi, cn[tx + 16 * j], dot[i][j]));
        dot[i][j] = 0.0f;
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage_chunk(a, smem + s * kChunk, q0, c0, s * kKC);
    else dade::cp_async_commit();
  }

  for (int ch = 0; ch < chunks; ++ch) {
    dade::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch has landed; every thread is past chunk ch-1
    if (ch > 0 && ch % per_block == 0) fold((ch / per_block - 1) & 1);
    const int nx = ch + kStages - 1;  // refill the slot chunk ch-1 used
    if (nx < chunks) stage_chunk(a, smem + (nx % kStages) * kChunk, q0, c0, nx * kKC);
    else dade::cp_async_commit();

    const float* qb = smem + (ch % kStages) * kChunk;
    const float* cb = qb + kTile * kRS;
    const float* own = qb + tid * kRS;
#pragma unroll
    for (int w = 0; w < kKC; w += 4) {
      const float4 v = *reinterpret_cast<const float4*>(own + w);
      norm = __fadd_rn(norm, __fmul_rn(v.x, v.x));
      norm = __fadd_rn(norm, __fmul_rn(v.y, v.y));
      norm = __fadd_rn(norm, __fmul_rn(v.z, v.z));
      norm = __fadd_rn(norm, __fmul_rn(v.w, v.w));
    }
#pragma unroll
    for (int w = 0; w < kKC; w += 4) {
      float4 qv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qb + (ty + 16 * i) * kRS + w);
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * kRS + w);
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          float d = dot[i][j];
          d = __fadd_rn(d, __fmul_rn(qv[i].x, cv.x));
          d = __fadd_rn(d, __fmul_rn(qv[i].y, cv.y));
          d = __fadd_rn(d, __fmul_rn(qv[i].z, cv.z));
          d = __fadd_rn(d, __fmul_rn(qv[i].w, cv.w));
          dot[i][j] = d;
        }
      }
    }
    if ((ch + 1) % per_block == 0) {
      nrm[((ch / per_block) & 1) * kRows + tid] = norm;
      norm = 0.0f;
    }
  }
  __syncthreads();
  fold((chunks / per_block - 1) & 1);

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= a.Q) continue;
    float* orow = a.out + qi * a.N;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long col = c0 + tx + 16 * j;
      if (col < a.N) __stcs(orow + col, psum[i][j]);  // streamed: read by no later CTA
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA (bytes); it does not depend on the shapes.
long long l2_scan_smem_bytes() { return static_cast<long long>(kSmemBytes); }

// Launch on `stream`: q (Q, D) and c (N, D) f32 rows, 16-byte aligned,
// D % BD == 0 and BD % 16 == 0; out (Q, N) f32.  Returns the cudaError_t.
int l2_scan_launch(int device, const float* q, const float* c, float* out, int Q, int N,
                   int D, int BD, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q <= 0 || N <= 0) return 0;
  if (BD <= 0 || D % BD || BD % kKC) return static_cast<int>(cudaErrorInvalidValue);
  const long long q_tiles = (Q + kTile - 1) / kTile, c_tiles = (N + kTile - 1) / kTile;
  if (q_tiles * c_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(l2_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, c, out, Q, N, D, BD, static_cast<int>(q_tiles)};
  l2_scan_kernel<<<static_cast<unsigned>(q_tiles * c_tiles), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
