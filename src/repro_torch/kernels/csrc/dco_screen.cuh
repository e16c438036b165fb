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
// What bounds it on this card (an H100 SXM).  At the flat screen's shape
// (Q = 1024, N = 2^20, D = 256, Δd = 64) every pair needs its exact
// block-1 partial sum (est is an output for every pair), in dimension
// order, with a rounded multiply and a rounded add per product: 2^30 pairs
// x 64 dims x 2 = 1.37e11 fp32 instructions, ~4.1 ms at 128 lanes x 132
// SMs x 1.98 GHz (the instruction floor; exactness rules out FFMA, TF32,
// mma and wgmma).  The three (Q, N) 32-bit outputs are 12.9 GB, ~3.9 ms at
// 3.35 TB/s (the byte floor).  99.98 % of pairs retire at the first checkpoint.
//
// Design.  The TPU kernels walk a (q_tile, c_tile, S) grid whose S axis
// runs in order and carries psum/active/retirement state in VMEM.  Here
// one CTA of 256 threads owns a 128-query x 64-candidate tile and walks the
// S dimension blocks itself, two CTAs to an SM.  What it does about the
// four costs of the 16 x 128 skeleton it replaces:
//  1. The corpus streamed once per query tile: the grid is one linear
//     index with the query tile fastest, so the Q/128 CTAs that share a
//     candidate tile run together and the corpus's first block comes from
//     memory about once.
//  2. Tile-granular early exit: block 1 runs dense for every pair (every
//     pair needs it); at each checkpoint the CTA counts the pairs still
//     active.  At or under kListCap they go into a list in shared memory
//     (query, candidate, partial sum): a round stages its entries' query
//     and candidate dims [d_s, D) at once (cp.async through L2), the CTA
//     sums every (entry, block) norm and dot product at once, a thread a
//     sum, and one thread an entry folds its blocks in order until it
//     retires.  Over the capacity the tile runs the next block dense (r² =
//     1e30, no screening, loose thresholds), its survivors' partial sums
//     waiting in shared memory between dense blocks.
//  3. Unoverlapped loads: a dense block stages 16 dimensions at a time
//     through a 4-deep cp.async ring, so the next chunks load under this
//     chunk's products; the other CTA on the SM covers this one's latency.
//  4. Shared-memory traffic: a register-tiled product, as in l2_scan.cu:
//     thread (ty, tx) owns queries ty + 16i (i < 8) and candidates tx + 16j
//     (j < 4), 32 dot products in registers, reading per 4 dimensions its 4
//     candidates' float4s and then one query float4 at a time (12 shared
//     loads per 128 products; rows padded to 20 floats, conflict-free).  The
//     block norms are summed once per CTA row (thread t owns staged row t).
//     In int8 mode the codes stage as bytes (one 16-byte cp.async is 16
//     dimensions of a row) and each code is dequantized once per CTA, as a
//     rounded code·scale[d], into the f32 ring slot before the products.
// A pair's three outputs are written once, when it retires, with streaming
// stores (st.global.cs) so they do not push the corpus out of L2; a dense
// checkpoint's stores are coalesced across tx and predicated, not
// branched.  Every sum (the two norms and the dot product of a block, then
// psum) runs in dimension order with __fmul_rn/__fadd_rn, the order of
// tiles.mxu_block_sq, on both paths, so kernel and plain version agree bit
// for bit whatever the tile, the capacity or the path (the build passes
// -fmad=false as well).  Indexing into the (Q, N) outputs is 64-bit: Q·N
// reaches 2^30 elements.
#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace dade {

enum ScreenMode { kFp32Screen = 0, kInt8Screen = 1 };

constexpr int kScreenThreads = 256;
constexpr int kScreenMinBlocks = 2;            // CTAs an SM holds
constexpr int kScreenTQ = 128;                 // queries per CTA
constexpr int kScreenTC = 64;                  // candidates per CTA
constexpr int kScreenQS = kScreenThreads / 16; // a thread's queries ty + QS·i
constexpr int kScreenMI = kScreenTQ / kScreenQS;  // per thread: 8 queries
constexpr int kScreenMJ = kScreenTC / 16;         //   x 4 candidates
constexpr int kScreenKC = 16;                  // dimensions per staged chunk
constexpr int kScreenStages = 4;               // chunks in flight
constexpr int kScreenRS = kScreenKC + 4;       // staged row stride (floats)
constexpr int kScreenRows = kScreenTQ + kScreenTC;       // queries, then candidates
constexpr int kScreenChunk = kScreenRows * kScreenRS;    // floats per ring slot
constexpr int kScreenRing = kScreenStages * kScreenChunk;
constexpr int kListCap = 512;                  // survivors a tile keeps as a list
static_assert(kScreenMI * kScreenMJ == 32 && kScreenRows <= kScreenThreads,
              "one thread a staged row; 32 pairs a thread (the active mask's bits)");

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
  int Q, N, D, S, BD, q_tiles;
  float one_minus_slack;
};

__host__ __device__ inline size_t screen_align16(size_t x) { return (x + 15) / 16 * 16; }

// Floats of the staging ring one list entry takes for `dims` dimensions (a
// multiple of 16): the query's and the candidate's f32 values, padded to 4
// mod 32 floats so eight consecutive entries' float4 reads hit distinct
// banks, and in int8 mode the candidate's code bytes as staged.
__host__ __device__ inline int screen_entry_floats(int dims, bool int8) {
  return 2 * dims + 4 + (int8 ? dims / 4 : 0);
}

// Byte offsets of the shared-memory regions (same function on both sides).
struct ScreenLayout {
  size_t ring, codes, psum, nrm, thr, scl, ecum, rsq, lpsum, lidx, cnt, total;
};

__host__ __device__ inline ScreenLayout screen_layout(int S) {
  ScreenLayout L;
  size_t o = 0;
  L.ring = o;  o = screen_align16(o + 4ull * kScreenRing);  // also the list's staging
  L.codes = o; o = screen_align16(o + 16ull * kScreenStages * kScreenTC);
  L.psum = o;  o = screen_align16(o + 4ull * kScreenTQ * kScreenTC);
  L.nrm = o;   o = screen_align16(o + 4ull * kScreenRows);
  L.thr = o;   o = screen_align16(o + 4ull * S);
  L.scl = o;   o = screen_align16(o + 4ull * S);
  L.ecum = o;  o = screen_align16(o + 4ull * S);
  L.rsq = o;   o = screen_align16(o + 4ull * kScreenTQ);
  L.lpsum = o; o = screen_align16(o + 4ull * kListCap);
  L.lidx = o;  o = screen_align16(o + 4ull * kListCap);
  L.cnt = o;   o = screen_align16(o + 4ull);
  L.total = o;
  return L;
}

// One pair's checkpoint, `lim` = (1+ε_s)²r²: true where it retires there,
// with its estimate and flag.  The fp32 screen's last checkpoint is the
// exact terminal retire; the lower bound may reject at every checkpoint.
template <int MODE>
__device__ __forceinline__ bool screen_retire(float psum, bool last, float lim, float scl,
                                              float ecum, float rsq, float one_minus_slack,
                                              float& e, int& flag) {
  if constexpr (MODE == kInt8Screen)
    e = lb_penalized(psum, ecum, scl, one_minus_slack);
  else
    e = __fmul_rn(psum, scl);
  const bool rej = (MODE == kInt8Screen || !last) && e > lim;
  if constexpr (MODE == kInt8Screen)
    flag = rej;
  else
    flag = !rej && e <= rsq;
  return rej || last;
}

// A pair's three outputs, written where `p` holds with streaming stores
// that are predicated rather than branched on.
__device__ __forceinline__ void screen_store(bool p, float* est, int* flag, int* dims,
                                             float e, int f, int d) {
  asm volatile(
      "{\n  .reg .pred q;\n  setp.ne.b32 q, %0, 0;\n"
      "  @q st.global.cs.b32 [%1], %2;\n  @q st.global.cs.b32 [%3], %4;\n"
      "  @q st.global.cs.b32 [%5], %6;\n}\n" ::"r"(static_cast<unsigned>(p)),
      "l"(est), "r"(__float_as_uint(e)), "l"(flag), "r"(f), "l"(dims), "r"(d)
      : "memory");
}

// cp.async chunk [d0, d0 + 16) of the tile into ring slot `buf`: thread t
// stages row t (the row whose norm it sums), f32 query rows, then f32
// candidate rows or 16 code bytes a candidate into `cbuf`; masked rows of a
// ragged tile are zero-filled.
template <int MODE>
__device__ __forceinline__ void screen_stage_chunk(const ScreenArgs& a, float* buf,
                                                   int8_t* cbuf, long long q0,
                                                   long long c0, int d0) {
  const int r = threadIdx.x;
  if (r < kScreenTQ) {
    const bool ok = q0 + r < a.Q;
    const float* src = ok ? a.q + (q0 + r) * a.D + d0 : a.q;
#pragma unroll
    for (int p = 0; p < kScreenKC / 4; ++p)
      cp_async16_zfill(buf + r * kScreenRS + p * 4, src + p * 4, ok);
  } else if (r < kScreenRows) {
    const long long row = c0 + (r - kScreenTQ);
    const bool ok = row < a.N;
    if constexpr (MODE == kInt8Screen) {
      const int8_t* codes = static_cast<const int8_t*>(a.c);
      cp_async16_zfill(cbuf + (r - kScreenTQ) * 16, ok ? codes + row * a.D + d0 : codes, ok);
    } else {
      const float* rows = static_cast<const float*>(a.c);
      const float* src = ok ? rows + row * a.D + d0 : rows;
#pragma unroll
      for (int p = 0; p < kScreenKC / 4; ++p)
        cp_async16_zfill(buf + r * kScreenRS + p * 4, src + p * 4, ok);
    }
  }
  cp_async_commit();
}

// Four int8 codes at `b`, dequantized with the scales of dims d .. d+3.
__device__ __forceinline__ float4 screen_dequant4(const int8_t* b, const float* cscales,
                                                  int d) {
  const int packed = *reinterpret_cast<const int*>(b);
  const int8_t* c = reinterpret_cast<const int8_t*>(&packed);
  return make_float4(__fmul_rn(static_cast<float>(c[0]), __ldg(cscales + d)),
                     __fmul_rn(static_cast<float>(c[1]), __ldg(cscales + d + 1)),
                     __fmul_rn(static_cast<float>(c[2]), __ldg(cscales + d + 2)),
                     __fmul_rn(static_cast<float>(c[3]), __ldg(cscales + d + 3)));
}

template <int MODE>
__device__ __forceinline__ void dco_screen(const ScreenArgs& a) {
  constexpr int T = kScreenThreads, QS = kScreenQS, MI = kScreenMI, MJ = kScreenMJ;
  constexpr bool kInt8 = MODE == kInt8Screen;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, BD = a.BD;
  const ScreenLayout L = screen_layout(S);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  int8_t* cring = reinterpret_cast<int8_t*>(smem + L.codes);
  float* psum = reinterpret_cast<float*>(smem + L.psum);  // survivor k of thread t at k * T + t
  float* nrm = reinterpret_cast<float*>(smem + L.nrm);
  float* thr_s = reinterpret_cast<float*>(smem + L.thr);
  float* scl_s = reinterpret_cast<float*>(smem + L.scl);
  float* ecum_s = reinterpret_cast<float*>(smem + L.ecum);
  float* rsq_s = reinterpret_cast<float*>(smem + L.rsq);
  float* lpsum = reinterpret_cast<float*>(smem + L.lpsum);  // the list: partial sums
  int* lidx = reinterpret_cast<int*>(smem + L.lidx);        //   and ql | cl << 8
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);          // the survivors counted

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q0 = static_cast<long long>(blockIdx.x % a.q_tiles) * kScreenTQ;
  const long long c0 = static_cast<long long>(blockIdx.x / a.q_tiles) * kScreenTC;
  const size_t n_cols = static_cast<size_t>(a.N);

  // ---- prologue: per-checkpoint constants and the tile's thresholds ----
  for (int s = tid; s < S; s += T) {
    const float t = __fadd_rn(1.0f, a.eps[s]);
    thr_s[s] = __fmul_rn(t, t);
    scl_s[s] = a.scale[s];
    ecum_s[s] = kInt8 ? a.ecum[s] : 0.0f;
  }
  if (tid < kScreenTQ) rsq_s[tid] = q0 + tid < a.Q ? a.rsq[q0 + tid] : 0.0f;
  if (tid == 0) cnt[0] = 0;

  float dot[MI][MJ];
  unsigned active = 0;  // bit i * MJ + j: pair (ty + QS·i, tx + 16j) not yet retired
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      dot[i][j] = 0.0f;
      if (q0 + ty + QS * i < a.Q && c0 + tx + 16 * j < a.N) active |= 1u << (i * MJ + j);
    }

  // ---- dense blocks: every pair of the tile, register-tiled ----
  int s = 0, n_list = 0;
  for (;;) {
    const int chunks = BD / kScreenKC, d_base = s * BD;
    for (int k = 0; k < kScreenStages - 1; ++k) {
      if (k < chunks)
        screen_stage_chunk<MODE>(a, ring + k * kScreenChunk, cring + k * 16 * kScreenTC,
                                 q0, c0, d_base + k * kScreenKC);
      else
        cp_async_commit();
    }
    float norm = 0.0f;  // staged row tid's norm over this block
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait<kScreenStages - 2>();
      __syncthreads();  // chunk ch has landed; every thread is past chunk ch-1
      const int nx = ch + kScreenStages - 1;  // refill the slot chunk ch-1 used
      if (nx < chunks)
        screen_stage_chunk<MODE>(a, ring + (nx % kScreenStages) * kScreenChunk,
                                 cring + (nx % kScreenStages) * 16 * kScreenTC, q0, c0,
                                 d_base + nx * kScreenKC);
      else
        cp_async_commit();
      float* qb = ring + (ch % kScreenStages) * kScreenChunk;
      float* cb = qb + kScreenTQ * kScreenRS;
      if constexpr (kInt8) {
        // Dequantize the chunk's codes once, 4 at a time: row e/4, piece e%4.
#pragma unroll
        for (int e = tid; e < 4 * kScreenTC; e += T) {
          const int r = e >> 2, piece = e & 3;
          *reinterpret_cast<float4*>(cb + r * kScreenRS + piece * 4) = screen_dequant4(
              cring + (ch % kScreenStages) * 16 * kScreenTC + r * 16 + piece * 4, a.cscales,
              d_base + ch * kScreenKC + piece * 4);
        }
        __syncthreads();
      }
      if (tid < kScreenRows) {
        const float* own = qb + tid * kScreenRS;
#pragma unroll
        for (int w = 0; w < kScreenKC; w += 4) {
          const float4 v = *reinterpret_cast<const float4*>(own + w);
          norm = __fadd_rn(norm, __fmul_rn(v.x, v.x));
          norm = __fadd_rn(norm, __fmul_rn(v.y, v.y));
          norm = __fadd_rn(norm, __fmul_rn(v.z, v.z));
          norm = __fadd_rn(norm, __fmul_rn(v.w, v.w));
        }
      }
#pragma unroll
      for (int w = 0; w < kScreenKC; w += 4) {
        float4 cv[MJ];  // the thread's 4 candidates, then one query at a time
#pragma unroll
        for (int j = 0; j < MJ; ++j)
          cv[j] = *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * kScreenRS + w);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qb + (ty + QS * i) * kScreenRS + w);
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            float d = dot[i][j];
            d = __fadd_rn(d, __fmul_rn(qv.x, cv[j].x));
            d = __fadd_rn(d, __fmul_rn(qv.y, cv[j].y));
            d = __fadd_rn(d, __fmul_rn(qv.z, cv[j].z));
            d = __fadd_rn(d, __fmul_rn(qv.w, cv[j].w));
            dot[i][j] = d;
          }
        }
      }
    }
    if (tid < kScreenRows) nrm[tid] = norm;
    __syncthreads();  // the block's norms are in; every read of the ring is done

    // ---- checkpoint s: fold the block into psum, test, retire ----
    // The partial sums wait in shared memory between dense blocks, so the
    // products hold only the dot products in registers.  A retiring pair's
    // stores are predicated, from one pointer per query row and array.
    const bool last = s == S - 1;
    const float scl = scl_s[s], ecum = ecum_s[s], thr = thr_s[s];
    const int dims_out = (s + 1) * BD;
    size_t base = static_cast<size_t>(q0 + ty) * n_cols + static_cast<size_t>(c0 + tx);
    size_t row_step = QS * n_cols;
    // Opaque here, so the store addresses are formed now rather than in the
    // prologue, where they would stay live (and spill) across the products.
    asm volatile("" : "+l"(base), "+l"(row_step));
    float cn[MJ];
#pragma unroll
    for (int j = 0; j < MJ; ++j) cn[j] = nrm[kScreenTQ + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int ql = ty + QS * i;
      const float qn = nrm[ql], rsq = rsq_s[ql];
      const float lim = dade_threshold(thr, rsq);
      const size_t row = base + i * row_step;
      float* est_row = a.est + row;
      int* flag_row = a.flag + row;
      int* dims_row = a.dims + row;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int k = i * MJ + j;
        const float prev = s == 0 ? 0.0f : psum[k * T + tid];
        const float ps = __fadd_rn(prev, block_sq(qn, cn[j], dot[i][j]));
        dot[i][j] = 0.0f;
        float e;
        int flag;
        const bool retire = screen_retire<MODE>(ps, last, lim, scl, ecum, rsq,
                                                a.one_minus_slack, e, flag);
        const bool on = (active >> k) & 1u;
        screen_store(on && retire, est_row + 16 * j, flag_row + 16 * j, dims_row + 16 * j,
                     e, flag, dims_out);
        if (on && !retire) psum[k * T + tid] = ps;  // a survivor's sum, for later
        if (retire) active &= ~(1u << k);
      }
    }
    // Count the survivors; at or under the capacity they become the list.
    const int mine = __popc(active);
    const int at0 = mine ? atomicAdd(cnt, mine) : 0;
    __syncthreads();
    const int total = cnt[0];
    ++s;
    if (total == 0) return;  // uniform: every thread read the same count
    if (total <= kListCap) {
      int at = at0;
      for (unsigned m = active; m; m &= m - 1, ++at) {
        const int k = __ffs(m) - 1;
        lpsum[at] = psum[k * T + tid];
        lidx[at] = (ty + QS * (k / MJ)) | ((tx + 16 * (k % MJ)) << 8);
      }
      n_list = total;
    }
    __syncthreads();  // the list is written; every thread has read the count
    if (n_list) break;
    if (tid == 0) cnt[0] = 0;  // read by all before the barrier above
  }

  // ---- the list: each survivor carried through the later blocks ----
  // A round stages its entries' remaining dims [d0, D) of the query and the
  // candidate at once (int8 codes are then dequantized by the whole CTA).
  // Every (entry, block) sum of the query norm, the candidate norm and the
  // dot product is independent of the others, so the CTA sums them all at
  // once, a thread a sum in dimension order, into the region the dense
  // partial sums used; thread e then folds entry e's blocks in order until
  // it retires.
  const int d0 = s * BD, rest = a.D - d0, blocks = S - s;
  const int stride = 2 * rest + 4;
  const int per_round = min(min(T, kScreenRing / screen_entry_floats(rest, kInt8)),
                            kScreenTQ * kScreenTC / (3 * blocks));
  int8_t* codes_s = reinterpret_cast<int8_t*>(ring + per_round * stride);  // (entry, rest)
  float* sums = psum;  // (entry, block, {query norm, candidate norm, dot})
  const int q_pieces = rest / 4, pieces = q_pieces + (kInt8 ? rest / 16 : rest / 4);
  for (int r0 = 0; r0 < n_list; r0 += per_round) {
    const int m = min(per_round, n_list - r0);
    for (int e = tid; e < m * pieces; e += T) {
      const int k = e / pieces, p = e - k * pieces;
      const int idx = lidx[r0 + k];
      float* dst = ring + k * stride;
      if (p < q_pieces) {
        cp_async16(dst + p * 4, a.q + (q0 + (idx & 0xff)) * a.D + d0 + p * 4);
      } else {
        const long long ci = c0 + (idx >> 8);
        const int pc = p - q_pieces;
        if constexpr (kInt8)
          cp_async16(codes_s + k * rest + pc * 16,
                     static_cast<const int8_t*>(a.c) + ci * a.D + d0 + pc * 16);
        else
          cp_async16(dst + rest + pc * 4,
                     static_cast<const float*>(a.c) + ci * a.D + d0 + pc * 4);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kInt8) {
      for (int e = tid; e < m * (rest / 4); e += T) {
        const int k = e / (rest / 4), p = 4 * (e - k * (rest / 4));
        *reinterpret_cast<float4*>(ring + k * stride + rest + p) =
            screen_dequant4(codes_s + k * rest + p, a.cscales, d0 + p);
      }
      __syncthreads();
    }
    for (int e = tid; e < m * blocks * 3; e += T) {
      const int k = e / (3 * blocks), t = e / 3 - k * blocks, which = e % 3;
      const float* x = ring + k * stride + t * BD + (which == 1 ? rest : 0);
      const float* y = ring + k * stride + t * BD + (which == 0 ? 0 : rest);
      float acc = 0.0f;
#pragma unroll 4
      for (int d = 0; d < BD; d += 4) {
        const float4 u = *reinterpret_cast<const float4*>(x + d);
        const float4 v = *reinterpret_cast<const float4*>(y + d);
        acc = __fadd_rn(acc, __fmul_rn(u.x, v.x));
        acc = __fadd_rn(acc, __fmul_rn(u.y, v.y));
        acc = __fadd_rn(acc, __fmul_rn(u.z, v.z));
        acc = __fadd_rn(acc, __fmul_rn(u.w, v.w));
      }
      sums[e] = acc;
    }
    __syncthreads();
    if (tid < m) {
      const int idx = lidx[r0 + tid];
      const int ql = idx & 0xff, cl = idx >> 8;
      const float rsq = rsq_s[ql];
      const size_t o = static_cast<size_t>(q0 + ql) * n_cols + static_cast<size_t>(c0 + cl);
      const float* sm = sums + tid * 3 * blocks;
      float ps = lpsum[r0 + tid];
      for (int t = s; t < S; ++t, sm += 3) {
        ps = __fadd_rn(ps, block_sq(sm[0], sm[1], sm[2]));
        float e;
        int flag;
        if (screen_retire<MODE>(ps, t == S - 1, dade_threshold(thr_s[t], rsq), scl_s[t],
                                ecum_s[t], rsq, a.one_minus_slack, e, flag)) {
          screen_store(true, a.est + o, a.flag + o, a.dims + o, e, flag, (t + 1) * BD);
          break;
        }
      }
    }
    __syncthreads();  // the staging and the sums are free again
  }
}

template <int MODE>
__global__ void __launch_bounds__(kScreenThreads, kScreenMinBlocks)
    screen_kernel(const ScreenArgs a) {
  dco_screen<MODE>(a);
}

// Launch screen_kernel<MODE> on `stream`; returns the cudaError_t.
template <int MODE>
inline int launch_screen(int device, ScreenArgs a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.Q <= 0 || a.N <= 0) return 0;
  if (a.BD <= 0 || a.BD % kScreenKC || a.D % a.BD ||
      (a.S > 1 && screen_entry_floats(a.D - a.BD, MODE == kInt8Screen) > kScreenRing))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long q_tiles = (a.Q + kScreenTQ - 1) / kScreenTQ;
  const long long c_tiles = (a.N + kScreenTC - 1) / kScreenTC;
  if (q_tiles * c_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.q_tiles = static_cast<int>(q_tiles);
  const size_t smem = screen_layout(a.S).total;
  err = cudaFuncSetAttribute(screen_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  screen_kernel<MODE><<<static_cast<unsigned>(q_tiles * c_tiles), kScreenThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dade

// One C entry point per kernel, the same signature for both: pointers a mode
// does not read may be null.  The shared memory does not depend on BD.
#define DADE_SCREEN_ENTRY(NAME, MODE)                                              \
  extern "C" long long NAME##_smem_bytes(int S, int BD) {                           \
    (void)BD;                                                                        \
    return static_cast<long long>(dade::screen_layout(S).total);                    \
  }                                                                                  \
  extern "C" int NAME##_launch(int device, const float* q, const void* c,          \
                               const float* cscales, const float* eps,             \
                               const float* scale, const float* ecum,              \
                               const float* rsq, float* est, int* flag, int* dims, \
                               int Q, int N, int D, int BD, float one_minus_slack, \
                               void* stream) {                                     \
    const dade::ScreenArgs a{q, c, cscales, eps, scale, ecum, rsq, est, flag,       \
                             dims, Q, N, D, D / BD, BD, 0, one_minus_slack};        \
    return dade::launch_screen<MODE>(device, a, stream);                            \
  }
