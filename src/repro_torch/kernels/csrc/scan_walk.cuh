// The walk both fused scans share, for Hopper (sm_90a): one CTA owns one
// tile of 8 queries and walks that tile's row of a step table of candidate
// tiles, each BC rows tall, with an int8 stage-1 prefilter, a demand-paged
// fp32/bf16 DADE re-screen and a sorted top-K window kept on chip.
//
// ivf_scan.cu instantiates it at BC = 128 (bucket tiles), graph_scan.cu at
// BC = 32 (one node's neighbour block).  The graph walk adds three things,
// each a field of WalkArgs that the IVF scan leaves at its neutral value:
// the window column that tightens r² (thresh_col; K-1 for the IVF scan),
// a frozen-threshold mode (tighten = 0), and the packed visited bitmap
// (vis; null for the IVF scan).
//
// Per step of the walk:
//   * the int8 codes tile (BC x D) arrives by cp.async into one of two
//     shared buffers; the next step's fresh tile is issued before this
//     step's work, and a real step whose offset equals the last issued one
//     re-uses the resident buffer, even across -1 gap steps (the
//     reference's slot_s[0, 1] cursor);
//   * stage 1 runs on the tensor cores: warp w < BC/16 multiplies
//     candidates 16w..16w+15 with the 8 queries by mma.sync m16n8k32
//     (s8 x s8 -> s32), one Δd block at a time, and each lane carries 2
//     candidates x 2 queries through the per-block dequantize and the
//     cumulative error band, bit-identical to tiles.stage1_tile (exact
//     integer dot, then elementwise float ops in the same order, no FMA);
//     the stage-1 masks then pass through shared memory to stage 2, where
//     each thread owns one candidate and 8·BC/256 of the queries;
//   * a block-wide vote (__syncthreads_or) gates stage 2, and inside it
//     each (BC, Δd) fp slab is fetched (cp.async, in the row dtype) only
//     while some valid candidate is still active (tiles.stage2_need); its
//     norms and dot products are summed one dimension at a time, in order,
//     with rounded multiplies and adds (no FMA), the order of the plain
//     version, so distances, decisions and r² agree with it bit for bit;
//   * survivors not already in the window (tiles.dup_mask) are merged by
//     insertion into the sorted (8, K) window, one warp per query row,
//     keeping the reference's tie order (window first, then lower column),
//     and r² = min(r², top[thresh_col]) unless the threshold is frozen.
// Counters are kept in 32/64-bit integers and converted to float once at
// the end, so columns 0 and 2 of stats stay exact past 2^24.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace dade {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 8;  // queries per CTA: the mma's n
constexpr unsigned kFull = 0xffffffffu;

struct WalkArgs {
  const int* offs;         // (q_tiles, steps) tile offsets, -1 = gap step
  const int8_t* qcodes;    // (Q, D) int8
  const float* q;          // (Q, D) f32
  const float* qscales;    // (Q, S) f32
  const float* r0;         // (Q,) f32
  const float* top0_sq;    // (Q, K) f32
  const int* top0_ids;     // (Q, K) i32
  const int8_t* codes;     // (N, D) int8
  const void* rows;        // (N, D) f32 or bf16
  const int* ids;          // (N,) i32, -1 = padding
  const float* bscales;    // (S,)
  const float* eps;        // (S,)
  const float* scale;      // (S,)
  float* top_sq;           // (Q, K)
  int* top_ids;            // (Q, K)
  float* stats;            // (Q, 6)
  const unsigned* vis0;    // (q_tiles, vis_words) bitmap carried in, or null
  unsigned* vis;           // (q_tiles, vis_words) bitmap out, or null
  int steps, D, S, K, BD, rows_bf16;
  int thresh_col;          // window column r² tightens to after a merge
  int tighten;             // 0: r² stays at r0 for the whole launch
  int vis_words, vis_base;
  float one_minus_slack;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of the shared-memory regions (same function on both sides).
struct Layout {
  size_t codes, qcodes, q, slab, qn1, tqsb, eband, qn2, thr, sb, scl, rsq,
      top_sq, top_ids, cand, ids, act, acc, total;
};

template <int BC>
__host__ __device__ inline Layout make_layout(int D, int S, int K, int BD) {
  constexpr int BQ = kBQ;
  Layout L;
  size_t o = 0;
  L.codes = o;   o = align16(o + 2ull * BC * (D + 16));
  L.qcodes = o;  o = align16(o + 1ull * BQ * (D + 16));
  L.q = o;       o = align16(o + 4ull * BQ * D);
  L.slab = o;    o = align16(o + 1ull * BC * (4 * BD + 16));
  L.qn1 = o;     o = align16(o + 4ull * BQ * S);
  L.tqsb = o;    o = align16(o + 4ull * BQ * S);
  L.eband = o;   o = align16(o + 4ull * BQ * S);
  L.qn2 = o;     o = align16(o + 4ull * BQ * S);
  L.thr = o;     o = align16(o + 4ull * S);
  L.sb = o;      o = align16(o + 4ull * S);
  L.scl = o;     o = align16(o + 4ull * S);
  L.rsq = o;     o = align16(o + 4ull * BQ);
  L.top_sq = o;  o = align16(o + 4ull * BQ * K);
  L.top_ids = o; o = align16(o + 4ull * BQ * K);
  L.cand = o;    o = align16(o + 4ull * BQ * BC);
  L.ids = o;     o = align16(o + 4ull * BC);
  L.act = o;     o = align16(o + 1ull * BQ * BC);
  L.acc = o;     o = align16(o + 8ull * BQ * 3);
  L.total = o;
  return L;
}

// cp.async a (BC rows x `chunks` 16-byte chunks) block, source rows
// `src_stride` bytes apart, into shared rows `dst_stride` bytes apart; the
// block's threads walk the chunks in order without dividing in the loop.
template <int BC>
__device__ __forceinline__ void issue_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src,
                                           size_t src_stride, int chunks) {
  const int dr = kThreads / chunks, dch = kThreads - dr * chunks;
  int r = threadIdx.x / chunks, ch = threadIdx.x - r * chunks;
  while (r < BC) {
    cp_async16(dst + r * dst_stride + ch * 16, src + r * src_stride + ch * 16);
    r += dr;
    ch += dch;
    if (ch >= chunks) {
      ch -= chunks;
      ++r;
    }
  }
  cp_async_commit();
}

// Issue the copies of codes tile `off` into `dst` (row stride D+16).
template <int BC>
__device__ __forceinline__ void issue_tile(const WalkArgs& a, int8_t* dst, int off) {
  issue_rows<BC>(reinterpret_cast<unsigned char*>(dst), a.D + 16,
                 reinterpret_cast<const unsigned char*>(a.codes) +
                     static_cast<size_t>(off) * BC * a.D,
                 a.D, a.D / 16);
}

// Issue the copies of fp slab `sb` of tile `off` into `slab`, in the row
// dtype, row stride BD*itemsize + 16 (conflict-free 16-byte reads).
template <int BC>
__device__ __forceinline__ void issue_slab(const WalkArgs& a, unsigned char* slab,
                                           int off, int sb) {
  const int isz = a.rows_bf16 ? 2 : 4;
  issue_rows<BC>(slab, a.BD * isz + 16,
                 static_cast<const unsigned char*>(a.rows) +
                     (static_cast<size_t>(off) * BC * a.D + sb * a.BD) * isz,
                 static_cast<size_t>(a.D) * isz, a.BD * isz / 16);
}

// Stage-2 products of one slab row (this thread's candidate) with its QPT
// query rows: cn += x·x, dot[j] += q_j·x, 16 bytes of the row at a time.
template <bool BF16, int QPT>
__device__ __forceinline__ void slab_dots(const unsigned char* row, const float* q_s,
                                          int D, int BD, int sb, int g, int ngroups,
                                          float& cn, float (&dot)[QPT]) {
  constexpr int E = BF16 ? 8 : 4;  // values per 16-byte chunk
  for (int w = 0; w < BD; w += E) {
    const int4 raw = *reinterpret_cast<const int4*>(row + w * (BF16 ? 2 : 4));
    float x[E];
    if constexpr (BF16) {
      const unsigned u[4] = {static_cast<unsigned>(raw.x), static_cast<unsigned>(raw.y),
                             static_cast<unsigned>(raw.z), static_cast<unsigned>(raw.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(u[i] << 16);
        x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else {
      x[0] = __int_as_float(raw.x);
      x[1] = __int_as_float(raw.y);
      x[2] = __int_as_float(raw.z);
      x[3] = __int_as_float(raw.w);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) cn = __fadd_rn(cn, __fmul_rn(x[e], x[e]));
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float* qv = q_s + (g + j * ngroups) * D + sb * BD + w;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qv + e);
        dot[j] = __fadd_rn(dot[j], __fmul_rn(qq.x, x[e]));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(qq.y, x[e + 1]));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(qq.z, x[e + 2]));
        dot[j] = __fadd_rn(dot[j], __fmul_rn(qq.w, x[e + 3]));
      }
    }
  }
}

// Stable insertion sort of one window row (the seeded window may be in any
// order; the reference's min-extract merge sorts it on the first merge).
__device__ inline void sort_row(float* sq, int* ids, int K) {
  for (int i = 1; i < K; ++i) {
    const float v = sq[i];
    const int id = ids[i];
    int j = i - 1;
    while (j >= 0 && sq[j] > v) {
      sq[j + 1] = sq[j];
      ids[j + 1] = ids[j];
      --j;
    }
    sq[j + 1] = v;
    ids[j + 1] = id;
  }
}

// One warp merges row r's candidates (inf = not entering) into its sorted
// window: each entrant, in column order, goes after every window entry
// <= its distance — the stable order of the reference's min-extract.
__device__ inline void merge_row(float* wsq, int* wid, const float* cand,
                                 const int* ids, int K, int BC, int lane) {
  for (int base = 0; base < BC; base += 32) {
    const int cc = base + lane;
    const float v = cc < BC ? cand[cc] : INFINITY;
    const int id = cc < BC ? ids[cc] : -1;
    unsigned m = __ballot_sync(kFull, v < wsq[K - 1]);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float vv = __shfl_sync(kFull, v, src);
      const int ii = __shfl_sync(kFull, id, src);
      int cnt = 0;
      for (int kk = lane; kk < K; kk += 32) cnt += wsq[kk] <= vv;
      const int pos = __reduce_add_sync(kFull, cnt);
      if (pos < K) {
        float tv[4];
        int ti[4];
        int n = 0;
        for (int kk = pos + lane; kk < K - 1; kk += 32, ++n) {
          tv[n] = wsq[kk];
          ti[n] = wid[kk];
        }
        __syncwarp();
        n = 0;
        for (int kk = pos + lane; kk < K - 1; kk += 32, ++n) {
          wsq[kk + 1] = tv[n];
          wid[kk + 1] = ti[n];
        }
        __syncwarp();
        if (lane == 0) {
          wsq[pos] = vv;
          wid[pos] = ii;
        }
        __syncwarp();
      }
    }
  }
  for (int kk = lane; kk < K; kk += 32)
    if (isinf(wsq[kk])) wid[kk] = -1;
  __syncwarp();
}

// One m16n8k32 int8 tensor-core product: d += a (16x32, row) · b (32x8, col).
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The walk of query tile blockIdx.x over its row of a.offs; the body of
// both kernels (launched with kThreads threads and make_layout<BC> bytes
// of dynamic shared memory).
template <int BC>
__device__ __forceinline__ void scan_walk(const WalkArgs& a) {
  static_assert(BC % 32 == 0 && BC <= 16 * kWarps, "BC: 32..128, a multiple of 32");
  constexpr int kQPT = kBQ * BC / kThreads;  // stage-2 queries per thread
  constexpr int kGroups = kThreads / BC;     // stage-2 query interleave
  constexpr int kS1Warps = BC / 16;          // warps that run stage 1
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, S = a.S, K = a.K, BD = a.BD;
  const Layout L = make_layout<BC>(D, S, K, BD);
  int8_t* codes_buf = reinterpret_cast<int8_t*>(smem + L.codes);
  int8_t* qcodes_s = reinterpret_cast<int8_t*>(smem + L.qcodes);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  unsigned char* slab_s = smem + L.slab;
  float* qn1_s = reinterpret_cast<float*>(smem + L.qn1);
  float* tqsb_s = reinterpret_cast<float*>(smem + L.tqsb);
  float* eband_s = reinterpret_cast<float*>(smem + L.eband);
  float* qn2_s = reinterpret_cast<float*>(smem + L.qn2);
  float* thr_s = reinterpret_cast<float*>(smem + L.thr);
  float* sb_s = reinterpret_cast<float*>(smem + L.sb);
  float* scl_s = reinterpret_cast<float*>(smem + L.scl);
  float* rsq_s = reinterpret_cast<float*>(smem + L.rsq);
  float* top_sq_s = reinterpret_cast<float*>(smem + L.top_sq);
  int* top_ids_s = reinterpret_cast<int*>(smem + L.top_ids);
  float* cand_s = reinterpret_cast<float*>(smem + L.cand);
  int* ids_s = reinterpret_cast<int*>(smem + L.ids);
  unsigned char* act_s = smem + L.act;
  unsigned long long* acc_s = reinterpret_cast<unsigned long long*>(smem + L.acc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Stage-2 and merge ownership: candidate c, queries g + j·kGroups.
  const int c = tid % BC;
  const int g = tid / BC;
  // Stage-1 ownership (mma fragment layout, warps < kS1Warps): candidates
  // ca, cb = ca + 8 of warp w's 16, queries qa = 2t, qb = 2t + 1.
  const bool s1 = warp < kS1Warps;
  const int fg = lane >> 2, ft = lane & 3;
  const int ca = warp * 16 + fg, cb = ca + 8;
  const int qa = 2 * ft, qb = qa + 1;
  const int CS = D + 16;   // codes row stride: conflict-free fragment reads
  const int QS = D + 16;   // query codes row stride, likewise
  const size_t q0 = static_cast<size_t>(blockIdx.x) * kBQ;

  // ---- prologue: the query tile, its per-block constants, window, r² ----
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qcodes_s[r * QS + d] = a.qcodes[q0 * D + e];
    q_s[e] = a.q[q0 * D + e];
  }
  for (int e = tid; e < kBQ * K; e += kThreads) {
    top_sq_s[e] = a.top0_sq[q0 * K + e];
    top_ids_s[e] = a.top0_ids[q0 * K + e];
  }
  for (int s = tid; s < S; s += kThreads) {
    const float t = __fadd_rn(1.0f, a.eps[s]);
    thr_s[s] = __fmul_rn(t, t);
    sb_s[s] = a.bscales[s];
    scl_s[s] = a.scale[s];
  }
  for (int e = tid; e < kBQ * 3; e += kThreads) acc_s[e] = 0ull;
  // The visited bitmap: this tile's row is copied in and then marked in
  // place (one bit per real step); no other CTA touches the row.
  unsigned* vis_row = nullptr;
  if (a.vis != nullptr) {
    vis_row = a.vis + static_cast<size_t>(blockIdx.x) * a.vis_words;
    const unsigned* vis0_row = a.vis0 + static_cast<size_t>(blockIdx.x) * a.vis_words;
    for (int w = tid; w < a.vis_words; w += kThreads) vis_row[w] = vis0_row[w];
  }
  __syncthreads();
  if (tid < kBQ) {
    const int r = tid;
    rsq_s[r] = a.r0[q0 + r];
    float ec2 = 0.0f, eq2 = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float t = a.qscales[(q0 + r) * S + s];
      const float sb = sb_s[s];
      int qn_i = 0;
      float qn2 = 0.0f;
      for (int d = 0; d < BD; ++d) {
        const int v = qcodes_s[r * QS + s * BD + d];
        qn_i += v * v;
        const float x = q_s[r * D + s * BD + d];
        qn2 = __fadd_rn(qn2, __fmul_rn(x, x));
      }
      qn1_s[r * S + s] = __fmul_rn(static_cast<float>(qn_i), __fmul_rn(t, t));
      tqsb_s[r * S + s] = __fmul_rn(t, sb);
      qn2_s[r * S + s] = qn2;
      const float hb = __fmul_rn(sb, 0.5f), hq = __fmul_rn(t, 0.5f);
      ec2 = __fadd_rn(ec2, __fmul_rn(static_cast<float>(BD), __fmul_rn(hb, hb)));
      eq2 = __fadd_rn(eq2, __fmul_rn(static_cast<float>(BD), __fmul_rn(hq, hq)));
      eband_s[r * S + s] = __fadd_rn(sqrtf(ec2), sqrtf(eq2));
    }
  }
  __syncthreads();

  // Counters: stage-1 int8 dims per query (lane's qa, qb), stage-2 dims
  // and passes per query (thread's kQPT queries), tile-level totals.
  unsigned d8_acc[2] = {0u, 0u};
  unsigned d32_acc[kQPT], pass_acc[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) d32_acc[j] = pass_acc[j] = 0u;
  unsigned long long nvalid_acc = 0, slabs_acc = 0, fresh_acc = 0;
  bool window_sorted = false;
  int last = -1;  // offset of the last tile whose copy was issued
  int cur = 0;    // codes buffer holding (or receiving) this step's tile
  const int* offs = a.offs + static_cast<size_t>(blockIdx.x) * a.steps;

  if (a.steps > 0 && offs[0] >= 0) issue_tile<BC>(a, codes_buf, offs[0]);

  for (int step = 0; step < a.steps; ++step) {
    const int off = offs[step];
    const bool real = off >= 0;
    const bool fresh = real && off != last;
    const int resident = real ? off : last;
    // Issue the next fresh tile into the other buffer before this step's
    // work; the buffer it overwrites was last read before the previous
    // step's stage-1 vote, a barrier every thread has passed.
    bool prefetched = false;
    if (step + 1 < a.steps) {
      const int noff = offs[step + 1];
      if (noff >= 0 && noff != resident) {
        issue_tile<BC>(a, codes_buf + (1 - cur) * BC * CS, noff);
        prefetched = true;
      }
    }
    if (fresh) {
      if (prefetched) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
    }
    last = resident;

    if (real) {
      if (vis_row != nullptr && tid == 0) {
        const unsigned gnode = static_cast<unsigned>(off + a.vis_base);
        vis_row[gnode >> 5] |= 1u << (gnode & 31u);
      }
      const int* tile_ids = a.ids + static_cast<size_t>(off) * BC;
      const int cid = tile_ids[c];
      const bool valid = cid >= 0;
      if (g == 0) ids_s[c] = cid;

      // ---- stage 1: int8 lower-bound prefilter (tiles.stage1_tile) ----
      // Pair p of this lane: candidate (p < 2 ? ca : cb), query (p odd ? qb : qa),
      // the mma accumulator order.
      bool mine = false;
      if (s1) {
        const int8_t* tile = codes_buf + cur * BC * CS;
        const bool va = tile_ids[ca] >= 0, vb = tile_ids[cb] >= 0;
        const float rsa = rsq_s[qa], rsb = rsq_s[qb];  // frozen for this tile
        float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        bool act[4] = {true, true, true, true};
        int d8[4] = {0, 0, 0, 0};
        for (int s = 0; s < S; ++s) {
          int dot[4] = {0, 0, 0, 0};
          int cna = 0, cnb = 0;
          for (int k0 = s * BD; k0 < (s + 1) * BD; k0 += 32) {
            const int kk = k0 + 4 * ft;
            const int a0 = *reinterpret_cast<const int*>(tile + ca * CS + kk);
            const int a1 = *reinterpret_cast<const int*>(tile + cb * CS + kk);
            const int a2 = *reinterpret_cast<const int*>(tile + ca * CS + kk + 16);
            const int a3 = *reinterpret_cast<const int*>(tile + cb * CS + kk + 16);
            const int b0 = *reinterpret_cast<const int*>(qcodes_s + fg * QS + kk);
            const int b1 = *reinterpret_cast<const int*>(qcodes_s + fg * QS + kk + 16);
            mma_s8(dot, a0, a1, a2, a3, b0, b1);
            cna = __dp4a(a0, a0, __dp4a(a2, a2, cna));
            cnb = __dp4a(a1, a1, __dp4a(a3, a3, cnb));
          }
          // Row norms: the four lanes of a quad hold a row's 32-dim slices.
          cna += __shfl_xor_sync(kFull, cna, 1);
          cna += __shfl_xor_sync(kFull, cna, 2);
          cnb += __shfl_xor_sync(kFull, cnb, 1);
          cnb += __shfl_xor_sync(kFull, cnb, 2);
          const float sb = sb_s[s];
          const float sb2 = __fmul_rn(sb, sb);
          const float cnf[2] = {__fmul_rn(static_cast<float>(cna), sb2),
                                __fmul_rn(static_cast<float>(cnb), sb2)};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int r = (p & 1) ? qb : qa;
            const float dotf = __fmul_rn(static_cast<float>(dot[p]), tqsb_s[r * S + s]);
            ps[p] = __fadd_rn(ps[p], block_sq(qn1_s[r * S + s], cnf[p >> 1], dotf));
            if (act[p]) d8[p] += BD;
            const float lb = lb_penalized(ps[p], eband_s[r * S + s], scl_s[s],
                                          a.one_minus_slack);
            if (lb > dade_threshold(thr_s[s], (p & 1) ? rsb : rsa)) act[p] = false;
          }
        }
        if (va) {
          d8_acc[0] += d8[0];
          d8_acc[1] += d8[1];
        }
        if (vb) {
          d8_acc[0] += d8[2];
          d8_acc[1] += d8[3];
        }
        act_s[qa * BC + ca] = act[0];
        act_s[qb * BC + ca] = act[1];
        act_s[qa * BC + cb] = act[2];
        act_s[qb * BC + cb] = act[3];
        mine = (va && (act[0] || act[1])) || (vb && (act[2] || act[3]));
      }
      nvalid_acc += __syncthreads_count(g == 0 && valid);
      fresh_acc += fresh ? 1 : 0;
      // Every thread is past its last read of this codes buffer here, and
      // the stage-1 masks are visible.
      const bool alive = __syncthreads_or(mine) != 0;

      if (alive) {
        // ---- stage 2: demand-paged fp re-screen (tiles.stage2_tile) ----
        float rs[kQPT], p2[kQPT];
        bool a2[kQPT];
        int d32[kQPT];
#pragma unroll
        for (int j = 0; j < kQPT; ++j) {
          rs[j] = rsq_s[g + j * kGroups];
          p2[j] = 0.0f;
          a2[j] = act_s[(g + j * kGroups) * BC + c] != 0;
          d32[j] = 0;
        }
        for (int s = 0; s < S; ++s) {
          bool need = false;
#pragma unroll
          for (int j = 0; j < kQPT; ++j) need = need || (a2[j] && valid);
          // Once no valid candidate is active none ever is again: every
          // later slab is skipped too, and nothing read past here matters.
          if (!__syncthreads_or(need)) break;
          issue_slab<BC>(a, slab_s, off, s);
          cp_async_wait<0>();
          __syncthreads();
          ++slabs_acc;
          float cn2 = 0.0f;
          float dt[kQPT];
#pragma unroll
          for (int j = 0; j < kQPT; ++j) dt[j] = 0.0f;
          if (a.rows_bf16)
            slab_dots<true, kQPT>(slab_s + c * (BD * 2 + 16), q_s, D, BD, s, g,
                                  kGroups, cn2, dt);
          else
            slab_dots<false, kQPT>(slab_s + c * (BD * 4 + 16), q_s, D, BD, s, g,
                                   kGroups, cn2, dt);
#pragma unroll
          for (int j = 0; j < kQPT; ++j) {
            const int r = g + j * kGroups;
            p2[j] = __fadd_rn(p2[j], block_sq(qn2_s[r * S + s], cn2, dt[j]));
            if (a2[j]) d32[j] += BD;
            const float est = __fmul_rn(p2[j], scl_s[s]);
            if (s != S - 1 && a2[j] && est > dade_threshold(thr_s[s], rs[j]))
              a2[j] = false;
          }
        }
        // ---- dup mask against the window before this merge ----
        bool enter = false;
#pragma unroll
        for (int j = 0; j < kQPT; ++j) {
          const int r = g + j * kGroups;
          const bool ok = a2[j] && p2[j] <= rs[j] && valid;
          if (valid) d32_acc[j] += d32[j];
          pass_acc[j] += ok ? 1u : 0u;
          float v = INFINITY;
          if (ok) {
            bool dup = false;
            for (int kk = 0; kk < K; ++kk) {
              const int w = top_ids_s[r * K + kk];
              dup = dup || (w >= 0 && w == cid);
            }
            if (!dup) v = p2[j];
          }
          enter = enter || v < INFINITY;
          cand_s[r * BC + c] = v;
        }
        // ---- merge into the window, then r² = min(r², top[thresh_col]) ----
        // After the first merge the window is sorted, its empty slots carry
        // id -1 and r² <= top[thresh_col] (or r² is frozen), so a merge
        // with no entrant changes nothing and is skipped.
        if (__syncthreads_or(enter) || !window_sorted) {
          const int r = warp;  // one warp per query row
          float* wsq = top_sq_s + r * K;
          int* wid = top_ids_s + r * K;
          if (!window_sorted) {
            if (lane == 0) sort_row(wsq, wid, K);
            __syncwarp();
          }
          merge_row(wsq, wid, cand_s + r * BC, ids_s, K, BC, lane);
          if (lane == 0 && a.tighten) rsq_s[r] = fminf(rsq_s[r], wsq[a.thresh_col]);
          window_sorted = true;
          __syncthreads();
        }
      }
    }
    if (prefetched) cur = 1 - cur;
  }

  // ---- epilogue: window and counters -> global ----
  atomicAdd(&acc_s[qa * 3 + 0], static_cast<unsigned long long>(d8_acc[0]));
  atomicAdd(&acc_s[qb * 3 + 0], static_cast<unsigned long long>(d8_acc[1]));
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int r = g + j * kGroups;
    atomicAdd(&acc_s[r * 3 + 1], static_cast<unsigned long long>(d32_acc[j]));
    atomicAdd(&acc_s[r * 3 + 2], static_cast<unsigned long long>(pass_acc[j]));
  }
  __syncthreads();
  for (int e = tid; e < kBQ * K; e += kThreads) {
    a.top_sq[q0 * K + e] = top_sq_s[e];
    a.top_ids[q0 * K + e] = top_ids_s[e];
  }
  if (tid < kBQ) {
    float* o = a.stats + (q0 + tid) * 6;
    o[0] = static_cast<float>(acc_s[tid * 3 + 0]);
    o[1] = static_cast<float>(acc_s[tid * 3 + 1]);
    o[2] = static_cast<float>(nvalid_acc);
    o[3] = static_cast<float>(acc_s[tid * 3 + 2]);
    o[4] = static_cast<float>(slabs_acc);
    o[5] = static_cast<float>(fresh_acc);
  }
}

// Launch kernel `fn` (a scan_walk<BC> instantiation) over q_tiles CTAs on
// `stream`; returns the cudaError_t of the attribute call or the launch.
template <int BC>
inline int launch_walk(void (*fn)(WalkArgs), int device, const WalkArgs& a,
                       int q_tiles, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_tiles <= 0) return 0;
  const size_t smem = make_layout<BC>(a.D, a.S, a.K, a.BD).total;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<q_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dade
