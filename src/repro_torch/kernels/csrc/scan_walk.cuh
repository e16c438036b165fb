// The walk both fused scans share, for Hopper (sm_90a): one CTA owns one
// tile of BQ queries and walks that tile's row of a step table of candidate
// tiles, each BC rows tall, with an int8 stage-1 prefilter, a demand-paged
// fp32/bf16 DADE re-screen and a sorted top-K window kept on chip.
//
// ivf_scan.cu instantiates it at BC = 128 (bucket tiles) and BQ = 8 or 16,
// graph_scan.cu at BC = 32 (one node's neighbour block) and BQ = 8.  A
// pair's decisions, a query's window and its r² depend only on that query,
// so on a step table every query tile shares (the flat serving route) the
// per-query results do not depend on BQ; only the tile-level fetch
// counters (stats columns 4-5) do.  The graph walk adds three things, each
// a field of WalkArgs that the IVF scan leaves at its neutral value: the
// window column that tightens r² (thresh_col; K-1 for the IVF scan), a
// frozen-threshold mode (tighten = 0), and the packed visited bitmap (vis;
// null for the IVF scan).
//
// Per step of the walk:
//   * the int8 codes tile (BC x D) and its ids arrive by cp.async into
//     shared memory; a real step whose offset equals the last issued one
//     re-uses the resident tile, even across -1 gap steps (the reference's
//     slot_s[0, 1] cursor).  There is one buffer (a second bought no time on
//     an H100 and would cost the second CTA on each SM): the next step's
//     fresh tile is issued as soon as this step is done with the buffer,
//     after the stage-1 vote, or after stage 2 when there is one.  The step
//     table itself is read two steps ahead;
//   * stage 1's first Δd block runs on the tensor cores for the whole tile:
//     warp w < BC/16 multiplies candidates 16w..16w+15 with the BQ queries
//     by mma.sync m16n8k32 (s8 x s8 -> s32, BQ/8 n-tiles), and each lane
//     carries 2 candidates x 2 queries per n-tile through the dequantize and
//     the cumulative error band, bit-identical to tiles.stage1_tile (exact
//     integer dot, then elementwise float ops in the same order, no FMA);
//   * the valid pairs still active after it (almost every pair retires at
//     the first checkpoint) are compacted into a list, one warp-wide
//     reservation each, and the list is walked one pair per thread from
//     there on: the later stage-1 blocks (__dp4a over the resident tile),
//     stage 2, the pass test and the duplicate scan.  A pair's arithmetic
//     is the same whoever runs it, and the list's order reaches no output;
//   * a block-wide vote (__syncthreads_or) gates stage 2, and inside it
//     each (BC, Δd) fp slab is fetched (cp.async, in the row dtype) only
//     while some listed pair is still active (tiles.stage2_need); a pair's
//     norms and dot product are summed one dimension at a time, in order,
//     with rounded multiplies and adds (no FMA), the order of the plain
//     version, so distances, decisions and r² agree with it bit for bit;
//   * passing pairs not already in the window (tiles.dup_mask, checked by
//     a warp 32 window entries at a time) are merged by insertion into the
//     sorted (BQ, K) window, one warp per query row, keeping the
//     reference's tie order (window first, then lower column), and
//     r² = min(r², top[thresh_col]) unless the threshold is frozen.
// Counters are kept in 32/64-bit integers and converted to float once at
// the end of a step list, so columns 0 and 2 of stats stay exact past 2^24.
//
// The walk comes in parts: walk_prologue (the query tile, its constants,
// the window, r² and the bitmap row), walk_steps (one step list),
// walk_stats and walk_window (the outputs).  A one-launch kernel calls them
// in sequence (scan_walk); graph_scan.cu's persistent walk calls the
// prologue once and then walk_steps and walk_stats once per wave, on the
// step list it picks in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace dade {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
  long long* clocks;       // (q_tiles, kPhases) cycle sums: timing builds only
};

// The phases of a step that a timing build (kClocks) stamps with clock64():
// thread 0 reads the clock at each boundary (after the phase's barrier) and
// adds the cycles since the last stamp to that phase's sum.
enum Phase {
  kTileWait = 0,   // prefetch issue, then the wait for this step's codes tile
  kStage1 = 1,     // stage 1's first block on the tensor cores and the pair list
  kVotes = 2,      // the list barrier, the later blocks of the listed pairs, the vote
  kSlabWait = 3,   // per checkpoint: the need vote, the slab copy and its wait
  kStage2 = 4,     // per checkpoint: the listed pairs' products and tests
  kDupScan = 5,    // the slab-free barriers, the pass test and the duplicate scan
  kMerge = 6,      // the entrant vote, the window merge and its barrier
  kOther = 7,      // the rest of the step loop (gap steps, bookkeeping)
  kPhases = 8
};

template <bool kOn>
struct PhaseClock {
  long long sum[kPhases];
  long long t;
  __device__ __forceinline__ void start() {
    if constexpr (kOn) {
#pragma unroll
      for (int p = 0; p < kPhases; ++p) sum[p] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void lap(int p) {
    if constexpr (kOn) {
      const long long now = clock64();
      sum[p] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void store(long long* out) const {
    if constexpr (kOn) {
      if (threadIdx.x == 0)
        for (int p = 0; p < kPhases; ++p) out[static_cast<size_t>(blockIdx.x) * kPhases + p] = sum[p];
    }
  }
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of the shared-memory regions (same function on both sides).
// The merge's candidate distances (BQ x BC f32) have a region of their own,
// all inf between merges: the merge resets each entry it reads.
struct Layout {
  size_t codes, tids, qcodes, q, slab, cand, qn1, tqsb, eband, qn2, thr, sb, scl, rsq,
      top_sq, top_ids, ids, pair, pval, pst, npairs, acc, total;
};

template <int BC, int BQ>
__host__ __device__ inline Layout make_layout(int D, int S, int K, int BD, int row_bytes) {
  Layout L;
  size_t o = 0;
  L.codes = o;   o = align16(o + 1ull * BC * (D + 16));
  L.tids = o;    o = align16(o + 4ull * BC);
  L.qcodes = o;  o = align16(o + 1ull * BQ * (D + 16));
  L.q = o;       o = align16(o + 4ull * BQ * D);
  L.slab = o;    o = align16(o + 1ull * BC * (row_bytes * BD + 16));
  L.cand = o;    o = align16(o + 4ull * BQ * BC);
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
  L.ids = o;     o = align16(o + 4ull * BC);
  L.pair = o;    o = align16(o + 2ull * BQ * BC);  // the active-pair list
  L.pval = o;    o = align16(o + 4ull * BQ * BC);
  L.pst = o;     o = align16(o + 1ull * BQ * BC);
  L.npairs = o;  o = align16(o + 4ull * 2);
  L.acc = o;     o = align16(o + 8ull * BQ * 3);
  L.total = o;
  return L;
}

// cp.async a (BC rows x `chunks` 16-byte chunks) block, source rows
// `src_stride` bytes apart, into shared rows `dst_stride` bytes apart; the
// block's threads walk the chunks in order without dividing in the loop.
// The caller commits the group.
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
}

// Issue the copies of codes tile `off` into `dst` (row stride D+16) and of
// its BC ids into `ids_dst`, one group: the walk reads neither from device
// memory in its critical path.
template <int BC>
__device__ __forceinline__ void issue_tile(const WalkArgs& a, int8_t* dst, int* ids_dst,
                                           int off) {
  issue_rows<BC>(reinterpret_cast<unsigned char*>(dst), a.D + 16,
                 reinterpret_cast<const unsigned char*>(a.codes) +
                     static_cast<size_t>(off) * BC * a.D,
                 a.D, a.D / 16);
  if (threadIdx.x < BC / 4)
    cp_async16(ids_dst + 4 * threadIdx.x, a.ids + static_cast<size_t>(off) * BC + 4 * threadIdx.x);
  cp_async_commit();
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
  cp_async_commit();
}

// The 8 (bf16) or 4 (f32) values of the 16-byte chunk at `p`, as floats.
template <bool BF16>
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[BF16 ? 8 : 4]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
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
}

// Stage-2 products of one slab row (a listed pair's candidate) with the
// pair's BD query values: cn = x·x and dot = q·x, each summed in dimension
// order, the two chains interleaved 16 bytes of the row at a time.
template <bool BF16>
__device__ __forceinline__ void slab_dot(const unsigned char* row, const float* qv, int BD,
                                         float& cn, float& dot) {
  constexpr int E = BF16 ? 8 : 4;  // values per 16-byte chunk
#pragma unroll 4
  for (int w = 0; w < BD; w += E) {
    float x[E];
    load_chunk<BF16>(row + w * (BF16 ? 2 : 4), x);
#pragma unroll
    for (int e = 0; e < E; ++e) cn = __fadd_rn(cn, __fmul_rn(x[e], x[e]));
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(qv + w + e);
      dot = __fadd_rn(dot, __fmul_rn(qq.x, x[e]));
      dot = __fadd_rn(dot, __fmul_rn(qq.y, x[e + 1]));
      dot = __fadd_rn(dot, __fmul_rn(qq.z, x[e + 2]));
      dot = __fadd_rn(dot, __fmul_rn(qq.w, x[e + 3]));
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
// <= its distance — the stable order of the reference's min-extract.  The
// candidate row is left all inf for the next merge.
__device__ inline void merge_row(float* wsq, int* wid, float* cand,
                                 const int* ids, int K, int BC, int lane) {
  for (int base = 0; base < BC; base += 32) {
    const int cc = base + lane;
    const float v = cc < BC ? cand[cc] : INFINITY;
    const int id = cc < BC ? ids[cc] : -1;
    if (cc < BC) cand[cc] = INFINITY;
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

// The float tail of one stage-1 block for one (candidate, query) pair:
// ps += block_sq of the dequantized block (integer dot and candidate norm
// exact), then the lower bound's test against (1+ε_s)²r².  Returns whether
// the pair is still active; tiles.stage1_tile's operations, in its order.
__device__ __forceinline__ bool stage1_block(float& ps, int dot, int cn, float sb2,
                                             float tqsb, float qn1, float eband,
                                             float scl, float thr, float rs,
                                             float one_minus_slack) {
  const float cnf = __fmul_rn(static_cast<float>(cn), sb2);
  const float dotf = __fmul_rn(static_cast<float>(dot), tqsb);
  ps = __fadd_rn(ps, block_sq(qn1, cnf, dotf));
  return !(lb_penalized(ps, eband, scl, one_minus_slack) > dade_threshold(thr, rs));
}

// The shared-memory regions of one CTA's walk (make_layout's offsets as
// pointers), and this tile's row of the visited bitmap in device memory.
template <int BC, int BQ>
struct WalkSmem {
  int8_t* tile;            // the resident codes tile
  int* tile_ids;           // and its ids
  int8_t* qcodes;
  float* q;
  unsigned char* slab;
  float* cand;             // inf but for this step's entrants
  float *qn1, *tqsb, *eband, *qn2, *thr, *sb, *scl, *rsq, *top_sq;
  int* top_ids;
  int* ids;
  unsigned short* pair;    // the active-pair list: query << 8 | cand
  float* pval;             // stage-1 psum, then stage-2's
  unsigned char* pst;      // kActive | slabs consumed
  int* npairs;             // list length, by real-step parity
  unsigned long long* acc;
  unsigned* vis_row;       // null without a bitmap
  __device__ __forceinline__ WalkSmem(unsigned char* smem, const WalkArgs& a) {
    const Layout L = make_layout<BC, BQ>(a.D, a.S, a.K, a.BD, a.rows_bf16 ? 2 : 4);
    tile = reinterpret_cast<int8_t*>(smem + L.codes);
    tile_ids = reinterpret_cast<int*>(smem + L.tids);
    qcodes = reinterpret_cast<int8_t*>(smem + L.qcodes);
    q = reinterpret_cast<float*>(smem + L.q);
    slab = smem + L.slab;
    cand = reinterpret_cast<float*>(smem + L.cand);
    qn1 = reinterpret_cast<float*>(smem + L.qn1);
    tqsb = reinterpret_cast<float*>(smem + L.tqsb);
    eband = reinterpret_cast<float*>(smem + L.eband);
    qn2 = reinterpret_cast<float*>(smem + L.qn2);
    thr = reinterpret_cast<float*>(smem + L.thr);
    sb = reinterpret_cast<float*>(smem + L.sb);
    scl = reinterpret_cast<float*>(smem + L.scl);
    rsq = reinterpret_cast<float*>(smem + L.rsq);
    top_sq = reinterpret_cast<float*>(smem + L.top_sq);
    top_ids = reinterpret_cast<int*>(smem + L.top_ids);
    ids = reinterpret_cast<int*>(smem + L.ids);
    pair = reinterpret_cast<unsigned short*>(smem + L.pair);
    pval = reinterpret_cast<float*>(smem + L.pval);
    pst = smem + L.pst;
    npairs = reinterpret_cast<int*>(smem + L.npairs);
    acc = reinterpret_cast<unsigned long long*>(smem + L.acc);
    vis_row = a.vis == nullptr ? nullptr : a.vis + static_cast<size_t>(blockIdx.x) * a.vis_words;
  }
};

// The counters a thread keeps in registers over one walk of a step list:
// first-block int8 dims per query (lane's 8n + qa, 8n + qb of the mma
// layout; the later blocks, stage-2 dims and passes go to acc), tile totals.
template <int BQ>
struct WalkCounters {
  unsigned d8[2 * (BQ / 8)];
  unsigned long long nvalid, slabs, fresh;
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < 2 * (BQ / 8); ++i) d8[i] = 0u;
    nvalid = slabs = fresh = 0ull;
  }
};

// The walk, in three parts a kernel calls in sequence (scan_walk below) or,
// for a walk of many step lists, prologue once, then steps and stats per
// list (csrc/graph_scan.cu's persistent graph walk).
//
// Prologue: the query tile, its per-block constants, the window, r² from
// a.r0, the accumulators, and this tile's bitmap row copied from a.vis0.
template <int BC, int BQ>
__device__ __forceinline__ void walk_prologue(const WalkArgs& a, const WalkSmem<BC, BQ>& ws) {
  const int D = a.D, S = a.S, K = a.K, BD = a.BD;
  const int tid = threadIdx.x;
  const int QS = D + 16;   // query codes row stride: conflict-free fragment reads
  const size_t q0 = static_cast<size_t>(blockIdx.x) * BQ;
  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    ws.qcodes[r * QS + d] = a.qcodes[q0 * D + e];
    ws.q[e] = a.q[q0 * D + e];
  }
  for (int e = tid; e < BQ * K; e += kThreads) {
    ws.top_sq[e] = a.top0_sq[q0 * K + e];
    ws.top_ids[e] = a.top0_ids[q0 * K + e];
  }
  for (int s = tid; s < S; s += kThreads) {
    const float t = __fadd_rn(1.0f, a.eps[s]);
    ws.thr[s] = __fmul_rn(t, t);
    ws.sb[s] = a.bscales[s];
    ws.scl[s] = a.scale[s];
  }
  for (int e = tid; e < BQ * 3; e += kThreads) ws.acc[e] = 0ull;
  for (int e = tid; e < BQ * BC; e += kThreads) ws.cand[e] = INFINITY;
  // The visited bitmap: this tile's row is copied in and then marked in
  // place (one bit per real step); no other CTA touches the row.
  if (ws.vis_row != nullptr) {
    const unsigned* vis0_row = a.vis0 + static_cast<size_t>(blockIdx.x) * a.vis_words;
    for (int w = tid; w < a.vis_words; w += kThreads) ws.vis_row[w] = vis0_row[w];
  }
  __syncthreads();
  if (tid < BQ) {
    const int r = tid;
    ws.rsq[r] = a.r0[q0 + r];
    float ec2 = 0.0f, eq2 = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float t = a.qscales[(q0 + r) * S + s];
      const float sb = ws.sb[s];
      int qn_i = 0;
      float qn2 = 0.0f;
      for (int d = 0; d < BD; ++d) {
        const int v = ws.qcodes[r * QS + s * BD + d];
        qn_i += v * v;
        const float x = ws.q[r * D + s * BD + d];
        qn2 = __fadd_rn(qn2, __fmul_rn(x, x));
      }
      ws.qn1[r * S + s] = __fmul_rn(static_cast<float>(qn_i), __fmul_rn(t, t));
      ws.tqsb[r * S + s] = __fmul_rn(t, sb);
      ws.qn2[r * S + s] = qn2;
      const float hb = __fmul_rn(sb, 0.5f), hq = __fmul_rn(t, 0.5f);
      ec2 = __fadd_rn(ec2, __fmul_rn(static_cast<float>(BD), __fmul_rn(hb, hb)));
      eq2 = __fadd_rn(eq2, __fmul_rn(static_cast<float>(BD), __fmul_rn(hq, hq)));
      ws.eband[r * S + s] = __fadd_rn(sqrtf(ec2), sqrtf(eq2));
    }
  }
  __syncthreads();
}

// Steps: the walk over `steps` tile offsets at `offs` (device or shared
// memory; -1 = gap step), from r² in ws.rsq and the window in shared memory,
// as one launch walks its row of the step table.  The reuse cursor, the
// window's sortedness and the pair list's parity start afresh; the caller
// resets the counters and the acc words between lists.  kClocks: the timing
// build's phase stamps, written to a.clocks.
//
// Almost every pair retires at its first checkpoint, so the first block of
// stage 1 runs for the whole (BQ, BC) tile on the tensor cores, and the
// pairs still active after it are compacted into a list (one entry per
// pair: its query and candidate, a float and a state byte) that the later
// blocks, stage 2, the pass test and the duplicate scan walk one pair per
// thread.  Each pair's arithmetic is the same whoever runs it; the list's
// order (set by shared atomics) reaches no output.
template <int BC, int BQ, bool kClocks = false>
__device__ __forceinline__ void walk_steps(const WalkArgs& a, const WalkSmem<BC, BQ>& ws,
                                           const int* offs, int steps, WalkCounters<BQ>& ctr) {
  static_assert(BC % 32 == 0 && BC <= 16 * kWarps, "BC: 32..128, a multiple of 32");
  static_assert(BQ == 8 || BQ == 16, "BQ: 8 or 16");
  constexpr int kS1Warps = BC / 16;          // warps that run stage 1's first block
  constexpr int kNT = BQ / 8;                // stage-1 n-tiles per warp
  constexpr unsigned char kActive = 0x80;    // list state: still active; low bits: slabs
  const int D = a.D, S = a.S, K = a.K, BD = a.BD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % BC;  // the candidate whose id this thread loads
  // Stage-1 ownership (mma fragment layout, warps < kS1Warps): candidates
  // ca, cb = ca + 8 of warp w's 16, queries 8n + qa and 8n + qb of n-tile n,
  // qa = 2t, qb = 2t + 1.
  const bool s1 = warp < kS1Warps;
  const int fg = lane >> 2, ft = lane & 3;
  const int ca = warp * 16 + fg, cb = ca + 8;
  const int qa = 2 * ft, qb = qa + 1;
  const int CS = D + 16;   // codes row stride: conflict-free fragment reads
  const int QS = D + 16;   // query codes row stride, likewise
  const int slab_row = BD * (a.rows_bf16 ? 2 : 4) + 16;  // slab row stride (bytes)

  // Both list counts start at zero; the first real step is fresh, and its
  // tile wait's barrier orders this before the first reservation.
  if (tid < 2) ws.npairs[tid] = 0;
  bool window_sorted = false;
  int last = -1;  // offset of the last tile whose copy was issued
  int par = 0;    // the real steps' parity: which list count this one uses
  // The step table is read two steps ahead, so its loads stay out of the
  // step's chain of dependent phases.
  int noff = steps > 0 ? offs[0] : -1;
  int nnoff = steps > 1 ? offs[1] : -1;

  if (noff >= 0) issue_tile<BC>(a, ws.tile, ws.tile_ids, noff);
  PhaseClock<kClocks> clk;
  clk.start();

  for (int step = 0; step < steps; ++step) {
    clk.lap(kOther);
    const int off = noff;
    noff = nnoff;
    nnoff = step + 2 < steps ? offs[step + 2] : -1;
    const bool real = off >= 0;
    const bool fresh = real && off != last;
    const int resident = real ? off : last;
    if (fresh) {
      cp_async_wait<0>();
      __syncthreads();
    }
    clk.lap(kTileWait);
    last = resident;
    // The next fresh tile is issued once this step has no more use for the
    // buffer (and no slab copy will wait behind it).
    bool pending = noff >= 0 && noff != resident;
    if (pending && !real) {
      issue_tile<BC>(a, ws.tile, ws.tile_ids, noff);
      pending = false;
    }
    if (!real) continue;

    if (ws.vis_row != nullptr && tid == 0) {
      const unsigned gnode = static_cast<unsigned>(off + a.vis_base);
      ws.vis_row[gnode >> 5] |= 1u << (gnode & 31u);
    }
    const bool valid_c = ws.tile_ids[c] >= 0;
    if (tid < BC) ws.ids[tid] = ws.tile_ids[tid];
    int* npairs = ws.npairs + par;

    // ---- stage 1, first block: the whole tile on the tensor cores ----
    // Pair p of n-tile n: candidate (p < 2 ? ca : cb), query 8n + (p odd ?
    // qb : qa), the mma accumulator order.  Its active valid pairs join the
    // list, with their psum.
    if (s1) {
      const bool va = ws.tile_ids[ca] >= 0, vb = ws.tile_ids[cb] >= 0;
      int dot[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int p = 0; p < 4; ++p) dot[n][p] = 0;
      int cna = 0, cnb = 0;
      for (int kk = 4 * ft; kk < BD; kk += 32) {
        const int a0 = *reinterpret_cast<const int*>(ws.tile + ca * CS + kk);
        const int a1 = *reinterpret_cast<const int*>(ws.tile + cb * CS + kk);
        const int a2 = *reinterpret_cast<const int*>(ws.tile + ca * CS + kk + 16);
        const int a3 = *reinterpret_cast<const int*>(ws.tile + cb * CS + kk + 16);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int8_t* qrow = ws.qcodes + (8 * n + fg) * QS + kk;
          mma_s8(dot[n], a0, a1, a2, a3, *reinterpret_cast<const int*>(qrow),
                 *reinterpret_cast<const int*>(qrow + 16));
        }
        cna = __dp4a(a0, a0, __dp4a(a2, a2, cna));
        cnb = __dp4a(a1, a1, __dp4a(a3, a3, cnb));
      }
      // Row norms: the four lanes of a quad hold a row's 32-dim slices.
      cna += __shfl_xor_sync(kFull, cna, 1);
      cna += __shfl_xor_sync(kFull, cna, 2);
      cnb += __shfl_xor_sync(kFull, cnb, 1);
      cnb += __shfl_xor_sync(kFull, cnb, 2);
      const float sb2 = __fmul_rn(ws.sb[0], ws.sb[0]);
      float ps[kNT][4];
      unsigned m[kNT][4];
      int total = 0;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        ctr.d8[2 * n] += BD * (va + vb);
        ctr.d8[2 * n + 1] += BD * (va + vb);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int r = 8 * n + ((p & 1) ? qb : qa);
          ps[n][p] = 0.0f;
          const bool act =
              stage1_block(ps[n][p], dot[n][p], p < 2 ? cna : cnb, sb2, ws.tqsb[r * S],
                           ws.qn1[r * S], ws.eband[r * S], ws.scl[0], ws.thr[0], ws.rsq[r],
                           a.one_minus_slack) &&
              (p < 2 ? va : vb);
          m[n][p] = __ballot_sync(kFull, act);
          total += __popc(m[n][p]);
        }
      }
      // One list reservation per warp, then each pair's slot by prefix count.
      int base = 0;
      if (lane == 0 && total) base = atomicAdd(npairs, total);
      base = __shfl_sync(kFull, base, 0);
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if ((m[n][p] >> lane) & 1u) {
            const int i = base + __popc(m[n][p] & below);
            ws.pair[i] = static_cast<unsigned short>((8 * n + ((p & 1) ? qb : qa)) << 8 |
                                                    (p < 2 ? ca : cb));
            ws.pval[i] = ps[n][p];
          }
          base += __popc(m[n][p]);
        }
      }
    }
    clk.lap(kStage1);
    ctr.nvalid += __syncthreads_count(tid < BC && valid_c);
    ctr.fresh += fresh ? 1 : 0;
    // The list is complete; the other count (last read right after the
    // previous real step's barrier here) is reset for the next real step.
    const int n_pairs = *npairs;
    if (tid == 0) ws.npairs[par ^ 1] = 0;
    par ^= 1;

    // ---- stage 1, later blocks: the listed pairs, one per thread ----
    bool mine = false;
    for (int i = tid; i < n_pairs; i += kThreads) {
      const int r = ws.pair[i] >> 8, cc = ws.pair[i] & 0xff;
      const float rs = ws.rsq[r];  // frozen for this tile
      float ps = ws.pval[i];
      bool act = true;
      unsigned d8 = 0;
      const int8_t* crow = ws.tile + cc * CS;
      const int8_t* qrow = ws.qcodes + r * QS;
      for (int s = 1; s < S && act; ++s) {
        int dot = 0, cn = 0;
#pragma unroll 4
        for (int k = s * BD; k < (s + 1) * BD; k += 16) {
          const int4 cv = *reinterpret_cast<const int4*>(crow + k);
          const int4 qv = *reinterpret_cast<const int4*>(qrow + k);
          dot = __dp4a(cv.x, qv.x, __dp4a(cv.y, qv.y, __dp4a(cv.z, qv.z, __dp4a(cv.w, qv.w, dot))));
          cn = __dp4a(cv.x, cv.x, __dp4a(cv.y, cv.y, __dp4a(cv.z, cv.z, __dp4a(cv.w, cv.w, cn))));
        }
        d8 += BD;
        const float sb = ws.sb[s];
        act = stage1_block(ps, dot, cn, __fmul_rn(sb, sb), ws.tqsb[r * S + s],
                           ws.qn1[r * S + s], ws.eband[r * S + s], ws.scl[s], ws.thr[s], rs,
                           a.one_minus_slack);
      }
      if (d8) atomicAdd(&ws.acc[r * 3 + 0], static_cast<unsigned long long>(d8));
      ws.pst[i] = act ? kActive : 0;
      mine = mine || act;
    }
    // Every thread is past its last read of this codes buffer here, and
    // the list's states are visible.
    const bool alive = __syncthreads_or(mine) != 0;
    clk.lap(kVotes);
    if (pending && !alive) {
      issue_tile<BC>(a, ws.tile, ws.tile_ids, noff);
      pending = false;
    }

    if (alive) {
      // ---- stage 2: demand-paged fp re-screen (tiles.stage2_tile) ----
      for (int s = 0; s < S; ++s) {
        bool need = false;
        for (int i = tid; i < n_pairs; i += kThreads) need = need || (ws.pst[i] & kActive);
        // Once no valid candidate is active none ever is again: every
        // later slab is skipped too, and nothing read past here matters.
        const bool any_need = __syncthreads_or(need) != 0;
        clk.lap(kSlabWait);
        if (!any_need) break;
        issue_slab<BC>(a, ws.slab, off, s);
        cp_async_wait<0>();
        __syncthreads();
        clk.lap(kSlabWait);
        ++ctr.slabs;
        for (int i = tid; i < n_pairs; i += kThreads) {
          const unsigned char st = ws.pst[i];
          if (!(st & kActive)) continue;
          const int r = ws.pair[i] >> 8, cc = ws.pair[i] & 0xff;
          const unsigned char* row = ws.slab + cc * slab_row;
          const float* qv = ws.q + r * D + s * BD;
          float cn2 = 0.0f, dt = 0.0f;
          if (a.rows_bf16)
            slab_dot<true>(row, qv, BD, cn2, dt);
          else
            slab_dot<false>(row, qv, BD, cn2, dt);
          const float p2 = __fadd_rn(s == 0 ? 0.0f : ws.pval[i], block_sq(ws.qn2[r * S + s], cn2, dt));
          ws.pval[i] = p2;
          const bool rej = s != S - 1 && __fmul_rn(p2, ws.scl[s]) > dade_threshold(ws.thr[s], ws.rsq[r]);
          ws.pst[i] = static_cast<unsigned char>((rej ? 0 : kActive) | ((st & 0x7f) + 1));
        }
        clk.lap(kStage2);
      }
      if (pending) {
        issue_tile<BC>(a, ws.tile, ws.tile_ids, noff);
        pending = false;
      }
      // ---- pass test and dup mask against the window before this merge ----
      // A warp checks its passing pairs one at a time, 32 window entries of
      // the pair's query row per round.
      bool enter = false;
      for (int i0 = 0; i0 < n_pairs; i0 += kThreads) {
        const int i = i0 + tid;
        bool ok = false;
        int r = 0, cc = 0;
        float p2 = 0.0f;
        if (i < n_pairs) {
          const unsigned char st = ws.pst[i];
          r = ws.pair[i] >> 8;
          cc = ws.pair[i] & 0xff;
          if (st & 0x7f)
            atomicAdd(&ws.acc[r * 3 + 1], static_cast<unsigned long long>((st & 0x7f) * BD));
          p2 = ws.pval[i];
          ok = (st & kActive) && p2 <= ws.rsq[r];
          if (ok) atomicAdd(&ws.acc[r * 3 + 2], 1ull);
        }
        bool dup = false;
        for (unsigned m = __ballot_sync(kFull, ok); m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const int rr = __shfl_sync(kFull, r, src);
          const int id = ws.ids[__shfl_sync(kFull, cc, src)];
          bool hit = false;
          for (int kk = lane; kk < K; kk += 32) hit = hit || ws.top_ids[rr * K + kk] == id;
          hit = __any_sync(kFull, hit);
          if (lane == src) dup = hit;
        }
        if (ok && !dup) {
          ws.cand[r * BC + cc] = p2;
          enter = true;
        }
      }
      clk.lap(kDupScan);
      // ---- merge into the window, then r² = min(r², top[thresh_col]) ----
      // After the first merge the window is sorted, its empty slots carry
      // id -1 and r² <= top[thresh_col] (or r² is frozen), so a merge with
      // no entrant changes nothing and is skipped.
      if (__syncthreads_or(enter) || !window_sorted) {
        for (int r = warp; r < BQ; r += kWarps) {  // one warp per query row
          float* wsq = ws.top_sq + r * K;
          int* wid = ws.top_ids + r * K;
          if (!window_sorted) {
            if (lane == 0) sort_row(wsq, wid, K);
            __syncwarp();
          }
          merge_row(wsq, wid, ws.cand + r * BC, ws.ids, K, BC, lane);
          if (lane == 0 && a.tighten) ws.rsq[r] = fminf(ws.rsq[r], wsq[a.thresh_col]);
        }
        window_sorted = true;
        __syncthreads();
      }
      clk.lap(kMerge);
    }
  }
  clk.lap(kOther);
  clk.store(a.clocks);
}

// Stats: the counters of the step lists walked since the last reset, as
// (BQ, 6) float rows of this tile at `stats` ((Q, 6) rows, this tile's from
// row blockIdx.x * BQ).
template <int BC, int BQ>
__device__ __forceinline__ void walk_stats(const WalkArgs& a, const WalkSmem<BC, BQ>& ws,
                                           const WalkCounters<BQ>& ctr, float* stats) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qa = 2 * (lane & 3), qb = qa + 1;
  if (warp < BC / 16) {
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      atomicAdd(&ws.acc[(8 * n + qa) * 3 + 0], static_cast<unsigned long long>(ctr.d8[2 * n]));
      atomicAdd(&ws.acc[(8 * n + qb) * 3 + 0], static_cast<unsigned long long>(ctr.d8[2 * n + 1]));
    }
  }
  __syncthreads();
  if (tid < BQ) {
    float* o = stats + (static_cast<size_t>(blockIdx.x) * BQ + tid) * 6;
    o[0] = static_cast<float>(ws.acc[tid * 3 + 0]);
    o[1] = static_cast<float>(ws.acc[tid * 3 + 1]);
    o[2] = static_cast<float>(ctr.nvalid);
    o[3] = static_cast<float>(ws.acc[tid * 3 + 2]);
    o[4] = static_cast<float>(ctr.slabs);
    o[5] = static_cast<float>(ctr.fresh);
  }
}

// The window in shared memory -> a.top_sq / a.top_ids.
template <int BC, int BQ>
__device__ __forceinline__ void walk_window(const WalkArgs& a, const WalkSmem<BC, BQ>& ws) {
  const size_t q0 = static_cast<size_t>(blockIdx.x) * BQ;
  for (int e = threadIdx.x; e < BQ * a.K; e += kThreads) {
    a.top_sq[q0 * a.K + e] = ws.top_sq[e];
    a.top_ids[q0 * a.K + e] = ws.top_ids[e];
  }
}

// The walk of query tile blockIdx.x over its row of a.offs: the body of
// both one-launch kernels (launched with kThreads threads and
// make_layout<BC, BQ> bytes of dynamic shared memory).  kClocks builds the
// timing variant, which also writes each phase's cycles to a.clocks.
template <int BC, int BQ, bool kClocks = false>
__device__ __forceinline__ void scan_walk(const WalkArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WalkSmem<BC, BQ> ws(smem, a);
  walk_prologue<BC, BQ>(a, ws);
  WalkCounters<BQ> ctr;
  ctr.reset();
  walk_steps<BC, BQ, kClocks>(a, ws, a.offs + static_cast<size_t>(blockIdx.x) * a.steps,
                              a.steps, ctr);
  walk_stats<BC, BQ>(a, ws, ctr, a.stats);
  walk_window<BC, BQ>(a, ws);
}

// Launch kernel `fn` (a scan_walk<BC, BQ> instantiation) over q_tiles CTAs
// on `stream`; returns the cudaError_t of the attribute call or the launch.
template <int BC, int BQ>
inline int launch_walk(void (*fn)(WalkArgs), int device, const WalkArgs& a,
                       int q_tiles, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_tiles <= 0) return 0;
  const size_t smem = make_layout<BC, BQ>(a.D, a.S, a.K, a.BD, a.rows_bf16 ? 2 : 4).total;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<q_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dade
