// Fused graph beam scan for Hopper (sm_90a): the single-shard walk of a
// whole search in one launch (graph_walk_kernel), and one frontier wave of
// the batched graph walk for every query tile (graph_scan_kernel, the
// per-wave kernel a sharded walk needs).
//
// Replaces: the Pallas TPU kernel repro/kernels/graph_scan.py
// (graph_scan_kernel_call, body _kernel), whose sequential step axis
// carried the seeded beam window, r² and the packed visited bitmap in VMEM
// scratch, launched once per wave by repro/index/graph.py's wave loop with
// the next frontier picked on the host (_select_wave) between launches.
//
// Design.  One CTA (256 threads, 8 warps) owns one query tile of 8 queries.
// A wave walks a list of steps, where step s names the node whose neighbour
// block (adjacency-flat tile `off`, 32 rows: the degree m rounded up to 32)
// the tile expands, or -1 for nothing.  The walk is scan_walk.cuh's at
// BC = 32, the one the IVF scan runs at 128 rows, so the two share tile
// paging with the reuse cursor, the mma.sync m16n8k32 first stage-1 block,
// the list of pairs it leaves active (later blocks, stage 2, pass test and
// duplicate scan one pair per thread), the vote-gated slab paging and the
// insertion merge.  At 32 rows a tile is two m16 fragments: warps 0-1 run
// the first block, and all 8 warps merge, one per query row of the seeded
// (8, EF) window.  What the graph adds:
//   * r² tightens to the window's thresh_col entry after a merge (k-1: the
//     paper's decoupled HNSW++ threshold), or stays at r0 for the whole
//     wave when tighten = 0 (the sharded, frozen-threshold wave);
//   * the visited bitmap: the CTA copies its row of vis0 (vis_words 32-bit
//     words) to vis in device memory and thread 0 sets bit
//     vis_base + off for every real step, as unsigned words (bit 31
//     included).  One CTA owns one row, so no atomics are needed, and at
//     2^20 nodes the row (128 KB) would not fit shared memory anyway.
// Pad rows of a block (id -1, _SENTINEL 1e18 values) are masked by id,
// never by distance.
//
// The walk kernel.  A tile's walk is independent of every other tile's: its
// window, r², bitmap row and frontier are its own.  So its CTA runs every
// wave of the search: it loads the tile's queries, constants and window
// once, and per wave w < max_waves sets r² = min(seed, window[thresh_col])
// per query, picks the frontier itself and walks it.  Wave 0 is the entry
// point alone.  Later, warp r takes query r (pad rows pick nothing): its
// lanes test 32 window entries at a time against the gate r²·route_mult and
// the bitmap row, and two ballots give the first stop (an id < 0, a
// non-finite entry, one past the gate) and the unexpanded entries before
// it, of which the first `expand` are the query's picks; thread 0 then
// merges the 8 warps' picks in query order, dropping nodes already listed,
// into the wave's step list in shared memory.  These are the picks of the
// reference's _select_wave, in its order.  An empty list ends the tile's
// walk (nothing of its state changes after it, so every later list would
// be empty too).  Each wave's counters go to their own (8, 6) stats rows,
// zero after the tile's last wave, so the host sums each wave's rows as a
// launch per wave did.  The host's share of a search is its prologue and
// one readback.
//
// What bounds it on this card (an H100 SXM; NVIDIA's published dense peaks
// at its 700 W limit).  A search of 1024 queries (128 tiles) over ~25
// waves of up to 16 steps moves at most some 50,000 int8 tiles of 32 x
// 256 B plus their ids and the fp slabs stage 2 asks for, a few hundred MB
// at most, some 0.1 ms at 3.35 TB/s, and far fewer operations than the
// card does in that time.  Bytes bound it, but each CTA walks its steps as
// a chain of dependent phases (tile wait, stage 1, votes, one slab round
// trip per checkpoint, merge) with one CTA per SM, so latency sets the
// kernel's time; more query tiles per CTA and TMA are later work.
#include "scan_walk.cuh"

namespace {

constexpr int kBC = 32;  // candidates per tile: one node's neighbour block
constexpr int kBQ = 8;   // queries per tile: the mma's n

constexpr int kMaxExpand = 16;  // picks per query and wave

__global__ void __launch_bounds__(dade::kThreads, 1) graph_scan_kernel(const dade::WalkArgs a) {
  dade::scan_walk<kBC, kBQ>(a);
}

// The walk's arguments beyond the shared walk's: a.r0 is the threshold
// floor (inf: none, 0: pad rows), a.stats the (max_waves, Q, 6) per-wave
// rows, a.offs unused.
struct GraphWalkArgs {
  dade::WalkArgs a;
  int* waves;      // (q_tiles,) waves each tile ran
  int qn;          // real query rows; rows from qn on are padding
  int entry;       // wave 0's one step
  int expand;      // picks per query and wave, <= kMaxExpand
  int max_waves;
  float route_mult;
};

__global__ void __launch_bounds__(dade::kThreads, 1) graph_walk_kernel(const GraphWalkArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list_s[kBQ * kMaxExpand];   // the wave's steps
  __shared__ int picks_s[kBQ * kMaxExpand];  // each query's picks, in window order
  __shared__ int npick_s[kBQ];
  __shared__ int nlist_s;
  const dade::WalkArgs& a = g.a;
  const dade::WalkSmem<kBC, kBQ> ws(smem, a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K;
  const size_t q0 = static_cast<size_t>(blockIdx.x) * kBQ;
  const size_t qp = static_cast<size_t>(gridDim.x) * kBQ;
  dade::walk_prologue<kBC, kBQ>(a, ws);
  dade::WalkCounters<kBQ> ctr;
  ctr.reset();
  int wave = 0;
  for (; wave < g.max_waves; ++wave) {
    // The window, r² and the last wave's marks are settled (the prologue's
    // or the last wave's closing barrier).
    if (tid < kBQ) ws.rsq[tid] = fminf(a.r0[q0 + tid], ws.top_sq[tid * K + a.thresh_col]);
    __syncthreads();
    if (wave == 0) {
      // Bootstrap: the entry point is expanded unconditionally.
      if (tid == 0) {
        list_s[0] = g.entry;
        nlist_s = 1;
      }
    } else {
      for (int r = warp; r < kBQ; r += dade::kWarps) {
        int got = 0;
        if (q0 + r < static_cast<size_t>(g.qn)) {
          const float gate = __fmul_rn(ws.rsq[r], g.route_mult);
          const float* wsq = ws.top_sq + r * K;
          const int* wid = ws.top_ids + r * K;
          for (int base = 0; base < K && got < g.expand; base += 32) {
            const int j = base + lane;
            bool stop = true, open = false;
            int v = -1;
            if (j < K) {
              const float d = wsq[j];
              v = wid[j];
              stop = v < 0 || !isfinite(d) || d > gate;
              if (!stop) open = ((ws.vis_row[v >> 5] >> (v & 31)) & 1u) == 0u;
            }
            const unsigned stops = __ballot_sync(dade::kFull, stop);
            unsigned opens = __ballot_sync(dade::kFull, open);
            if (stops) opens &= (1u << (__ffs(stops) - 1)) - 1u;
            while (opens && got < g.expand) {
              const int src = __ffs(opens) - 1;
              opens &= opens - 1;
              const int id = __shfl_sync(dade::kFull, v, src);
              if (lane == 0) picks_s[r * kMaxExpand + got] = id;
              ++got;
            }
            if (stops) break;
          }
        }
        if (lane == 0) npick_s[r] = got;
      }
      __syncthreads();
      if (tid == 0) {
        int n = 0;
        for (int r = 0; r < kBQ; ++r)
          for (int i = 0; i < npick_s[r]; ++i) {
            const int v = picks_s[r * kMaxExpand + i];
            bool listed = false;
            for (int j = 0; j < n; ++j) listed = listed || list_s[j] == v;
            if (!listed) list_s[n++] = v;
          }
        nlist_s = n;
      }
    }
    __syncthreads();
    const int steps = nlist_s;
    if (steps == 0) break;  // converged: no later list can be non-empty
    dade::walk_steps<kBC, kBQ>(a, ws, list_s, steps, ctr);
    dade::walk_stats<kBC, kBQ>(a, ws, ctr, a.stats + static_cast<size_t>(wave) * qp * 6);
    // Every read of this wave's counters is done: a fresh launch's zeros.
    __syncthreads();
    for (int e = tid; e < kBQ * 3; e += dade::kThreads) ws.acc[e] = 0ull;
    ctr.reset();
  }
  for (int w = wave; w < g.max_waves; ++w)
    for (int e = tid; e < kBQ * 6; e += dade::kThreads)
      a.stats[(static_cast<size_t>(w) * qp + q0) * 6 + e] = 0.0f;
  dade::walk_window<kBC, kBQ>(a, ws);
  if (tid == 0) g.waves[blockIdx.x] = wave;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at these shapes (bytes).
long long graph_scan_smem_bytes(int D, int S, int K, int BD, int row_bytes) {
  return static_cast<long long>(
      dade::make_layout<kBC, kBQ>(D, S, K, BD, row_bytes).total);
}

// Launch one wave on `stream` (query tiles of 8, neighbour blocks of 32
// rows); returns the cudaError_t of the launch.
int graph_scan_launch(int device, const int* offs, const int8_t* qcodes,
                      const float* q, const float* qscales, const float* r0,
                      const float* top0_sq, const int* top0_ids,
                      const unsigned* vis0, const int8_t* codes,
                      const void* rows, int rows_bf16, const int* ids,
                      const float* bscales, const float* eps,
                      const float* scale, float* top_sq, int* top_ids,
                      float* stats, unsigned* vis, int q_tiles, int steps,
                      int D, int K, int BD, int thresh_col, int tighten,
                      int vis_words, int vis_base, float one_minus_slack,
                      void* stream) {
  const dade::WalkArgs a{offs, qcodes, q, qscales, r0, top0_sq, top0_ids,
                         codes, rows, ids, bscales, eps, scale, top_sq,
                         top_ids, stats, vis0, vis, steps, D, D / BD, K, BD,
                         rows_bf16, thresh_col, tighten, vis_words, vis_base,
                         one_minus_slack, /*clocks=*/nullptr};
  return dade::launch_walk<kBC, kBQ>(graph_scan_kernel, device, a, q_tiles, stream);
}

// Walk a whole single-shard search on `stream` (query tiles of 8,
// neighbour blocks of 32 rows), one CTA per tile; returns the cudaError_t
// of the attribute call or the launch.
int graph_walk_launch(int device, const int8_t* qcodes, const float* q,
                      const float* qscales, const float* seed,
                      const float* top0_sq, const int* top0_ids,
                      const unsigned* vis0, const int8_t* codes,
                      const void* rows, int rows_bf16, const int* ids,
                      const float* bscales, const float* eps,
                      const float* scale, float* top_sq, int* top_ids,
                      float* stats, unsigned* vis, int* waves, int q_tiles,
                      int qn, int D, int K, int BD, int thresh_col,
                      int vis_words, int entry, int expand, int max_waves,
                      float route_mult, float one_minus_slack, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (expand < 1 || expand > kMaxExpand) return static_cast<int>(cudaErrorInvalidValue);
  if (q_tiles <= 0) return 0;
  const GraphWalkArgs g{
      dade::WalkArgs{/*offs=*/nullptr, qcodes, q, qscales, seed, top0_sq, top0_ids,
                     codes, rows, ids, bscales, eps, scale, top_sq, top_ids, stats,
                     vis0, vis, /*steps=*/0, D, D / BD, K, BD, rows_bf16, thresh_col,
                     /*tighten=*/1, vis_words, /*vis_base=*/0, one_minus_slack,
                     /*clocks=*/nullptr},
      waves, qn, entry, expand, max_waves, route_mult};
  const size_t smem = dade::make_layout<kBC, kBQ>(D, D / BD, K, BD, rows_bf16 ? 2 : 4).total;
  err = cudaFuncSetAttribute(graph_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  graph_walk_kernel<<<q_tiles, dade::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
