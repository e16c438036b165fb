// Fused graph beam-scan wave for Hopper (sm_90a): one launch screens one
// frontier wave of the batched graph walk for every query tile.
//
// Replaces: the Pallas TPU kernel repro/kernels/graph_scan.py
// (graph_scan_kernel_call, body _kernel), whose sequential step axis
// carried the seeded beam window, r² and the packed visited bitmap in VMEM
// scratch.
//
// Design.  One CTA (256 threads, 8 warps) owns one query tile of 8 queries
// and walks that tile's row of the (q_tiles, steps) table, where step s
// names the node whose neighbour block (adjacency-flat tile `off`, 32 rows:
// the degree m rounded up to 32) the tile expands, or -1 for nothing.  The
// walk is scan_walk<32, 8> of scan_walk.cuh, the one the IVF scan runs at
// 128 rows, so the two share tile paging with the reuse cursor, the
// mma.sync m16n8k32 first stage-1 block, the list of pairs it leaves
// active (later blocks, stage 2, pass test and duplicate scan one pair per
// thread), the vote-gated slab paging and the insertion merge.  At 32 rows
// a tile is two m16 fragments: warps 0-1 run the first block, and all 8
// warps merge, one per query row of the seeded (8, EF) window.  What the
// graph adds:
//   * r² tightens to the window's thresh_col entry after a merge (k-1: the
//     paper's decoupled HNSW++ threshold), or stays at r0 for the whole
//     launch when tighten = 0 (the sharded, frozen-threshold wave);
//   * the visited bitmap: the CTA copies its row of vis0 (vis_words 32-bit
//     words) to vis in device memory and thread 0 sets bit
//     vis_base + off for every real step, as unsigned words (bit 31
//     included).  One CTA owns one row, so no atomics are needed, and at
//     2^20 nodes the row (128 KB) would not fit shared memory anyway.
// Pad rows of a block (id -1, _SENTINEL 1e18 values) are masked by id,
// never by distance.
//
// What bounds it on this card (an H100 SXM; NVIDIA's published dense peaks
// at its 700 W limit).  A wave of 128 query tiles x 16 steps moves at most
// 2,048 int8 tiles of 32 x 256 B plus their ids and the fp slabs stage 2
// asks for: ~20-40 MB, some 10 us at 3.35 TB/s, and far fewer operations
// than the card does in that time.  Bytes bound it, but each CTA walks its
// 16 steps as a chain of dependent phases (tile wait, stage 1, votes, one
// slab round trip per checkpoint, merge) with one CTA per SM, so latency
// sets the kernel's time, and the launch and the host's frontier selection
// between waves set the route's; more query tiles per CTA, overlapping
// waves and TMA are later work.
#include "scan_walk.cuh"

namespace {

constexpr int kBC = 32;  // candidates per tile: one node's neighbour block
constexpr int kBQ = 8;   // queries per tile: the mma's n

__global__ void __launch_bounds__(dade::kThreads, 1) graph_scan_kernel(const dade::WalkArgs a) {
  dade::scan_walk<kBC, kBQ>(a);
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

}  // extern "C"
