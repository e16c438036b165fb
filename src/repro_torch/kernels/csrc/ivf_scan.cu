// Fused IVF wave scan for Hopper (sm_90a): int8 stage-1 prefilter, a
// demand-paged fp32/bf16 DADE re-screen, and an on-chip top-K.
//
// Replaces: the Pallas TPU kernel repro/kernels/ivf_scan.py
// (ivf_scan_kernel_call, body _kernel), whose sequential (probe, tile) grid
// axes carried the top-K window and r² in VMEM scratch.
//
// Design.  One CTA (256 threads, 8 warps) owns one query tile of 8 or 16
// queries and walks that tile's row of the step table of 128-row
// candidate tiles in order, so the window, r² and the reuse cursor live in
// shared memory for the whole walk; CTAs never talk.  The walk is
// scan_walk<128, BQ> of scan_walk.cuh, which the graph beam scan shares:
// stage 1's first block runs on the tensor cores for the whole tile, and
// the pairs it leaves active (a few in a thousand) go on as a list, one
// pair per thread, through the later blocks, stage 2 and the merge.  The
// wrapper may cut the step table into segments, each walked by its own CTA
// from the same r0 with an empty window, and merge their windows after the
// launch (the reference's shards); the flat serving route walks 16-query
// tiles in 4 segments: 256 CTAs, two to an SM (one shared-memory buffer of
// int8 codes each: a second bought no time, here or on the IVF search or
// the graph walk).
//
// What bounds it on this card (an H100 SXM; rates are NVIDIA's published
// dense peaks at its 700 W limit).  At the serving shape (Q = 1024
// queries, N = 2^20 rows, D = 256) stage 1 at full depth would be
// 2·Q·N·D = 5.5e11 int8 operations (0.28 ms at 1,979 TOP/s), but a pair
// retires at the first checkpoint that rejects it, and the dims the data
// actually consumes cost less than moving the bytes: the 256 MB int8
// corpus read once (80 us at 3.35 TB/s) plus the bf16 slabs a query tile
// needs.  Bytes bound it, yet a step is a chain of short dependent phases
// behind block barriers, so latency sets the time.  The timing build
// (ivf_scan_clocks.cu) stamps the phases.  The dense walk this design
// replaced (every thread screening its share of all 8 x 128 pairs at every
// step, one walk per 8-query tile, 128 CTAs, one to an SM; stamped alike by
// scripts/dense_walk_clocks.py) took ~14,800 cycles a step, stage 1 and
// stage 2's products about 31 % and 32 % of it, although almost all pairs
// had retired at the first checkpoint; the pair list cut those, and
// 16-query tiles in 4 segments put two CTAs on each SM and four times the
// chains in flight.  What is left is spread over the
// phases: the slab round trips (~21 %), stage 2 (~18 %), the duplicate
// scan and merge of the many entrants an empty window takes (~27 %),
// stage 1 (~26 %).
#include "scan_walk.cuh"

// 1 in the timing build (ivf_scan_clocks.cu), which stamps each phase of a
// step with clock64(); the served library has no timing code.
#ifndef IVF_SCAN_CLOCKS
#define IVF_SCAN_CLOCKS 0
#endif

namespace {

constexpr int kBC = 128;  // candidates per tile: 16 per warp, the mma's m

// At most 128 registers a thread, so two CTAs can share an SM when their
// shared memory allows it.
template <int BQ>
__global__ void __launch_bounds__(dade::kThreads, 2)
    ivf_scan_kernel(const dade::WalkArgs a) {
  dade::scan_walk<kBC, BQ, IVF_SCAN_CLOCKS != 0>(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at these shapes (bytes), or -1 for a
// query-tile width the library does not hold.
long long ivf_scan_smem_bytes(int D, int S, int K, int BD, int row_bytes, int block_q) {
  switch (block_q) {
    case 8: return static_cast<long long>(
        dade::make_layout<kBC, 8>(D, S, K, BD, row_bytes).total);
    case 16: return static_cast<long long>(
        dade::make_layout<kBC, 16>(D, S, K, BD, row_bytes).total);
    default: return -1;
  }
}

// Launch the scan on `stream` (query tiles of block_q = 8 or 16, candidate
// tiles of 128); returns the cudaError_t of the launch.  `clocks` ((q_tiles, 8)
// int64) receives the phase cycles in the timing build and must be null in
// the served one.
int ivf_scan_launch(int device, const int* offs, const int8_t* qcodes,
                    const float* q, const float* qscales, const float* r0,
                    const float* top0_sq, const int* top0_ids,
                    const int8_t* codes, const void* rows, int rows_bf16,
                    const int* ids, const float* bscales, const float* eps,
                    const float* scale, float* top_sq, int* top_ids,
                    float* stats, long long* clocks, int q_tiles, int steps,
                    int D, int K, int BD, int block_q, float one_minus_slack,
                    void* stream) {
  if ((clocks != nullptr) != (IVF_SCAN_CLOCKS != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dade::WalkArgs a{offs, qcodes, q, qscales, r0, top0_sq, top0_ids,
                         codes, rows, ids, bscales, eps, scale, top_sq,
                         top_ids, stats, /*vis0=*/nullptr, /*vis=*/nullptr,
                         steps, D, D / BD, K, BD, rows_bf16,
                         /*thresh_col=*/K - 1, /*tighten=*/1,
                         /*vis_words=*/0, /*vis_base=*/0, one_minus_slack,
                         clocks};
  switch (block_q) {
    case 8: return dade::launch_walk<kBC, 8>(ivf_scan_kernel<8>, device, a, q_tiles, stream);
    case 16: return dade::launch_walk<kBC, 16>(ivf_scan_kernel<16>, device, a, q_tiles, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
