// Fused IVF wave scan for Hopper (sm_90a): int8 stage-1 prefilter, a
// demand-paged fp32/bf16 DADE re-screen, and an on-chip top-K.
//
// Replaces: the Pallas TPU kernel repro/kernels/ivf_scan.py
// (ivf_scan_kernel_call, body _kernel), whose sequential (probe, tile) grid
// axes carried the top-K window and r² in VMEM scratch.
//
// Design.  One CTA (256 threads, 8 warps) owns one query tile of 8 queries
// and walks that tile's P x T step table of 128-row candidate tiles in
// order, so the window, r² and the reuse cursor live in shared memory for
// the whole walk; CTAs of different query tiles never talk.  The walk is
// scan_walk<128> of scan_walk.cuh, which the graph beam scan shares: 8
// warps of 16 candidates run stage 1 on the tensor cores, each thread owns
// one candidate and 4 queries in stage 2, and r² tightens to the window's
// K-th entry after every merge.
//
// What bounds it on this card (an H100 SXM; rates are NVIDIA's published
// dense peaks at its 700 W limit).  At the serving shape (Q = 1024
// queries, N = 2^20 rows, D = 256) stage 1 at full depth would be
// 2·Q·N·D = 5.5e11 int8 operations (0.28 ms at 1,979 TOP/s), but a pair
// retires at the first checkpoint that rejects it, and the dims the data
// actually consumes cost less than moving the bytes: the 256 MB int8
// corpus read once (80 us at 3.35 TB/s) plus the bf16 slabs a query tile
// needs.  Bytes bound it.  The design moves few bytes per step (the next
// int8 tile prefetched while this one is screened, fp slabs only on
// demand), but each of the 128 CTAs re-reads the whole corpus (mostly
// from L2), and each of its 8192 steps is a short chain of dependent
// phases behind block barriers (tile wait, stage 1, votes, one slab round
// trip per checkpoint, merge), so latency, not bandwidth, dominates;
// splitting the probe axis across CTAs and overlapping steps are the
// later work.
#include "scan_walk.cuh"

namespace {

constexpr int kBC = 128;  // candidates per tile: 16 per warp, the mma's m

__global__ void __launch_bounds__(dade::kThreads) ivf_scan_kernel(const dade::WalkArgs a) {
  dade::scan_walk<kBC>(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at these shapes (bytes).
long long ivf_scan_smem_bytes(int D, int S, int K, int BD) {
  return static_cast<long long>(dade::make_layout<kBC>(D, S, K, BD).total);
}

// Launch the scan on `stream` (query tiles of 8, candidate tiles of 128);
// returns the cudaError_t of the launch.
int ivf_scan_launch(int device, const int* offs, const int8_t* qcodes,
                    const float* q, const float* qscales, const float* r0,
                    const float* top0_sq, const int* top0_ids,
                    const int8_t* codes, const void* rows, int rows_bf16,
                    const int* ids, const float* bscales, const float* eps,
                    const float* scale, float* top_sq, int* top_ids,
                    float* stats, int q_tiles, int steps, int D, int K, int BD,
                    float one_minus_slack, void* stream) {
  const dade::WalkArgs a{offs, qcodes, q, qscales, r0, top0_sq, top0_ids,
                         codes, rows, ids, bscales, eps, scale, top_sq,
                         top_ids, stats, /*vis0=*/nullptr, /*vis=*/nullptr,
                         steps, D, D / BD, K, BD, rows_bf16,
                         /*thresh_col=*/K - 1, /*tighten=*/1,
                         /*vis_words=*/0, /*vis_base=*/0, one_minus_slack};
  return dade::launch_walk<kBC>(ivf_scan_kernel, device, a, q_tiles, stream);
}

}  // extern "C"
