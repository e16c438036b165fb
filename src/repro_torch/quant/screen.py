"""Two-stage DCO screen: int8 lower-bound prefilter + fp32 DADE re-screen
(port of the tensor functions of ``repro.quant.screen``).

Stage 1 walks the same checkpoint schedule as ``core.dco`` over int8 codes
and tests the lower bound of the scaled partial distance,

    lb(d) = max(0, ||q - o'||_d - E(d))^2 · (1 - slack)      (o' dequantized)
    retire at checkpoint s  iff  lb(d_s) · scale_s > (1+eps_s)^2 r^2,

which never exceeds the true partial distance (``quant.scalar``), so a row
stage 1 retires would also be retired by the fp32 screen: no false prunes.
Stage 2 re-screens the survivors exactly, so ``passed`` equals
``dco_screen_batch``'s.  ``dims_used`` counts fp32 dims (0 for
stage-1-pruned rows), ``lb_dims`` int8 dims.  These functions compute both
stages in full; the flat int8 kernel (``kernels.ops.quant_screen_kernel``)
skips the work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.dco import block_partial_sq, dco_screen_batch, first_reject
from repro_torch.core.dco_host import dco_screen_host
from repro_torch.core.topk import KnnResult, merge_topk, pad_waves
from repro_torch.quant.accounting import two_stage_bytes
from repro_torch.quant.scalar import (
    DEFAULT_SLACK, QuantizedCorpus, cum_err_sq, lower_bound_sq,
)

__all__ = ["Stage1Result", "QuantScreenResult", "quant_lb_screen",
           "two_stage_screen", "bytes_scanned", "QuantSearchStats",
           "knn_search_waves_quant", "HostQuantResult", "two_stage_screen_host",
           "knn_search_quant_host"]


class Stage1Result(NamedTuple):
    """lb_sq (Q, C) scaled lower bound at retirement (or at the final
    checkpoint for survivors), pruned (Q, C) bool definite rejects, lb_dims
    (Q, C) int32 int8 dims consumed."""

    lb_sq: torch.Tensor
    pruned: torch.Tensor
    lb_dims: torch.Tensor


class QuantScreenResult(NamedTuple):
    """Two-stage outcome: est_sq/passed as ``dco_screen_batch`` (the lower
    bound where stage 1 pruned); dims_used counts fp32 dims only."""

    est_sq: torch.Tensor
    passed: torch.Tensor
    dims_used: torch.Tensor
    stage1_pruned: torch.Tensor
    lb_dims: torch.Tensor


def quant_lb_screen(q_rot: torch.Tensor, qc: QuantizedCorpus, table: EpsilonTable,
                    r_sq: torch.Tensor, *, slack: float = DEFAULT_SLACK) -> Stage1Result:
    """Stage 1: the blockwise int8 lower-bound screen, batched."""
    csq = block_partial_sq(q_rot.float(), qc.dequantize(), table.dims)  # (S, Q, C)
    ecum_sq = cum_err_sq(qc.scales, table.dims)  # (S,)
    est_lb = lower_bound_sq(csq, ecum_sq[:, None, None], slack=slack) * table.scale[:, None, None]
    t = 1.0 + table.eps[:, None, None]
    # Rejecting at the last checkpoint is sound too: lb <= exact.
    first = first_reject(est_lb > t * t * r_sq.float()[None, :, None])
    s_count = table.dims.shape[0]
    pruned = first < s_count
    retire_s = torch.where(pruned, first, s_count - 1)
    lb_sq = torch.gather(est_lb, 0, retire_s.unsqueeze(0))[0]
    return Stage1Result(lb_sq=lb_sq, pruned=pruned, lb_dims=table.dims[retire_s])


def two_stage_screen(q_rot: torch.Tensor, cands_rot: torch.Tensor, qc: QuantizedCorpus,
                     table: EpsilonTable, r_sq: torch.Tensor, *,
                     slack: float = DEFAULT_SLACK) -> QuantScreenResult:
    """Quantized prefilter + exact fp32 re-screen of the survivors;
    ``passed`` equals ``dco_screen_batch(q_rot, cands_rot, table, r_sq)``'s."""
    s1 = quant_lb_screen(q_rot, qc, table, r_sq, slack=slack)
    full = dco_screen_batch(q_rot, cands_rot, table, r_sq)
    return QuantScreenResult(
        est_sq=torch.where(s1.pruned, s1.lb_sq, full.est_sq),
        passed=full.passed & ~s1.pruned,  # == full.passed (soundness)
        dims_used=torch.where(s1.pruned, 0, full.dims_used).to(torch.int32),
        stage1_pruned=s1.pruned,
        lb_dims=s1.lb_dims,
    )


def bytes_scanned(res: QuantScreenResult, *, fp_bytes: int = 4) -> torch.Tensor:
    """Corpus bytes touched per (query, candidate): int8 stage + fp stage."""
    return two_stage_bytes(res.lb_dims.long(), res.dims_used.long(), fp_bytes=fp_bytes)


class QuantSearchStats(NamedTuple):
    lb_dims_total: torch.Tensor  # int8 dims scanned (== bytes at 1 B/dim)
    fp_dims_total: torch.Tensor  # fp32 dims scanned by stage 2


def knn_search_waves_quant(queries_rot: torch.Tensor, corpus_rot: torch.Tensor,
                           qc: QuantizedCorpus, table: EpsilonTable, *, k: int,
                           wave: int = 4096, slack: float = DEFAULT_SLACK):
    """Wave-synchronous K-NN with the two-stage screen.  Returns
    (KnnResult, QuantSearchStats); the results equal
    ``core.topk.knn_search_waves``'s, and ``avg_dims`` counts fp32 dims
    only.  Pad rows carry the 1e18 sentinel in fp32 and zero codes (a
    finite lower bound; the fp32 stage retires them)."""
    qn = queries_rot.shape[0]
    dev = queries_rot.device
    corpus_rot = pad_waves(corpus_rot, wave, 1e18)
    codes = pad_waves(qc.codes, wave, 0)
    n = corpus_rot.shape[0]
    top_sq = torch.full((qn, k), float("inf"), device=dev)
    top_ids = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    r_sq = torch.full((qn,), float("inf"), device=dev)
    fp_acc = torch.zeros((), dtype=torch.float64, device=dev)
    lb_acc = torch.zeros((), dtype=torch.float64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for base in range(0, n, wave):
        res = two_stage_screen(
            queries_rot, corpus_rot[base:base + wave],
            QuantizedCorpus(codes[base:base + wave], qc.scales), table, r_sq,
            slack=slack)
        ids = torch.arange(base, base + wave, dtype=torch.int32, device=dev)
        new_sq = torch.where(res.passed, res.est_sq, inf)
        top_sq, top_ids = merge_topk(top_sq, top_ids, new_sq,
                                     ids[None, :].expand(qn, wave))
        r_sq = torch.minimum(r_sq, top_sq[:, -1])
        fp_acc = fp_acc + torch.sum(res.dims_used.double())
        lb_acc = lb_acc + torch.sum(res.lb_dims.double())
    result = KnnResult(dists=torch.sqrt(torch.clamp_min(top_sq, 0.0)), ids=top_ids,
                       avg_dims=(fp_acc / (qn * n)).float())
    return result, QuantSearchStats(lb_dims_total=lb_acc, fp_dims_total=fp_acc)


# ---------------------------------------------------------------------------
# Host (numpy) engines with actual work skipping and byte accounting
# ---------------------------------------------------------------------------


class HostQuantResult(NamedTuple):
    est_sq: np.ndarray
    passed: np.ndarray
    dims_used: np.ndarray  # fp32 dims (0 for stage-1-pruned rows)
    lb_dims: np.ndarray  # int8 dims
    bytes_scanned: int  # lb_dims * 1 + fp dims * 4, summed


def _cum_err(scales: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """E(d) at each checkpoint, float32, as ``scalar.cum_err_sq`` sums it."""
    h = np.asarray(scales, np.float32) * np.float32(0.5)
    return np.sqrt(np.cumsum(h * h, dtype=np.float32)[np.asarray(dims) - 1])


def two_stage_screen_host(q_rot: np.ndarray, codes: np.ndarray, scales: np.ndarray,
                          rows_fp: np.ndarray, dims: np.ndarray, eps: np.ndarray,
                          scale: np.ndarray, r_sq: float, *,
                          slack: float = DEFAULT_SLACK) -> HostQuantResult:
    """One query's two-stage screen with candidate-set compaction."""
    c = codes.shape[0]
    est_sq = np.zeros((c,), np.float32)
    lb_dims = np.zeros((c,), np.int32)
    s_count = len(dims)
    ecum = _cum_err(scales, dims)
    active_idx = np.arange(c)
    psum = np.zeros((c,), np.float32)
    int8_dims_read = 0
    prev_d = 0
    for s in range(s_count):
        d = int(dims[s])
        blk = codes[active_idx, prev_d:d].astype(np.float32) * scales[prev_d:d] - q_rot[prev_d:d]
        psum[active_idx] += np.einsum("cd,cd->c", blk, blk)
        int8_dims_read += blk.size  # one int8 code per dim read
        lb = np.maximum(np.sqrt(np.maximum(psum[active_idx], 0.0)) - ecum[s], 0.0) ** 2
        lb *= (1.0 - slack) * float(scale[s])
        thresh = (1.0 + float(eps[s])) ** 2 * r_sq
        reject = lb > thresh
        retired = active_idx[reject]
        est_sq[retired] = lb[reject]
        lb_dims[retired] = d
        active_idx = active_idx[~reject]
        if active_idx.size == 0:
            break
        prev_d = d
    lb_dims[active_idx] = int(dims[-1])
    passed = np.zeros((c,), bool)
    dims_used = np.zeros((c,), np.int32)
    if active_idx.size:
        ref = dco_screen_host(q_rot, rows_fp[active_idx], dims, eps, scale, r_sq)
        est_sq[active_idx] = ref.est_sq
        passed[active_idx] = ref.passed
        dims_used[active_idx] = ref.dims_used
    return HostQuantResult(
        est_sq=est_sq, passed=passed, dims_used=dims_used, lb_dims=lb_dims,
        bytes_scanned=int(two_stage_bytes(int8_dims_read, int(dims_used.sum()))))


def knn_search_quant_host(q_rot: np.ndarray, codes: np.ndarray, scales: np.ndarray,
                          corpus_rot: np.ndarray, k: int, dims: np.ndarray,
                          eps: np.ndarray, scale: np.ndarray,
                          wave: int = 4096) -> tuple[np.ndarray, np.ndarray, dict]:
    """Two-stage wave K-NN for one query; mirrors
    ``core.dco_host.knn_search_host``.  Returns (ids, dists, stats)."""
    n = corpus_rot.shape[0]
    top_ids = np.full((k,), -1, np.int64)
    top_sq = np.full((k,), np.inf, np.float32)
    r_sq = np.inf
    bytes_total = fp_dims_total = lb_dims_total = 0
    for start in range(0, n, wave):
        stop = min(start + wave, n)
        res = two_stage_screen_host(q_rot, codes[start:stop], scales,
                                    corpus_rot[start:stop], dims, eps, scale, r_sq)
        bytes_total += res.bytes_scanned
        fp_dims_total += int(res.dims_used.sum())
        lb_dims_total += int(res.lb_dims.sum())
        surv = np.nonzero(res.passed)[0]
        if surv.size:
            cand_sq = np.concatenate([top_sq, res.est_sq[surv]])
            cand_id = np.concatenate([top_ids, surv + start])
            order = np.argsort(cand_sq, kind="stable")[:k]
            top_sq = cand_sq[order]
            top_ids = cand_id[order]
            r_sq = float(top_sq[-1])
    stats = {"bytes_scanned": bytes_total, "fp_dims": fp_dims_total,
             "lb_dims": lb_dims_total, "avg_fp_dims": fp_dims_total / n}
    return top_ids, np.sqrt(top_sq), stats
