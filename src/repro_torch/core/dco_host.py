"""Host (numpy) DCO engine with actual work skipping (port of
``repro.core.dco_host``), for CPU wall-clock measurements: the tensor
engine (``core.dco``) computes every dimension whatever the mask, while
this one compacts the active candidate set between checkpoints, so the
bytes touched and the operations spent track ``dims_used`` exactly — the
quantity the paper's C++ implementation saves.  Host engines by design:
numpy, no device.  Semantics equal ``core.dco.dco_screen``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["HostDCOResult", "dco_screen_host", "knn_search_host"]


class HostDCOResult(NamedTuple):
    est_sq: np.ndarray
    passed: np.ndarray
    dims_used: np.ndarray
    flops: int  # multiply-add count actually spent on distance math


def dco_screen_host(q_rot: np.ndarray, cands_rot: np.ndarray, dims: np.ndarray,
                    eps: np.ndarray, scale: np.ndarray, r_sq: float) -> HostDCOResult:
    """Screen C candidates for one query with candidate-set compaction."""
    c = cands_rot.shape[0]
    est_sq = np.zeros((c,), np.float32)
    dims_used = np.zeros((c,), np.int32)
    passed = np.zeros((c,), bool)
    active_idx = np.arange(c)
    psum = np.zeros((c,), np.float32)
    flops = 0
    prev_d = 0
    s_count = len(dims)
    for s in range(s_count):
        d = int(dims[s])
        block = cands_rot[active_idx, prev_d:d] - q_rot[prev_d:d]
        psum[active_idx] += np.einsum("cd,cd->c", block, block)
        flops += 2 * block.size
        est = psum[active_idx] * float(scale[s])
        thresh = (1.0 + float(eps[s])) ** 2 * r_sq
        if s < s_count - 1:
            reject = est > thresh
            retired = active_idx[reject]
            est_sq[retired] = est[reject]
            dims_used[retired] = d
            active_idx = active_idx[~reject]
            if active_idx.size == 0:
                break
        else:
            est_sq[active_idx] = est
            dims_used[active_idx] = d
            passed[active_idx] = est <= r_sq
        prev_d = d
    return HostDCOResult(est_sq=est_sq, passed=passed, dims_used=dims_used, flops=flops)


def knn_search_host(q_rot: np.ndarray, corpus_rot: np.ndarray, k: int, dims: np.ndarray,
                    eps: np.ndarray, scale: np.ndarray, wave: int = 4096,
                    r_seed_sq: float = np.inf) -> tuple[np.ndarray, np.ndarray, dict]:
    """Wave-synchronous exact top-k over a corpus for one query: the
    running k best exact distances, the threshold r their k-th, frozen
    within a wave.  Returns (ids, dists, stats)."""
    n = corpus_rot.shape[0]
    top_ids = np.full((k,), -1, np.int64)
    top_sq = np.full((k,), np.inf, np.float32)
    r_sq = r_seed_sq
    total_flops = 0
    total_dims = 0
    for start in range(0, n, wave):
        stop = min(start + wave, n)
        res = dco_screen_host(q_rot, corpus_rot[start:stop], dims, eps, scale, r_sq)
        total_flops += res.flops
        total_dims += int(res.dims_used.sum())
        surv = np.nonzero(res.passed)[0]
        if surv.size:
            cand_sq = np.concatenate([top_sq, res.est_sq[surv]])
            cand_id = np.concatenate([top_ids, surv + start])
            order = np.argsort(cand_sq, kind="stable")[:k]
            top_sq = cand_sq[order]
            top_ids = cand_id[order]
            r_sq = float(top_sq[-1])
    stats = {"flops": total_flops, "avg_dims": total_dims / n,
             "dims_fraction": total_dims / (n * corpus_rot.shape[1])}
    return top_ids, np.sqrt(top_sq), stats
