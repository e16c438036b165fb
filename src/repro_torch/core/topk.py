"""Wave-synchronous K-NN over the batched DCO engine, and brute-force
ground truth (port of ``repro.core.topk``).

The corpus is consumed in fixed-size waves; within a wave the threshold r
(the current K-th best) is frozen, between waves the survivors merge into
the running top-K.  Freezing r within a wave can only admit extra
candidates, so recall is >= the paper's per-candidate semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.dco import dco_screen_batch
from repro_torch.core.transforms import as_tensor

__all__ = ["KnnResult", "knn_search_waves", "exact_knn", "merge_topk",
           "seed_threshold", "pad_waves"]

_SENTINEL = 1e18  # pad row value: finite, so masked matmuls stay NaN-free


class KnnResult(NamedTuple):
    dists: torch.Tensor  # (Q, K) exact distances, ascending
    ids: torch.Tensor  # (Q, K) corpus row ids (int32), -1 for unfilled
    avg_dims: torch.Tensor  # scalar: mean dimensions scanned per candidate


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries per row, ties to the lower
    column (``lax.top_k``'s order on the negated values)."""
    return torch.sort(x, dim=1, stable=True).indices[:, :k]


def merge_topk(top_sq, top_ids, new_sq, new_ids):
    """Merge wave survivors (Q, W) (inf where invalid) into the running
    top-K (Q, K), ascending."""
    k = top_sq.shape[1]
    all_sq = torch.cat([top_sq, new_sq], dim=1)
    all_ids = torch.cat([top_ids, new_ids], dim=1)
    idx = _smallest(all_sq, k)
    return torch.gather(all_sq, 1, idx), torch.gather(all_ids, 1, idx)


def exact_knn(queries, corpus, k: int, *, chunk: int = 1 << 16,
              device: str | torch.device = "cuda"):
    """(Q, K) exact distances and int64 row ids, ascending.

    ``qn + cn - 2 q·cᵀ`` in float32 over row chunks of the corpus, with a
    running top-K merge, so the (Q, N) distance matrix never exists whole.
    """
    dev = resolve_device(device)
    q = as_tensor(queries, dev)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    best_sq = torch.full((q.shape[0], 0), float("inf"), device=dev)
    best_ids = torch.zeros((q.shape[0], 0), dtype=torch.long, device=dev)
    n = corpus.shape[0]
    for lo in range(0, n, chunk):
        c = as_tensor(corpus[lo:lo + chunk], dev)
        sq = qn + torch.sum(c * c, dim=1)[None, :] - 2.0 * (q @ c.T)
        kk = min(k, sq.shape[1])
        part_sq, part_ids = torch.topk(sq, kk, dim=1, largest=False)
        all_sq = torch.cat([best_sq, part_sq], dim=1)
        all_ids = torch.cat([best_ids, part_ids + lo], dim=1)
        best_sq, sel = torch.topk(all_sq, min(k, all_sq.shape[1]), dim=1,
                                  largest=False)
        best_ids = torch.gather(all_ids, 1, sel)
    return torch.sqrt(torch.clamp_min(best_sq, 0.0)), best_ids


def seed_threshold(q_rot: torch.Tensor, corpus_rot: torch.Tensor,
                   table: EpsilonTable, k: int) -> torch.Tensor:
    """Two-phase search, phase 1: (Q,) squared-threshold seeds.

    The K rows with the smallest first-checkpoint estimates are verified
    exactly (full D); the K-th exact distance of any K rows bounds the
    global K-th from above, and widening it by ``(1+eps_1)²`` admits a
    true neighbour whose own first estimate overshoots.
    """
    d0 = int(table.dims[0])
    m = (torch.arange(q_rot.shape[1], device=q_rot.device) < d0).to(q_rot.dtype)
    qm = q_rot * m[None, :]
    cm = corpus_rot * m[None, :]
    sq = (torch.sum(qm * qm, dim=1)[:, None] + torch.sum(cm * cm, dim=1)[None, :]
          - 2.0 * qm @ cm.T)
    est_sq = torch.clamp_min(sq, 0.0) * table.scale[0]
    idx = _smallest(est_sq, k)  # (Q, K) candidate rows by estimate
    cand = corpus_rot[idx.reshape(-1)].reshape(idx.shape[0], idx.shape[1], -1)
    diff = cand - q_rot[:, None, :]
    kth = torch.amax(torch.sum((diff * diff).float(), dim=-1), dim=1)
    t = 1.0 + table.eps[0]
    return kth * (t * t)


def pad_waves(x: torch.Tensor, wave: int, value) -> torch.Tensor:
    """``x`` (N, D) padded with ``value`` rows to a multiple of ``wave``."""
    rem = (-x.shape[0]) % wave
    if rem == 0:
        return x
    return torch.cat([x, torch.full((rem, x.shape[1]), value, dtype=x.dtype,
                                    device=x.device)])


def knn_search_waves(queries_rot: torch.Tensor, corpus_rot: torch.Tensor,
                     table: EpsilonTable, *, k: int, wave: int = 4096,
                     two_phase: bool = False) -> KnnResult:
    """Linear-scan K-NN with DCO screening (the paper's Fig. 3 workload).
    ``avg_dims`` is the mean dims consumed per (query, row), pad rows
    included, as in the reference (summed in float64, which stays exact
    where the reference's float32 sum would round past 2^24)."""
    qn = queries_rot.shape[0]
    dev = queries_rot.device
    corpus_rot = pad_waves(corpus_rot, wave, _SENTINEL)
    n = corpus_rot.shape[0]
    if two_phase:
        r_sq = seed_threshold(queries_rot, corpus_rot, table, k)
    else:
        r_sq = torch.full((qn,), float("inf"), device=dev)
    top_sq = torch.full((qn, k), float("inf"), device=dev)
    top_ids = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    dims_acc = torch.zeros((), dtype=torch.float64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for base in range(0, n, wave):
        res = dco_screen_batch(queries_rot, corpus_rot[base:base + wave], table, r_sq)
        ids = torch.arange(base, base + wave, dtype=torch.int32, device=dev)
        new_sq = torch.where(res.passed, res.est_sq, inf)
        top_sq, top_ids = merge_topk(top_sq, top_ids, new_sq,
                                     ids[None, :].expand(qn, wave))
        r_sq = torch.minimum(r_sq, top_sq[:, -1])
        dims_acc = dims_acc + torch.sum(res.dims_used.double())
    return KnnResult(dists=torch.sqrt(torch.clamp_min(top_sq, 0.0)), ids=top_ids,
                     avg_dims=(dims_acc / (qn * n)).float())
