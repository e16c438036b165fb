"""Brute-force K-NN ground truth (port of ``repro.core.topk.exact_knn``)."""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.transforms import as_tensor

__all__ = ["exact_knn"]


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
