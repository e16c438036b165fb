"""Flat (linear scan) index — the paper's Fig. 3 workload and the recall
ground-truth provider (port of ``repro.index.flat``): a stateful wrapper
over ``core.topk`` and ``quant.screen``."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.core.estimators import Estimator, build_estimator
from repro_torch.core.topk import KnnResult, exact_knn, knn_search_waves
from repro_torch.core.transforms import as_tensor
from repro_torch.quant.scalar import QuantizedCorpus, quantize_corpus, wants_quant
from repro_torch.quant.screen import knn_search_waves_quant

__all__ = ["FlatIndex", "build_flat", "search_flat", "ground_truth"]


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    estimator: Estimator
    corpus_rot: torch.Tensor  # (N, D)
    corpus: torch.Tensor  # (N, D) original space (exact ground truth)
    # Optional int8 mirror of corpus_rot (per-dimension scales).
    corpus_q: torch.Tensor | None = None  # (N, D) int8
    qscales: torch.Tensor | None = None  # (D,)

    @property
    def has_quant(self) -> bool:
        return self.corpus_q is not None

    @property
    def device(self) -> torch.device:
        return self.corpus_rot.device


def build_flat(data, *, method: str = "dade", generator: torch.Generator | None = None,
               estimator: Estimator | None = None, quant: str | None = None,
               device: str | torch.device = "cuda", **est_kwargs) -> FlatIndex:
    """Fit the estimator (unless given), rotate the corpus (row by row, as a
    mutable index rotates its upserts: ``OrthogonalTransform.apply_rows``)
    and, with ``quant="int8"`` or an estimator that carries a policy, store
    its per-dimension int8 mirror."""
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    if estimator is None:
        estimator = build_estimator(method, x, generator, quant=quant, device=dev,
                                    **est_kwargs)
    rot = estimator.transform.apply_rows(x)
    corpus_q = qscales = None
    if wants_quant(quant, estimator.quant):
        qc = quantize_corpus(rot)
        corpus_q, qscales = qc.codes, qc.scales
    return FlatIndex(estimator=estimator, corpus_rot=rot, corpus=x,
                     corpus_q=corpus_q, qscales=qscales)


def search_flat(index: FlatIndex, queries, *, k: int = 10, wave: int = 4096,
                two_phase: bool = False, use_quant: bool = False) -> KnnResult:
    """Flat-scan K-NN on the index's device.  ``use_quant`` routes waves
    through the two-stage screen (identical results; avg_dims counts only
    fp32 dims)."""
    q_rot = index.estimator.rotate(as_tensor(queries, index.device))
    if use_quant:
        if not index.has_quant:
            raise ValueError("search_flat(use_quant=True) needs build_flat(quant='int8')")
        result, _ = knn_search_waves_quant(
            q_rot, index.corpus_rot, QuantizedCorpus(index.corpus_q, index.qscales),
            index.estimator.table, k=k, wave=wave)
        return result
    return knn_search_waves(q_rot, index.corpus_rot, index.estimator.table, k=k,
                            wave=wave, two_phase=two_phase)


def ground_truth(index: FlatIndex, queries, k: int):
    """Exact (Q, K) distances and row ids over the original corpus."""
    return exact_knn(queries, index.corpus, k, device=index.device)
