"""The paper's serving workload on one card: the int8 fused flat route of
``repro.launch.annservice.build_search_step``, and the graph route of
``build_graph_engine``.

The corpus (rotated into the PCA basis at ingest) lives on the card as
rows (bf16 or f32) plus per-block int8 codes.  One search step seeds each
query's threshold from an exact-verified sample (two-phase search), then
runs the whole corpus through the fused wave-scan kernel as
``corpus // wave`` waves of ``wave // 128`` candidate tiles: int8 stage 1,
demand-paged fp stage 2, and the running top-K / r² kept on the card
between waves.  With one card there is no cross-shard merge.

The graph route serves a batch through ``index.graph.search_graph_fused``:
one ``graph_scan`` launch per frontier wave, the host selecting the next
frontier between waves.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core.estimators import SEED_SLACK, first_enabled_eps
from repro_torch.index.graph import search_graph_fused
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.quant.scalar import quantize_queries_block

__all__ = ["build_search_step", "build_graph_engine", "seed_rsq",
           "fused_scan_inputs", "FUSED_BLOCK_C", "FUSED_BLOCK_Q"]

# Query-tile rows and candidate-tile rows of the fused route (the kernel's
# tile); serve.py's fetch report normalizes its per-wave figures with
# FUSED_BLOCK_C.
FUSED_BLOCK_Q, FUSED_BLOCK_C = KERNEL_TILE


def seed_rsq(svc: ServiceConfig, corpus, queries, eps):
    """Two-phase threshold seed: first-block estimates over the first wave
    pick k candidates per query, verified exactly; the k-th exact distance
    bounds the final k-th from above.  Runs in float32 on the upcast rows,
    the arithmetic the kernel uses."""
    k, block_d = svc.k, svc.delta_d
    sample = corpus[: svc.wave].float()
    q = queries.float()
    qb = q[:, :block_d]
    cb = sample[:, :block_d]
    est0 = (torch.sum(qb * qb, 1)[:, None] + torch.sum(cb * cb, 1)[None, :]
            - 2.0 * (qb @ cb.T))
    idx = torch.topk(est0, k, dim=1, largest=False).indices
    diff = sample[idx] - q[:, None, :]
    kth = torch.amax(torch.sum(diff * diff, dim=-1), dim=1)
    # Widen by the first ENABLED checkpoint's overshoot band; SEED_SLACK
    # keeps the zero-widening case sound under float reassociation.
    t = 1.0 + first_enabled_eps(eps)
    return kth * (t * t) * (1.0 + SEED_SLACK)


def fused_scan_inputs(svc: ServiceConfig, corpus, codes, bscales, queries,
                      eps, scale, r0):
    """(args, kwargs) of the kernel call one search step makes: every query
    tile walks every candidate tile of the corpus, wave by wave."""
    n_local = corpus.shape[0]
    q = queries.shape[0]
    dev = corpus.device
    if svc.wave % FUSED_BLOCK_C or n_local % svc.wave:
        raise ValueError("fused scan needs wave % 128 == 0 and "
                         "corpus rows % wave == 0")
    if q % FUSED_BLOCK_Q:
        raise ValueError(f"query_batch {q} % block_q {FUSED_BLOCK_Q} != 0")
    qf = queries.float()
    qcodes, qscales = quantize_queries_block(qf, svc.delta_d)
    num_waves = n_local // svc.wave
    cap_tiles = svc.wave // FUSED_BLOCK_C
    tiles = torch.arange(num_waves * cap_tiles, dtype=torch.int32, device=dev)
    offs = tiles.reshape(1, num_waves, cap_tiles).expand(q // FUSED_BLOCK_Q, -1, -1)
    args = (offs, qcodes, qf, qscales, r0,
            torch.full((q, svc.k), float("inf"), device=dev),
            torch.full((q, svc.k), -1, dtype=torch.int32, device=dev),
            codes, corpus, torch.arange(n_local, dtype=torch.int32, device=dev),
            bscales, eps, scale)
    kwargs = dict(k=svc.k, block_q=FUSED_BLOCK_Q, block_c=FUSED_BLOCK_C,
                  block_d=svc.delta_d, cap_tiles=cap_tiles)
    return args, kwargs


def build_search_step(svc: ServiceConfig, *, with_stats: bool = False):
    """Returns ``step(corpus, codes, bscales, queries, eps, scale, eps_lo)
    -> (dists, ids[, scan])`` for the int8 fused route.

    ``corpus`` (N, D) rotated rows (bf16 or f32), ``codes`` (N, D) int8
    per-block codes, ``bscales`` (S,), ``queries`` (Q, D) rotated, and the
    blocked table.  The step runs on the tensors' device.  ``with_stats``
    appends a (6,) float64 vector of the kernel's scan counters summed over
    queries (the tile-level fetch counters 4-5 counted once per tile).
    """

    def step(corpus, codes, bscales, queries, eps, scale, eps_lo):
        del eps_lo  # the fused route widens from eps alone
        r0 = seed_rsq(svc, corpus, queries, eps)
        args, kwargs = fused_scan_inputs(svc, corpus, codes, bscales, queries,
                                         eps, scale, r0)
        top_sq, top_ids, stats = ivf_scan_kernel_call(*args, **kwargs)
        dists = torch.sqrt(torch.clamp_min(top_sq, 0.0))
        if not with_stats:
            return dists, top_ids
        st = stats.double()
        scan = torch.cat([st[:, :4].sum(0), st[::FUSED_BLOCK_Q, 4:].sum(0)])
        return dists, top_ids, scan

    return step


def build_graph_engine(index, *, k: int, ef: int = 48, expand: int = 2,
                       device: str | torch.device = "cuda"):
    """Serving engine of the graph route: ``step(batch_np) -> (dists, ids,
    GraphScanStats)``, numpy results of ``search_graph_fused`` over the
    whole index on ``device`` (the index's), in query tiles of 8 (the CUDA
    kernel's, and the reference's off-TPU default).  The step's batch
    shape is free; the scheduler fixes it."""
    resolve_device(device)

    def step(batch_np):
        d, i, st = search_graph_fused(index, batch_np, k=k, ef=ef,
                                      expand=expand, device=device)
        return d.cpu().numpy(), i.cpu().numpy(), st

    return step
