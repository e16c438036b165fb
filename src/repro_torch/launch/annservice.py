"""The paper's serving workload on one card: the int8 fused flat route of
``repro.launch.annservice.build_search_step``, and the graph route of
``build_graph_engine``.

The corpus (rotated into the PCA basis at ingest) lives on the card as
rows (bf16 or f32) plus per-block int8 codes.  One search step seeds each
query's threshold from an exact-verified sample (two-phase search), then
(the main path, ``fused``) runs the whole corpus through the fused
wave-scan kernel as
``corpus // wave`` waves of ``wave // 128`` candidate tiles: int8 stage 1,
demand-paged fp stage 2, and the running top-K / r² kept on the card
between waves.  ``shards`` cuts the waves into that many contiguous runs,
each walked from the same seeded r² with an empty window, and merges the
windows as the reference's ``hierarchical_topk`` does across a mesh of as
many shards (``ivf_scan_kernel_call(segments=...)``): one launch, with
``shards`` times as many independent walks to fill the card.  Each segment
seeds from the first wave of its own run and the seeds' minimum starts them
all, the reference's ``pmin`` over its shards' seeds.  The reference's
unfused routes run as plain PyTorch on one card: ``quant=None`` screens
each wave with the block-incremental DADE screen (``local_search``), and
``quant="int8", fused=False`` streams per-dimension int8 codes and refines
a budget of lower-bound-qualified rows exactly (``local_search_quant``; the
budget from ``autotune_refine_budget``).

The graph route serves a batch through ``index.graph.search_graph_fused``:
one launch of the ``graph_walk`` kernel walks every wave of the batch, each
query tile selecting its next frontier on the card.

Continuous batching (``ContinuousGraphEngine``, ``ContinuousIVFEngine``,
driven by ``runtime.scheduler.ContinuousScheduler``): queries join the
wave step mid-walk, each in a ``block_q`` tile of its own, and retire as
they converge; every retired query is bit-identical to the same query
served alone by the batch search.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core.estimators import SEED_SLACK, first_enabled_eps
from repro_torch.core.topk import _smallest, merge_topk
from repro_torch.core.transforms import as_tensor
from repro_torch.distributed import collectives as coll
from repro_torch.index.graph import (
    _graph_sharded_stats, _graph_stats, _prep_wave_state, _select_wave,
    dead_shard_tombstones, frozen_wave_inputs, graph_slab, localize_frontier,
    merge_shard_state, search_graph_fused, search_graph_sharded, shard_graph_nodes,
    shard_launches, slab_rows,
)
from repro_torch.index.ivf import BLOCK_Q, _fused_stats, _quant_seed_rsq, _route_tiles
from repro_torch.kernels import graph_scan, ops
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.launch.mesh import LeadRank, make_mesh, mesh_device_type
from repro_torch.quant.accounting import frontier_exchange_bytes
from repro_torch.obs.trace import current_tracer
from repro_torch.quant.scalar import cum_err_sq, quantize_queries_block
from repro_torch.runtime.chaos import current_chaos

__all__ = ["build_search_step", "build_graph_engine", "seed_rsq",
           "autotune_refine_budget", "mesh_rank", "search_input_specs", "InputSpec",
           "build_sharded_graph_engine", "ShardedGraphEngine", "sharded_graph_engine",
           "graph_shard_worker", "RankedFlatStep", "flat_rank_worker",
           "fused_scan_inputs", "FUSED_BLOCK_C", "FUSED_BLOCK_Q", "SHARDS",
           "slo_signal", "slo_effort", "SLOPolicy", "parse_slo", "RetiredQuery",
           "ContinuousGraphEngine", "ContinuousIVFEngine"]

# Query-tile rows and candidate-tile rows of the fused route (the kernel's
# tile); serve.py's fetch report normalizes its per-wave figures with
# FUSED_BLOCK_C.
FUSED_BLOCK_Q, FUSED_BLOCK_C = KERNEL_TILE
# The flat route's default shard count on one card: four segments of the
# wave scan give 64 query tiles x 4 = 256 CTAs, two to each of an H100's 132
# SMs, the fastest split measured at the serving shape.
SHARDS = 4


def seed_rsq(svc: ServiceConfig, corpus, queries, eps, segments: int = 1, mesh=None):
    """Two-phase threshold seed: first-block estimates over a segment's first
    wave pick k candidates per query, verified exactly; the k-th exact
    distance bounds the final k-th from above.  With ``segments`` G > 1 the
    corpus's waves are walked as G runs of ``ceil(waves / G)`` waves
    (``ivf_scan.split_segments``), and segment g seeds from the first wave of
    its own run, rows ``g * ceil(waves / G) * wave`` onward; the seed is the
    elementwise minimum of the G k-th distances, widened once, as the
    reference's G-shard step takes the ``pmin`` over its shards' seeds.
    Where ``waves % G != 0`` the runs are not the reference's shards (it has
    no such split); the rule is kept, and a segment whose run holds no wave
    adds nothing to the minimum.  With ``mesh`` (each rank holding its own
    rows) the k-th distances are all-reduced with ``MIN`` along every mesh
    dimension before the single widening, the reference's ``pmin`` over its
    devices.  Runs in float32 on the upcast rows, the arithmetic the kernel
    uses."""
    k, block_d, wave = svc.k, svc.delta_d, svc.wave
    n = corpus.shape[0]
    waves = -(-n // wave)
    per = -(-waves // segments)  # waves in each segment's run
    q = queries.float()
    qb = q[:, :block_d]
    kth = None
    for start in range(0, n, per * wave):
        sample = corpus[start: start + wave].float()
        cb = sample[:, :block_d]
        est0 = (torch.sum(qb * qb, 1)[:, None] + torch.sum(cb * cb, 1)[None, :]
                - 2.0 * (qb @ cb.T))
        idx = torch.topk(est0, k, dim=1, largest=False).indices
        diff = sample[idx] - q[:, None, :]
        kth_g = torch.amax(torch.sum(diff * diff, dim=-1), dim=1)
        kth = kth_g if kth is None else torch.minimum(kth, kth_g)
    for d in (mesh.mesh_dim_names if mesh is not None else ()):
        coll.all_reduce(kth, op=dist.ReduceOp.MIN, group=mesh.get_group(d))
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


def autotune_refine_budget(scales, sample_rot, *, k: int, wave: int,
                           num_queries: int = 32, safety: float = 1.5):
    """The per-wave exact-refine budget of the unfused int8 route, from the
    stage-1 band width (numpy, offline; the reference's rule).

    The quantized scan sends to exact refinement every row whose lower
    bound beats the running k-th distance r; the rows that qualify but lose
    lie inside the band d <= r + 2E(D), E(D) the full-dimension error bound.
    So the budget is k plus the expected in-band rows of a wave, measured
    on a corpus sample with its rows as pseudo-queries.  Returns (budget in
    [k, wave], {"band_width": 2E(D), "in_band_frac"})."""
    sample = np.asarray(sample_rot, np.float32)
    n = sample.shape[0]
    scales = np.array(scales.cpu() if isinstance(scales, torch.Tensor) else scales,
                      np.float32)
    e_band = float(torch.sqrt(cum_err_sq(torch.as_tensor(scales), [scales.shape[0]])[0]))
    nq = min(num_queries, n)
    qs = sample[:: max(n // nq, 1)][:nq]
    d = np.sqrt(np.maximum(np.sum(qs * qs, 1)[:, None] + np.sum(sample * sample, 1)[None, :]
                           - 2.0 * qs @ sample.T, 0.0))
    kth = np.partition(d, k, axis=1)[:, k]  # k-th excluding self (d = 0)
    in_band = np.mean(d <= (kth[:, None] + 2.0 * e_band)) - (k + 1) / n
    in_band = max(float(in_band), 0.0)
    budget = int(np.clip(k + np.ceil(in_band * wave * safety), k, wave))
    return budget, {"band_width": 2.0 * e_band, "in_band_frac": in_band}


def mesh_rank(mesh) -> int:
    """The linear index of this rank in ``mesh``, row-major (the last
    dimension fastest): the reference's ``shard_base`` order."""
    lin = 0
    for d, c in enumerate(mesh.get_coordinate()):
        lin = lin * mesh.size(d) + c
    return lin


def build_search_step(svc: ServiceConfig, *, with_stats: bool = False,
                      shards: int | None = None, quant: str | None = "int8",
                      fused: bool = True, mesh=None, timings: dict | None = None):
    """Returns the one-card search step of ``svc``, on its tensors' device.

    The main path (``quant="int8"``, ``fused``): ``step(corpus, codes,
    bscales, queries, eps, scale, eps_lo) -> (dists, ids[, scan])``, with
    ``corpus`` (N, D) rotated rows (bf16 or f32), ``codes`` (N, D) int8
    per-block codes, ``bscales`` (S,), ``queries`` (Q, D) rotated, and the
    blocked table.  ``shards`` is the reference's shard count, run as that
    many segments of one scan (1: the reference's one-device step; default
    ``SHARDS``).  ``with_stats`` appends a (6,) float64 vector of the kernel's scan
    counters summed over queries and shards (the tile-level fetch counters
    4-5 counted once per tile).

    ``mesh`` (a ``DeviceMesh`` of R ranks, every rank calling the step on
    its own ``corpus_per_device`` rows and codes with the same queries) is
    the reference's (R, G/R) mesh step: each rank walks its rows as
    ``shards // R`` segments of one launch, the segments' seeds are
    all-reduced with ``MIN`` across the ranks before the widening
    (:func:`seed_rsq`), the ids are offset by the rank's first row, the
    windows merge over the mesh dimensions in reversed order
    (``collectives.hierarchical_topk``) and the stats are summed: every
    rank returns the whole corpus's results.  ``timings`` (a dict) gathers
    the rank merge's wall ms under ``merge_ms``.  R = 1 is the one-process
    step.

    The unfused routes are the reference's one-device step in plain
    PyTorch (``shards`` must be 1, no stats), each seeded by ``seed_rsq``:
    ``quant="int8", fused=False`` takes per-dimension ``codes`` and
    ``qscales`` (D,) in place of the block codes, and refines
    ``svc.refine_per_wave`` rows a wave (0: 2k); ``quant=None`` is
    ``step(corpus, queries, eps, scale, eps_lo)``.
    """
    k, wave, block_d = svc.k, svc.wave, svc.delta_d
    if quant == "int8" and fused:
        shards = SHARDS if shards is None else shards
        ranks = 1 if mesh is None else mesh.size()
        if shards % ranks:
            raise ValueError(f"{ranks} ranks must divide shards={shards}")
        segments = shards // ranks
        dims = () if mesh is None else tuple(mesh.mesh_dim_names)

        def step(corpus, codes, bscales, queries, eps, scale, eps_lo):
            del eps_lo  # the fused route widens from eps alone
            r0 = seed_rsq(svc, corpus, queries, eps, segments=segments, mesh=mesh)
            args, kwargs = fused_scan_inputs(svc, corpus, codes, bscales, queries,
                                             eps, scale, r0)
            top_sq, top_ids, stats = ivf_scan_kernel_call(*args, segments=segments,
                                                          **kwargs)
            if mesh is not None:
                t0 = _now_ms(corpus.device) if timings is not None else 0.0
                base = mesh_rank(mesh) * corpus.shape[0]
                top_ids = torch.where(top_ids >= 0, top_ids + base, top_ids)
                top_sq, top_ids = coll.hierarchical_topk(top_sq, top_ids, mesh, dims[::-1],
                                                         svc.k)
                if timings is not None:
                    timings["merge_ms"] = (timings.get("merge_ms", 0.0)
                                           + _now_ms(corpus.device) - t0)
            dists = torch.sqrt(torch.clamp_min(top_sq, 0.0))
            if not with_stats:
                return dists, top_ids
            st = stats.double()
            scan = torch.cat([st[:, :4].sum(0), st[::FUSED_BLOCK_Q, 4:].sum(0)])
            for d in dims:
                coll.all_reduce(scan, group=mesh.get_group(d))
            return dists, top_ids, scan

        return step
    if mesh is not None:
        raise ValueError("the unfused routes run on one rank (mesh=None)")
    if shards not in (None, 1) or with_stats:
        raise ValueError("the unfused routes run one shard and report no scan stats")
    refine_per_wave = min(svc.refine_per_wave or 2 * k, wave)

    def start(corpus, queries, eps):
        n_local = corpus.shape[0]
        if n_local % wave:
            raise ValueError(f"corpus rows {n_local} % wave {wave} != 0")
        q = queries.float()
        r_sq = seed_rsq(svc, corpus, queries, eps)
        top_sq = torch.full((q.shape[0], k), float("inf"), device=q.device)
        top_ids = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device)
        return q, r_sq, top_sq, top_ids, n_local // wave

    def local_search(corpus, queries, eps, scale, eps_lo):
        """The block-incremental DADE screen, wave by wave."""
        del eps_lo
        q, r_sq, top_sq, top_ids, num_waves = start(corpus, queries, eps)
        qn, dim = q.shape
        s_steps = dim // block_d
        qn_blk = torch.sum((q * q).reshape(qn, s_steps, block_d), dim=2)  # (Q, S)
        for w in range(num_waves):
            rows = corpus[w * wave: (w + 1) * wave].float()
            cn_blk = torch.sum((rows * rows).reshape(wave, s_steps, block_d), dim=2)
            psum = torch.zeros((qn, wave), device=q.device)
            retired = torch.zeros((qn, wave), dtype=torch.bool, device=q.device)
            for st in range(s_steps):
                sl = slice(st * block_d, (st + 1) * block_d)
                blk = qn_blk[:, st, None] + cn_blk[None, :, st] - 2.0 * (q[:, sl] @ rows[:, sl].T)
                psum = psum + torch.clamp_min(blk, 0.0)
                est = psum * scale[st]
                thresh = (1.0 + eps[st]) ** 2 * r_sq[:, None]
                if st < s_steps - 1:
                    retired = retired | (est > thresh)
            passed = ~retired & (psum <= r_sq[:, None])
            ids = torch.arange(w * wave, (w + 1) * wave, dtype=torch.int32,
                               device=q.device)[None, :].expand(qn, -1)
            new_sq = torch.where(passed, psum, torch.full_like(psum, float("inf")))
            top_sq, top_ids = merge_topk(top_sq, top_ids, new_sq, ids)
            r_sq = torch.minimum(r_sq, top_sq[:, -1])
        return torch.sqrt(torch.clamp_min(top_sq, 0.0)), top_ids

    def local_search_quant(corpus, codes, scales, queries, eps, scale, eps_lo):
        """The int8 wave stream: a full-D lower bound per row, and the best
        ``refine_per_wave`` qualifying rows of each wave refined exactly."""
        del scale, eps_lo
        q, r_sq, top_sq, top_ids, num_waves = start(corpus, queries, eps)
        e_band = torch.sqrt(cum_err_sq(scales, [scales.shape[0]])[0])
        qsq = torch.sum(q * q, dim=1)[:, None]
        for w in range(num_waves):
            sl = slice(w * wave, (w + 1) * wave)
            cf = codes[sl].float() * scales[None, :]
            dstq = torch.clamp_min(qsq + torch.sum(cf * cf, dim=1)[None, :]
                                   - 2.0 * (q @ cf.T), 0.0)
            lb = torch.clamp_min(torch.sqrt(dstq) - e_band, 0.0) ** 2 * (1.0 - 1e-4)
            cand = torch.where(lb <= r_sq[:, None], lb, torch.full_like(lb, float("inf")))
            idx = _smallest(cand, refine_per_wave)  # (Q, R), ties to the lower row
            rows = corpus[sl].float()[idx]  # (Q, R, D)
            exact = torch.sum((rows - q[:, None, :]) ** 2, dim=-1)
            # Over-budget slots hold real rows too: their exact distances
            # merge like any other.
            top_sq, top_ids = merge_topk(top_sq, top_ids, exact,
                                         (w * wave + idx).to(torch.int32))
            r_sq = torch.minimum(r_sq, top_sq[:, -1])
        return torch.sqrt(torch.clamp_min(top_sq, 0.0)), top_ids

    return local_search_quant if quant == "int8" else local_search


def _now_ms(dev) -> float:
    """Wall-clock ms, read once ``dev``'s queue has drained."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() * 1e3


class InputSpec(NamedTuple):
    """One search-step argument over a mesh: its global shape and dtype,
    and its placement on each mesh dimension (``Shard(0)``: row-sharded;
    ``Replicate()``)."""

    shape: tuple
    dtype: torch.dtype
    placements: tuple


def search_input_specs(svc: ServiceConfig, mesh, *, quant: str | None = None,
                       fused: bool = False):
    """The search step's arguments over ``mesh``, as :class:`InputSpec` in
    call order: the corpus rows (and with ``quant="int8"`` their codes)
    row-sharded over every mesh dimension, ``corpus_per_device`` rows a
    rank; the code scales, the queries and the blocked table (eps, scale,
    eps_lo) replicated.  ``fused`` gives the kernel's per-block scales (one
    per Δd block), else one per dimension."""
    from torch.distributed.tensor import Replicate, Shard

    d_pad = -(-svc.dim // svc.delta_d) * svc.delta_d
    s_steps = d_pad // svc.delta_d
    row, rep = (Shard(0),) * mesh.ndim, (Replicate(),) * mesh.ndim
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[svc.dtype]
    corpus = InputSpec((mesh.size() * svc.corpus_per_device, d_pad), dt, row)
    queries = InputSpec((svc.query_batch, d_pad), dt, rep)
    table = (InputSpec((s_steps,), torch.float32, rep),) * 3
    if quant == "int8":
        codes = InputSpec(corpus.shape, torch.int8, row)
        qscales = InputSpec((s_steps,) if fused else (d_pad,), torch.float32, rep)
        return (corpus, codes, qscales, queries, *table)
    if quant not in (None, "none"):
        raise ValueError(f"unknown quant mode: {quant!r}")
    return (corpus, queries, *table)


def build_graph_engine(index, *, k: int, ef: int = 48, expand: int = 2,
                       device: str | torch.device = "cuda"):
    """Serving engine of the graph route: ``step(batch_np) -> (dists, ids,
    GraphScanStats)``, numpy results of ``search_graph_fused`` over the
    whole index on ``device`` (the index's), in query tiles of 8 (the CUDA
    kernel's, and the reference's off-TPU default).  The step's batch
    shape is free; the scheduler fixes it."""
    resolve_device(device)

    def step(batch_np):
        # current_tracer() resolves at call time, so a tracer serve.py
        # installs after the engine is built is seen (NULL_TRACER: no-op).
        with current_tracer().span("engine.step", route="graph", batch=len(batch_np)):
            d, i, st = search_graph_fused(index, batch_np, k=k, ef=ef,
                                          expand=expand, device=device)
            return d.cpu().numpy(), i.cpu().numpy(), st

    return step


# ---------------------------------------------------------------------------
# Corpus-sharded graph serving over a process group
# ---------------------------------------------------------------------------

# What rank 0 broadcasts to the other ranks of a sharded engine, as the
# first word of a fixed-size int64 header.
_STOP, _BATCH, _WAVE = 0, 1, 2
_HEADER_WORDS = 8


def _header(dev, words=None) -> list:
    """Broadcast rank 0's header (``words``; None on the receiving ranks)."""
    h = torch.zeros((_HEADER_WORDS,), dtype=torch.int64, device=dev)
    if words is not None:
        h[: len(words)] = torch.as_tensor(words, dtype=torch.int64)
    return [int(x) for x in coll.broadcast(h).cpu()]


def _bcast(x: torch.Tensor) -> torch.Tensor:
    return coll.broadcast(x.contiguous())


class _ShardWave:
    """One rank's part of a sharded wave: its slab, the batch's launch
    inputs, and the walk state (window, bitmap) every rank carries.

    :meth:`wave` launches the one-wave kernel over the rank's slab
    (``vis_base`` its first node, the threshold frozen), all-gathers the
    ranks' windows, bitmaps and stats over ``group``, and merges them as
    the host-simulated walk does (``merge_shard_windows``, the bitmaps
    OR-ed): every rank ends the wave with the same window and bitmap.
    Every rank screens as ``serve``'s walk does (decoupled: threshold
    column ``k - 1``; the kernel's query tile), which the engine's
    ``search_graph_sharded`` defaults match.  ``record`` keeps a sha256 of
    each wave's merged state (the check that the ranks agree); ``timed``
    sums the kernel's ms (CUDA events) and the all-gather's wall ms."""

    def __init__(self, slab, *, group, k: int, ef: int, record: bool = False,
                 timed: bool = False):
        self.slab, self.group = slab, group
        self.ef, self.thresh_col, self.block_q = ef, k - 1, graph_scan.KERNEL_TILE[0]
        self.record, self.timed = record, timed
        self.digests: list[str] = []
        self.kernel_ms = self.gather_ms = 0.0
        self.waves = 0
        self._events: list = []

    def begin(self, q_sorted, top_sq, top_ids, vis) -> None:
        sl = self.slab
        self.inputs = frozen_wave_inputs(
            sl.estimator, q_sorted, top_sq, top_ids, vis,
            (sl.adj_rot, sl.adj_codes, sl.adj_ids), sl.gscales, base=sl.base,
            n_nodes=sl.n_nodes, ef=self.ef, thresh_col=self.thresh_col,
            block_q=self.block_q, block_c=sl.adj_block, block_d=sl.scan_block_d)
        self.top_sq, self.top_ids, self.vis = top_sq, top_ids, vis

    def wave(self, offs: torch.Tensor, r0: torch.Tensor):
        sl, dev = self.slab, self.top_sq.device
        timed = self.timed and dev.type == "cuda"
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        local = shard_launches(graph_scan.graph_scan_kernel_call,
                               [(offs, (sl.adj_rot, sl.adj_codes, sl.adj_ids), sl.base)],
                               self.inputs, self.top_sq, self.top_ids, r0, self.vis)
        if timed:
            ev[1].record()
            self._events.append(ev)
        t0 = _now_ms(dev) if self.timed else 0.0
        g_sq, g_ids, g_st, g_vis = (coll.all_gather(t[0], self.group) for t in local)
        if self.timed:
            self.gather_ms += _now_ms(dev) - t0
        m_sq, m_ids, m_vis = merge_shard_state(g_sq, g_ids, g_vis, ef=self.ef)
        self.top_sq, self.top_ids, self.vis = m_sq, m_ids, m_vis
        self.waves += 1
        if self.record:
            h = hashlib.sha256()
            for t in (m_sq, m_ids, m_vis):
                h.update(t.cpu().numpy().tobytes())
            self.digests.append(h.hexdigest())
        return m_sq, m_ids, m_vis, g_st

    def report(self) -> dict:
        """The rank's counters: waves, kernel and all-gather ms, digests."""
        if self._events:
            torch.cuda.synchronize()
            self.kernel_ms += sum(a.elapsed_time(b) for a, b in self._events)
            self._events = []
        return {"waves": self.waves, "kernel_ms": self.kernel_ms,
                "gather_ms": self.gather_ms, "digests": list(self.digests)}


class ShardedGraphEngine:
    """Rank 0's serving engine of the corpus-sharded graph walk over a
    process group: ``engine(batch_np) -> (dists, ids, GraphShardedStats)``,
    numpy; :meth:`close` releases the other ranks.  Built by
    :func:`build_sharded_graph_engine`."""

    def __init__(self, index, local: _ShardWave, *, num_shards: int, search_kw: dict):
        self.index, self.local, self.num_shards = index, local, num_shards
        self.search_kw = search_kw
        self._dead_mask = 0
        self.closed = False

    def _wave_step(self, offs_sh, q_sorted, top_sq, top_ids, r0, vis, *, wave):
        """One wave across the group: the batch's state at wave 0 (queries,
        starting window and bitmap, dead shards), then the scattered
        frontier and r0; every rank launches, gathers and merges."""
        dev = q_sorted.device
        if wave == 0:
            _header(dev, [_BATCH, q_sorted.shape[0], q_sorted.shape[1], vis.shape[0],
                          vis.shape[1], self._dead_mask])
            for t in (q_sorted, top_sq, top_ids, vis):
                _bcast(t)
            self.local.begin(q_sorted, top_sq, top_ids, vis)
        _header(dev, [_WAVE, offs_sh.shape[2]])
        _bcast(offs_sh)
        _bcast(r0)
        return self.local.wave(offs_sh[0], r0)

    def __call__(self, batch_np):
        s = self.num_shards
        dead = current_chaos().dead_shards(s)
        tombs = dead_shard_tombstones(self.index.corpus_rot.shape[0], s, dead) if dead else ()
        self._dead_mask = sum(1 << int(d) for d in dead)
        with current_tracer().span("engine.step", route="graph-sharded", shards=s,
                                   batch=len(batch_np), dead_shards=len(dead)):
            d, i, st = search_graph_sharded(
                self.index, batch_np, num_shards=s, wave_step=self._wave_step,
                tombstones=tombs, device=self.index.device, **self.search_kw)
        return d.cpu().numpy(), i.cpu().numpy(), st

    def close(self) -> None:
        """Send the other ranks their stop (once)."""
        if not self.closed:
            self.closed = True
            _header(self.index.device, [_STOP])


def build_sharded_graph_engine(index, mesh, *, k: int, ef: int = 48, expand: int = 2,
                               record: bool = False,
                               timed: bool = False) -> ShardedGraphEngine:
    """Rank 0's engine of ``serve --index graph --graph-shards N`` over a
    one-dimensional ``mesh`` of N ranks, every other rank running
    :func:`graph_shard_worker`.

    The process-group realisation of ``index.graph.search_graph_sharded``:
    rank s holds the adjacency rows of nodes ``shard_graph_nodes(n, N)[s]``
    (the mesh's linear order), and each wave is one ``wave_step``: rank 0
    picks the frontier and broadcasts the scattered offsets and r0, every
    rank launches the one-wave kernel over its rows with the threshold
    frozen, all-gathers the windows, bitmaps and stats and merges them
    (``merge_shard_windows``).  Rank 0 holds the whole index (it runs the
    prologue and the frontier selection), the others their slab rows only.
    The walk is the one ``serve`` runs (unseeded, decoupled, no routing
    slack, at most 64 waves), with the same settings on every rank.  The
    results equal the host-simulated walk's, and so the ``num_shards=1,
    use_ref=True`` oracle's, bit for bit.

    Failover: each batch asks the chaos harness for dead shards; their
    node ranges are tombstoned (``dead_shard_tombstones``) and the dead
    rank, still in the collective, is handed only -1 offsets, so it
    contributes its carried-in window, the merge's identity; the survivors'
    results equal the surviving-corpus oracle.  Fails fast on a mesh of
    more than one dimension or a node count the mesh does not divide."""
    if mesh.ndim != 1:
        raise ValueError(f"sharded graph serving needs a 1-D mesh, got "
                         f"dims={mesh.mesh_dim_names}")
    num_shards = mesh.size()
    n = index.corpus_rot.shape[0]
    base, count = shard_graph_nodes(n, num_shards)[mesh_rank(mesh)]
    if mesh_rank(mesh) != 0:
        raise ValueError("the sharded engine runs on rank 0; the others run "
                         "graph_shard_worker")
    if not index.has_fused:
        raise ValueError("sharded graph serving needs build_graph(..., quant='int8')")
    local = _ShardWave(graph_slab(index, base, count), group=mesh.get_group(0), k=k,
                       ef=ef, record=record, timed=timed)
    return ShardedGraphEngine(index, local, num_shards=num_shards, search_kw=dict(
        k=k, ef=ef, expand=expand, block_q=local.block_q))


def graph_shard_worker(rank: int, world: int, dev, snapshot: str, cfg: dict) -> dict:
    """Rank ``rank`` (> 0) of a sharded graph engine: load its slab rows from
    the index snapshot in ``snapshot`` (``checkpoint.index_io.load_graph_slab``)
    and serve rank 0's waves until it stops them.  ``cfg``: ``k``, ``ef``
    (as rank 0's), ``mesh_device_type``, ``record``, ``timed``.  Returns the
    rank's
    kernel launches and :meth:`_ShardWave.report`; raises if it is handed a
    frontier node while its shard is dead."""
    from repro_torch.checkpoint.index_io import load_graph_slab

    mesh = make_mesh((world,), ("shard",), cfg["mesh_device_type"])
    slab = load_graph_slab(snapshot, shard=mesh_rank(mesh), num_shards=world, device=dev)
    local = _ShardWave(slab, group=mesh.get_group(0), k=cfg["k"], ef=cfg["ef"],
                       record=cfg["record"], timed=cfg["timed"])
    launches0 = graph_scan.graph_scan_kernel_call.launches
    batches, dead = 0, False
    while True:
        cmd, *h = _header(dev)
        if cmd == _STOP:
            break
        if cmd == _BATCH:
            q_pad, dim, q_tiles, words, dead_mask = h[:5]
            q = _bcast(torch.empty((q_pad, dim), device=dev))
            top_sq = _bcast(torch.empty((q_pad, cfg["ef"]), device=dev))
            top_ids = _bcast(torch.empty((q_pad, cfg["ef"]), dtype=torch.int32, device=dev))
            vis = _bcast(torch.empty((q_tiles, words), dtype=torch.int32, device=dev))
            local.begin(q, top_sq, top_ids, vis)
            dead = bool((dead_mask >> rank) & 1)
            batches += 1
        elif cmd == _WAVE:
            offs = _bcast(torch.empty((world, local.vis.shape[0], h[0]), dtype=torch.int32,
                                      device=dev))
            r0 = _bcast(torch.empty_like(local.top_sq[:, 0]))
            if dead and bool((offs[rank] >= 0).any()):
                raise RuntimeError(f"dead shard {rank} was handed frontier nodes")
            local.wave(offs[rank], r0)
        else:
            raise RuntimeError(f"unknown sharded-engine command {cmd}")
    return {"rank": rank, "batches": batches,
            "launches": graph_scan.graph_scan_kernel_call.launches - launches0,
            **local.report()}


@contextlib.contextmanager
def sharded_graph_engine(index, snapshot: str, *, num_shards: int, backend: str,
                         k: int, ef: int = 48, expand: int = 2, record: bool = False,
                         timed: bool = False, device: str = "cuda"):
    """``with sharded_graph_engine(...) as engine:`` a sharded graph engine
    over ``num_shards`` ranks: ranks 1.. spawned (``launch.mesh.LeadRank``)
    to serve their slabs of the snapshot in ``snapshot`` (the one ``index``
    was saved to), this process rank 0 over ``index`` (on rank 0's device).
    On exit the ranks are stopped and joined; ``engine.ranks`` then holds
    every rank's report (rank 0's included), and a failed rank raises."""
    cfg = dict(k=k, ef=ef, record=record, timed=timed,
               mesh_device_type=mesh_device_type(backend))
    with LeadRank(graph_shard_worker, num_shards, backend=backend, device=device,
                  args=(snapshot, cfg)) as lead:
        mesh = make_mesh((num_shards,), ("shard",), cfg["mesh_device_type"])
        launches0 = graph_scan.graph_scan_kernel_call.launches
        engine = build_sharded_graph_engine(index, mesh, k=cfg["k"], ef=cfg["ef"],
                                            expand=expand, record=record, timed=timed)
        engine.backend = backend
        yield engine
        engine.close()
        rank0 = {"rank": 0, "launches": graph_scan.graph_scan_kernel_call.launches - launches0,
                 **engine.local.report()}
    engine.ranks = {0: rank0, **lead.results}


# ---------------------------------------------------------------------------
# The flat route over a rank mesh
# ---------------------------------------------------------------------------

_ROW_DTYPES = (torch.float32, torch.bfloat16)


class RankedFlatStep:
    """Rank 0's flat search step over a 1-D ``mesh`` of R ranks, the others
    running :func:`flat_rank_worker`: ``step(queries) -> (dists, ids,
    scan)`` over the whole corpus.

    At construction rank 0 keeps the first ``corpus_per_device`` rows (and
    codes) of the served corpus and sends rank r its r-th share, with the
    block scales and the table; each call broadcasts the queries and runs
    ``build_search_step(svc, shards=..., mesh=mesh)`` on every rank (each
    rank's share walked as ``shards // R`` segments, the seeds
    ``MIN``-reduced, the windows merged by ``hierarchical_topk``).
    ``timings["merge_ms"]`` sums rank 0's merge time."""

    def __init__(self, svc: ServiceConfig, mesh, rows, codes, bscales, eps, scale,
                 eps_lo, *, shards: int, timings: dict | None = None):
        world = mesh.size()
        n_local = rows.shape[0] // world
        if rows.shape[0] % world:
            raise ValueError(f"{rows.shape[0]} corpus rows do not split over {world} ranks")
        dev = rows.device
        _header(dev, [n_local, rows.shape[1], bscales.shape[0],
                      _ROW_DTYPES.index(rows.dtype)])
        for r in range(1, world):
            part = slice(r * n_local, (r + 1) * n_local)
            coll.send(rows[part], r)
            coll.send(codes[part], r)
        self.table = tuple(_bcast(t.float()) for t in (bscales, eps, scale, eps_lo))
        self.rows, self.codes = rows[:n_local], codes[:n_local]
        self.svc, self.mesh = svc, mesh
        self.step = build_search_step(svc, with_stats=True, shards=shards, mesh=mesh,
                                      timings=timings)
        self.closed = False

    def __call__(self, queries: torch.Tensor):
        """``queries``: (Q, D_pad) rotated, already in the row dtype."""
        _header(queries.device, [_BATCH, *queries.shape])
        q = _bcast(queries.float()).to(self.rows.dtype)
        bscales, eps, scale, eps_lo = self.table
        return self.step(self.rows, self.codes, bscales, q, eps, scale, eps_lo)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            _header(self.rows.device, [_STOP])


def flat_rank_worker(rank: int, world: int, dev, svc: ServiceConfig, shards: int,
                     mesh_device_type: str) -> dict:
    """Rank ``rank`` (> 0) of the flat route over ranks: receive its rows,
    codes and the table from rank 0 (:class:`RankedFlatStep`), then run the
    mesh step on every batch rank 0 broadcasts until it stops them.
    Returns the rank's batches and ``ivf_scan`` launches."""
    mesh = make_mesh((world,), ("rank",), mesh_device_type)
    n_local, d_pad, s_steps, dt, *_ = _header(dev)
    rows = coll.recv(torch.empty((n_local, d_pad), dtype=_ROW_DTYPES[dt], device=dev), 0)
    codes = coll.recv(torch.empty((n_local, d_pad), dtype=torch.int8, device=dev), 0)
    bscales = _bcast(torch.empty((s_steps,), device=dev))
    eps, scale, eps_lo = (_bcast(torch.empty((s_steps,), device=dev)) for _ in range(3))
    step = build_search_step(svc, with_stats=True, shards=shards, mesh=mesh)
    launches0 = ivf_scan_kernel_call.launches
    batches = 0
    while True:
        cmd, *h = _header(dev)
        if cmd == _STOP:
            break
        if cmd != _BATCH:
            raise RuntimeError(f"unknown flat-rank command {cmd}")
        q = _bcast(torch.empty((h[0], h[1]), device=dev)).to(rows.dtype)
        step(rows, codes, bscales, q, eps, scale, eps_lo)
        batches += 1
    return {"rank": rank, "batches": batches,
            "launches": ivf_scan_kernel_call.launches - launches0}


# ---------------------------------------------------------------------------
# Continuous-batching engines: mid-walk admission over the fused scans
# ---------------------------------------------------------------------------


def slo_signal(r_prev: float, r_new: float) -> float:
    """Observed DCO threshold-tightening rate over one wave, in [0, 1].

    0 means the wave-start r² did not move (a stalling walk); 1 means it
    collapsed — or became finite from an unseeded ``inf``, the strongest
    tightening a wave can report."""
    if not math.isfinite(r_prev):
        return 1.0 if math.isfinite(r_new) else 0.0
    if r_prev <= 0.0:
        return 0.0
    return float(min(max(1.0 - r_new / r_prev, 0.0), 1.0))


def slo_effort(signal: float, lo: float, hi: float) -> float:
    """Map a [0, 1] urgency signal onto an effort dial in [lo, hi]: monotone
    nondecreasing in ``signal`` and clamped to the band.  With ``lo == hi``
    the dial is a constant, which is how an SLO policy degenerates to the
    fixed-parameter engine bit for bit.  ``lo + (hi - lo) * s`` can round
    one ulp past ``hi`` (the reference's value there); the port clamps it
    back, and equals the reference wherever the reference stays inside."""
    if hi < lo:
        raise ValueError(f"slo_effort needs hi >= lo, got lo={lo} hi={hi}")
    s = min(max(float(signal), 0.0), 1.0)
    return min(max(lo + (hi - lo) * s, lo), hi)


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Per-query effort adaptation from the threshold-tightening rate.

    ``lo``/``hi`` bound the host-side effort dial — the frontier ``expand``
    of the graph walk, the probe allowance of the IVF scan.  A walk whose
    threshold stalls is pushed toward ``hi``; a fast-tightening walk coasts
    at ``lo``.  ``stall_waves`` (optional) retires a query after that many
    consecutive waves without any tightening (``serve.retire.stall``).
    Adaptation touches only host dials, never the screen threshold, so
    every returned distance is still exact; ``slo=None`` keeps the engine
    bit-identical to the fixed-parameter batch search."""

    lo: float
    hi: float
    stall_waves: int | None = None

    def __post_init__(self):
        if self.hi < self.lo:
            raise ValueError(
                f"SLOPolicy needs hi >= lo, got lo={self.lo} hi={self.hi}")
        if self.stall_waves is not None and self.stall_waves < 1:
            raise ValueError(
                f"SLOPolicy stall_waves must be >= 1, got {self.stall_waves}")

    def dial(self, tightening: float) -> float:
        """Effort for one wave: monotone nonincreasing in the tightening
        signal (stalling → more effort), bounded to [lo, hi]."""
        return slo_effort(1.0 - tightening, self.lo, self.hi)


def parse_slo(spec) -> SLOPolicy | None:
    """Parse a ``--slo`` spec: ``off``/``none``/empty → None, ``LO:HI`` or
    ``LO:HI:STALL_WAVES`` → :class:`SLOPolicy`."""
    if spec is None or isinstance(spec, SLOPolicy):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "off", "none"):
        return None
    parts = s.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--slo spec {spec!r}: want LO:HI, LO:HI:STALL_WAVES, or 'off'")
    stall = int(parts[2]) if len(parts) == 3 else None
    return SLOPolicy(lo=float(parts[0]), hi=float(parts[1]), stall_waves=stall)


@dataclasses.dataclass(frozen=True)
class RetiredQuery:
    """One query leaving a continuous engine: its results, its ledger, and
    why it retired (``frontier`` = converged, ``budget`` = wave budget
    exhausted, ``stall`` = SLO stall cutoff)."""

    handle: int
    dists: np.ndarray  # (K,)
    ids: np.ndarray  # (K,)
    stats: object  # GraphScanStats | FusedScanStats, qn=1 ledger
    waves: int
    reason: str
    degraded: bool


class ContinuousGraphEngine:
    """Mid-walk admission over the one-wave graph beam-scan kernel.

    Every live query occupies its own ``block_q`` tile — the query in row
    0, pad rows as the batch search pads a one-query batch
    (``index.graph._prep_wave_state``) — and each wave stacks the live
    tiles into one launch of ``ops.graph_scan_kernel``, padded to a
    power-of-two tile count (``ops.pow2_bucket``, ``ops.pad_live_rows``).
    A tile reads only its own rows and ``-1`` steps ship nothing, so the
    stacked launch is, tile by tile, the launch of that query alone: for
    any admission schedule and retirement order every query returns the
    ids, distances and ledger of ``search_graph_fused(index, q[None])`` —
    on the card, of the walk kernel, which picks the same frontiers on the
    card that this engine picks between waves with ``_select_wave``.

    The live slots' state stays stacked on the index's device, one tensor
    per field in admission order (queries, beam windows, threshold floors,
    visited bitmaps, ledger sums), so a wave's selection, stacking and
    bookkeeping are a few tensor operations whatever the live count; the
    host keeps per-slot counters (waves walked, ``expand``, the entry, the
    SLO state) and reads back one count per slot each wave, and a retiring
    slot's window row.

    ``num_shards`` > 1 runs the host-simulated sharded walk each wave: one
    launch per shard over its slab rows with the threshold frozen
    (``tighten=False``), the windows merged (``merge_shard_windows``) and
    the bitmaps OR-ed — the ``search_graph_sharded`` schedule, so every
    query returns what ``search_graph_sharded(index, q[None],
    num_shards=S, use_ref=True)`` returns, with its per-shard ledger and
    the exchange bytes its solo walk books.  Each admission and wave asks
    the chaos harness for dead shards: a query admitted after a death
    starts from the degraded state (fallback entry, tombstoned bitmap) and
    equals the surviving-corpus oracle; a query mid-walk at the death gets
    the dead ranges OR-ed into its bitmap and finishes flagged degraded.

    ``slo`` (an :class:`SLOPolicy` or ``--slo`` spec) adapts each query's
    ``expand`` from its threshold-tightening rate and optionally retires
    stalled walks; ``None`` keeps the engine bit-identical to the batch
    search.  The walk is the one ``serve`` runs: unseeded, decoupled
    (threshold column ``k - 1``), no routing slack, at most ``MAX_WAVES``
    waves.
    """

    MAX_WAVES = 64

    def __init__(self, index, *, k: int, ef: int = 48, expand: int = 2,
                 block_q: int = 8, num_shards: int = 1, slo=None):
        if not 1 <= k <= ef:
            raise ValueError(f"need 1 <= k <= ef, got k={k} ef={ef}")
        self.index = index
        self.k, self.ef, self.expand = k, ef, expand
        self.block_q = block_q
        self.slo = parse_slo(slo)
        self.thresh_col = k - 1
        self._n, self._dim = index.corpus_rot.shape
        self.num_shards = num_shards
        self._ranges = shard_graph_nodes(self._n, num_shards)
        self._words = ops.graph_vis_words(self._n)
        self._tombs: tuple = ()
        dev = index.device
        # The live slots, stacked in admission order: tile t is rows
        # [t * block_q, (t + 1) * block_q) of the row-indexed fields.
        self._handles: list[int] = []
        self._q = torch.zeros((0, self._dim), device=dev)
        self._top_sq = torch.zeros((0, ef), device=dev)
        self._top_ids = torch.zeros((0, ef), dtype=torch.int32, device=dev)
        self._seed = torch.zeros((0,), device=dev)
        self._vis = torch.zeros((0, self._words), dtype=torch.int32, device=dev)
        self._sem = torch.zeros((0, 4), dtype=torch.float64, device=dev)
        # Per shard: int8 tiles and fp slabs fetched.
        self._fetch = torch.zeros((0, num_shards, 2), dtype=torch.float64, device=dev)
        self._depth = np.zeros((0,), np.int64)
        self._expand = np.zeros((0,), np.int64)
        self._entry = np.zeros((0,), np.int64)
        self._degraded = np.zeros((0,), bool)
        self._exch = np.zeros((0,), np.float64)
        self._r_prev = np.zeros((0,), np.float64)
        self._stall = np.zeros((0,), np.int64)
        self._pending: list[tuple[int, tuple, int, bool]] = []  # admitted, not stacked
        self._live: set[int] = set()
        self._next = 0
        self._wave_idx = 0

    def live_count(self) -> int:
        return len(self._live)

    def _sync_chaos(self) -> None:
        """Refresh the dead-shard tombstones from the chaos harness: newly
        dead ranges are OR-ed into every live walk's bitmap (the walk goes
        on over the surviving corpus, flagged degraded); later admissions
        start from the degraded state."""
        dead = current_chaos().dead_shards(self.num_shards)
        tombs = dead_shard_tombstones(self._n, self.num_shards, dead) if dead else ()
        if tombs == self._tombs:
            return
        fresh = tuple(t for t in tombs if t not in self._tombs)
        self._tombs = tombs
        if fresh:
            bits = torch.as_tensor(ops.pack_vis_ranges(self._n, fresh), device=self._vis.device)
            self._vis = self._vis | bits[None, :]
            self._degraded[:] = True
            self._pending = [(h, st[:4] + (st[4] | bits[None, :],), e, True)
                             for h, st, e, _ in self._pending]

    def admit(self, row) -> int:
        """Admit one query mid-walk; returns its handle.  The slot is freshly
        seeded from ``_prep_wave_state`` on the one-query batch (under the
        current tombstones), so a backfilled slot never inherits a retired
        walk's window."""
        self._sync_chaos()
        _, q, _, _, _, entry, top_sq, top_ids, seed = _prep_wave_state(
            self.index, np.asarray(row, np.float32)[None], k=self.k, ef=self.ef,
            block_q=self.block_q, seed_r=False, tombstones=self._tombs)
        vis = torch.zeros((1, self._words), dtype=torch.int32, device=q.device)
        if self._tombs:
            vis |= torch.as_tensor(ops.pack_vis_ranges(self._n, self._tombs),
                                   device=q.device)[None, :]
        h = self._next
        self._next += 1
        self._pending.append((h, (q, top_sq, top_ids, seed, vis), entry, bool(self._tombs)))
        self._live.add(h)
        return h

    def shed(self, handle: int) -> None:
        """Drop a live walk without retiring it (deadline/error sheds)."""
        self._live.discard(handle)

    def _stack_pending(self) -> None:
        if not self._pending:
            return
        hs, states, entries, degraded = zip(*self._pending)
        self._pending = []
        q, top_sq, top_ids, seed, vis = (torch.cat(f) for f in zip(*states))
        dev, m = q.device, len(hs)
        self._handles.extend(hs)
        self._q = torch.cat([self._q, q])
        self._top_sq = torch.cat([self._top_sq, top_sq])
        self._top_ids = torch.cat([self._top_ids, top_ids])
        self._seed = torch.cat([self._seed, seed])
        self._vis = torch.cat([self._vis, vis])
        self._sem = torch.cat([self._sem, torch.zeros((m, 4), dtype=torch.float64, device=dev)])
        self._fetch = torch.cat([self._fetch, torch.zeros(
            (m, self.num_shards, 2), dtype=torch.float64, device=dev)])
        self._depth = np.concatenate([self._depth, np.zeros(m, np.int64)])
        self._expand = np.concatenate([self._expand, np.full(m, self.expand, np.int64)])
        self._entry = np.concatenate([self._entry, np.asarray(entries, np.int64)])
        self._degraded = np.concatenate([self._degraded, np.asarray(degraded, bool)])
        self._exch = np.concatenate([self._exch, np.zeros(m)])
        self._r_prev = np.concatenate([self._r_prev, np.full(m, math.inf)])
        self._stall = np.concatenate([self._stall, np.zeros(m, np.int64)])

    def _keep(self, keep: np.ndarray) -> None:
        """Compact the stacked state to the slots ``keep`` marks (order kept)."""
        if keep.all():
            return
        dev = self._q.device
        tiles = torch.as_tensor(np.nonzero(keep)[0], device=dev)
        rows = (tiles[:, None] * self.block_q
                + torch.arange(self.block_q, device=dev)[None, :]).reshape(-1)
        self._handles = [h for h, kp in zip(self._handles, keep) if kp]
        self._q, self._top_sq, self._top_ids, self._seed = (
            t[rows] for t in (self._q, self._top_sq, self._top_ids, self._seed))
        self._vis, self._sem, self._fetch = (
            t[tiles] for t in (self._vis, self._sem, self._fetch))
        (self._depth, self._expand, self._entry, self._degraded, self._exch,
         self._r_prev, self._stall) = (
            a[keep] for a in (self._depth, self._expand, self._entry, self._degraded,
                              self._exch, self._r_prev, self._stall))

    def _finish(self, slots, reasons) -> list[RetiredQuery]:
        """Retire ``slots`` (tile indices) with ``reasons``: read back row 0
        of each tile — the qn=1 crop of the batch epilogue — and its
        ledger, then drop the slots from the stacked state."""
        if not slots:
            return []
        dev = self._q.device
        tiles = torch.as_tensor(slots, device=dev)
        top_sq = self._top_sq[tiles * self.block_q, : self.k].cpu().numpy()
        top_ids = self._top_ids[tiles * self.block_q, : self.k].cpu().numpy()
        sem, fetch = self._sem[tiles].cpu().numpy(), self._fetch[tiles].cpu().numpy()
        out = []
        for j, (t, reason) in enumerate(zip(slots, reasons)):
            if self.num_shards == 1:
                stats = _graph_stats(
                    self.index, dim=self._dim, k=self.k, seed_r=False, qn=1,
                    waves=int(self._depth[t]), sem=sem[j], s1_tiles=float(fetch[j, 0, 0]),
                    s2_slabs=float(fetch[j, 0, 1]))
            else:
                stats = _graph_sharded_stats(
                    self.index, dim=self._dim, k=self.k, seed_r=False, qn=1,
                    waves=int(self._depth[t]), sem=sem[j], s1_tiles=fetch[j, :, 0],
                    s2_slabs=fetch[j, :, 1], exch_bytes=float(self._exch[t]),
                    num_shards=self.num_shards, tombstones=self._tombs)
            h = self._handles[t]
            self._live.discard(h)
            out.append(RetiredQuery(
                handle=h, dists=np.sqrt(np.maximum(top_sq[j], 0.0)),
                ids=top_ids[j].astype(np.int32), stats=stats,
                waves=int(self._depth[t]), reason=reason,
                degraded=bool(self._degraded[t])))
        keep = np.ones(len(self._handles), bool)
        keep[list(slots)] = False
        self._keep(keep)
        return out

    def _launch(self, q_cat, offs, top_sq, top_ids, r0_cat, vis_cat):
        """One wave over the stacked tiles: one launch over the whole slab
        (threshold tightened in the wave), or with shards one launch per
        shard's slab rows (threshold frozen) and the merge.  Returns the
        window, the bitmap and the per-shard stats."""
        ix, bq, tc = self.index, self.block_q, self.thresh_col
        if self.num_shards == 1:
            sq, ids_, st, vis_out = ops.graph_scan_kernel(
                ix.estimator, q_cat, offs, top_sq, top_ids, r0_cat, ix.adj_rot,
                ix.adj_codes, ix.adj_ids, ix.gscales, vis_cat, vis_base=0,
                vis_nodes=self._n, ef=self.ef, thresh_col=tc, block_q=bq,
                block_c=ix.adj_block, block_d=ix.scan_block_d, tighten=True)
            return sq, ids_, vis_out, [st]
        slabs = [slab_rows(ix, b, c) for b, c in self._ranges]
        inputs = frozen_wave_inputs(ix.estimator, q_cat, top_sq, top_ids, vis_cat, slabs[0],
                                    ix.gscales, base=0, n_nodes=self._n, ef=self.ef,
                                    thresh_col=tc, block_q=bq, block_c=ix.adj_block,
                                    block_d=ix.scan_block_d)
        g_sq, g_ids, g_st, g_vis = shard_launches(
            graph_scan.graph_scan_kernel_call,
            [(o, sl, b) for o, sl, (b, _) in zip(localize_frontier(offs, self._ranges), slabs,
                                                 self._ranges)],
            inputs, top_sq, top_ids, r0_cat, vis_cat)
        sq, ids_, vis_out = merge_shard_state(g_sq, g_ids, g_vis, ef=self.ef)
        return sq, ids_, vis_out, list(g_st)

    def step(self) -> list[RetiredQuery]:
        """Run one frontier wave over the whole live set; returns the
        queries that retired (converged frontier, wave budget, or SLO
        stall).  Safe to call with an empty live set (returns [])."""
        tr = current_tracer()
        self._sync_chaos()
        current_chaos().on_wave(self._wave_idx)
        self._wave_idx += 1
        bq, tc = self.block_q, self.thresh_col
        with tr.span("continuous.select"):
            self._stack_pending()
            self._keep(np.asarray([h in self._live for h in self._handles], bool))
            n = len(self._handles)
            if n == 0:
                return []
            r0 = torch.minimum(self._seed, self._top_sq[:, tc])
            table = _select_wave(
                self._top_sq[::bq], self._top_ids[::bq], self._vis,
                r0[::bq], block_q=1, qn=n, expand=self._expand,
                ef=self.ef)
            fresh = np.nonzero(self._depth == 0)[0]
            if fresh.size:
                # Wave 0 expands the entry point unconditionally (its own
                # distance may exceed a seeded threshold, but its
                # neighbourhood is what fills the window).
                rows = torch.as_tensor(fresh, device=table.device)
                table[rows] = -1
                table[rows, 0] = torch.as_tensor(self._entry[fresh], dtype=table.dtype,
                                                 device=table.device)
            counts = (table >= 0).sum(dim=1).cpu().numpy()
        with tr.span("continuous.retire"):
            budget = self._depth >= self.MAX_WAVES
            gone = np.nonzero(budget | (counts == 0))[0]
            retired = self._finish(gone.tolist(), ["budget" if budget[t] else "frontier"
                                                   for t in gone])
            if gone.size:
                keep = np.ones(n, bool)
                keep[gone] = False
                tiles = torch.as_tensor(np.nonzero(keep)[0], device=table.device)
                table, counts = table[tiles], counts[keep]
                r0 = r0.reshape(n, bq)[tiles].reshape(-1)
            n = len(self._handles)
            if n == 0:
                return retired
        with tr.span("continuous.stack"):
            steps = ops.pow2_bucket(int(counts.max()))
            offs = table[:, :steps]
            if offs.shape[1] < steps:
                offs = torch.nn.functional.pad(offs, (0, steps - offs.shape[1]), value=-1)
            bucket = ops.pow2_bucket(n)
            # Stack the live tiles and pad to the pow2 bucket with the inert
            # values the batch search pads one-query batches with.
            pad = lambda x, rows, fill: ops.pad_live_rows(  # noqa: E731
                x, rows, bucket * rows // n, fill=fill)
            q_cat = pad(self._q, n * bq, 0.0)
            top_sq, top_ids = pad(self._top_sq, n * bq, float("inf")), pad(self._top_ids, n * bq, -1)
            r0_cat, vis_cat, offs = pad(r0, n * bq, 0.0), pad(self._vis, n, 0), pad(offs, n, -1)
        with tr.span("continuous.wave", live=n, bucket=bucket, steps=steps,
                     shards=self.num_shards):
            sq, ids_, vis_out, st_sh = tr.fence(self._launch(
                q_cat, offs, top_sq, top_ids, r0_cat, vis_cat))
        with tr.span("continuous.commit"):
            self._top_sq, self._top_ids = sq[: n * bq], ids_[: n * bq]
            self._vis = vis_out[:n]
            # Row 0 of each tile is its only real query — the qn=1 crop the
            # solo search's epilogue sums over — shard by shard.
            for s, st in enumerate(st_sh):
                first = st[: n * bq: bq].double()
                self._sem += first[:, :4]
                self._fetch[:, s] += first[:, [5, 4]]
            if self.num_shards > 1:
                # The exchange bytes the query's solo walk books this wave:
                # its own frontier width sets the step count, not the
                # stacked launch's.
                self._exch += [frontier_exchange_bytes(
                    num_shards=self.num_shards, queries=bq, ef=self.ef,
                    vis_words=self._words, q_tiles=1, steps=ops.pow2_bucket(int(c)))
                    for c in counts]
            self._depth += 1
            if self.slo is None:
                return retired
            r_new = torch.minimum(self._seed, self._top_sq[:, tc])[::bq].cpu().numpy()
            stalled = []
            for t in range(n):
                rho = slo_signal(float(self._r_prev[t]), float(r_new[t]))
                self._expand[t] = max(1, int(round(self.slo.dial(rho))))
                self._stall[t] = 0 if rho > 0.0 else self._stall[t] + 1
                if (self.slo.stall_waves is not None
                        and self._stall[t] >= self.slo.stall_waves):
                    stalled.append(t)
                self._r_prev[t] = float(r_new[t])
            return retired + self._finish(stalled, ["stall"] * len(stalled))


class ContinuousIVFEngine:
    """Mid-walk admission over the fused IVF wave scan.

    Each live query owns one ``block_q`` tile (query in row 0, pad rows
    zero — the padding of a one-query batch) and a probe plan computed at
    admission by the tile router of the batch search
    (``index.ivf._route_tiles`` on the one-query batch), and its threshold
    is seeded as the batch search seeds it (``_quant_seed_rsq``).  Every wave
    advances each live slot by ``probe_chunk`` probes of its plan in one
    stacked launch of ``ops.ivf_scan_kernel``: the slot's top-K window and
    threshold re-enter the kernel as ``top0_sq``/``top0_ids`` and ``r0``,
    and the kernel's carry rule ``r² ← min(r², top_sq[k-1])`` makes the
    chunks together equal the batch search's single launch (exact resume
    needs the aligned CSR layout, ``128 % block_c == 0``).  A slot retires
    when its probe allowance is consumed.  Stats columns are integer-valued
    f32, so summing chunk totals reproduces the single launch's counters
    exactly and the per-query ``FusedScanStats`` ledger compares ``==``
    against ``search_ivf_fused(index, q[None], block_q=block_q)``.

    ``slo`` adapts the per-query probe allowance within [lo, hi] from the
    tightening rate (and can retire stalled scans early); ``None`` keeps
    the engine bit-identical to the fixed-``n_probe`` search.
    """

    def __init__(self, index, *, k: int, n_probe: int = 8, block_q: int = BLOCK_Q,
                 block_c: int = 128, probe_chunk: int = 2, slo=None):
        if 128 % block_c:
            raise ValueError(
                f"continuous IVF serving needs 128 % block_c == 0 (aligned "
                f"CSR windows are what make the chunked probe carry exact), "
                f"got block_c={block_c}")
        if probe_chunk < 1:
            raise ValueError(f"probe_chunk must be >= 1, got {probe_chunk}")
        self.index = index
        self.k = k
        self.n_probe = min(n_probe, index.n_clusters)
        self.block_q = block_q
        self.block_c = block_c
        self.probe_chunk = probe_chunk
        self.slo = parse_slo(slo)
        self._slots: dict[int, dict] = {}
        self._next = 0
        self._wave_idx = 0

    def live_count(self) -> int:
        return len(self._slots)

    def admit(self, row) -> int:
        ix = self.index
        q_rot = ix.estimator.rotate(as_tensor(np.asarray(row, np.float32)[None], ix.device))
        (_o, _i, q_sorted, tile_buckets, window_starts,
         window_rows) = _route_tiles(ix, q_rot, n_probe=self.n_probe,
                                     block_q=self.block_q)
        r0 = float(_quant_seed_rsq(ix, q_sorted, tile_buckets[:, 0], self.k)[0])
        h = self._next
        self._next += 1
        self._slots[h] = dict(
            q=q_sorted, starts=window_starts.cpu().numpy().astype(np.int32)[0],
            rows=window_rows.cpu().numpy().astype(np.int32)[0], pos=0, r=r0,
            top_sq=np.full((1, self.k), np.inf, np.float32),
            top_ids=np.full((1, self.k), -1, np.int32),
            sem=np.zeros((4,), np.float64), s1=0.0, s2=0.0,
            n_eff=self.n_probe, launches=0, r_prev=math.inf, stall=0)
        return h

    def shed(self, handle: int) -> None:
        self._slots.pop(handle, None)

    def _finish(self, handle: int, reason: str) -> RetiredQuery:
        slot = self._slots.pop(handle)
        # The search's epilogue: the root on the index's device.
        top_sq = torch.as_tensor(slot["top_sq"], device=self.index.device)
        dists = torch.sqrt(torch.clamp_min(top_sq, 0.0)).cpu().numpy()[0]
        # One synthesized qn=1 stats row re-enters the shared epilogue:
        # cols 0-3 are the chunk-summed counters, cols 4-5 the fetch
        # totals (block_q=1 makes the tile stride-sample the row itself).
        st_row = np.asarray([[*slot["sem"], slot["s2"], slot["s1"]]], np.float32)
        stats = _fused_stats(self.index, st_row, qn=1, k=self.k, block_q=1,
                             block_c=self.block_c, seed_r=True)
        return RetiredQuery(handle=handle, dists=dists,
                            ids=slot["top_ids"][0].astype(np.int32), stats=stats,
                            waves=slot["launches"], reason=reason, degraded=False)

    def step(self) -> list[RetiredQuery]:
        """Advance every live slot by one probe chunk in one stacked launch;
        returns the slots whose probe allowance is consumed."""
        current_chaos().on_wave(self._wave_idx)
        self._wave_idx += 1
        retired: list[RetiredQuery] = []
        live: list[int] = []
        for h in list(self._slots):
            if self._slots[h]["pos"] >= self._slots[h]["n_eff"]:
                retired.append(self._finish(h, "frontier"))
            else:
                live.append(h)
        if not live:
            return retired

        ix = self.index
        bq, chunk, k = self.block_q, self.probe_chunk, self.k
        n_live = len(live)
        bucket = ops.pow2_bucket(n_live)
        dev = ix.device
        q_cat = torch.zeros((n_live * bq, self._slots[live[0]]["q"].shape[1]), device=dev)
        q_cat[::bq] = torch.cat([self._slots[h]["q"] for h in live])
        r0_cat = np.zeros((n_live * bq,), np.float32)
        t0_sq = np.full((n_live * bq, k), np.inf, np.float32)
        t0_ids = np.full((n_live * bq, k), -1, np.int32)
        # Past-the-plan probes carry (start=0, rows=0): zero-row aligned
        # windows span zero tiles, so the kernel ships nothing.
        starts = np.zeros((n_live, chunk), np.int32)
        rows = np.zeros((n_live, chunk), np.int32)
        for t, h in enumerate(live):
            slot = self._slots[h]
            r0_cat[t * bq] = slot["r"]
            t0_sq[t * bq] = slot["top_sq"][0]
            t0_ids[t * bq] = slot["top_ids"][0]
            span = slot["starts"][slot["pos"]: slot["pos"] + chunk]
            starts[t, : len(span)] = span
            rows[t, : len(span)] = slot["rows"][slot["pos"]: slot["pos"] + chunk]
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        pad = lambda x, n_rows, fill: ops.pad_live_rows(  # noqa: E731
            x, n_rows, bucket * n_rows // n_live, fill=fill)
        tr = current_tracer()
        with tr.span("continuous.wave", live=n_live, bucket=bucket, chunk=chunk):
            top_sq, top_ids, st = tr.fence(ops.ivf_scan_kernel(
                ix.estimator, pad(q_cat, n_live * bq, 0.0),
                T(pad(starts, n_live, 0)), T(pad(rows, n_live, 0)), ix.flat_rot,
                ix.flat_codes, ix.flat_ids, ix.bscales,
                T(pad(r0_cat, n_live * bq, 0.0)), T(pad(t0_sq, n_live * bq, np.inf)),
                T(pad(t0_ids, n_live * bq, -1)), k=k, max_bucket=ix.max_bucket,
                block_d=ix.scan_block_d, block_q=bq, block_c=self.block_c,
                starts_aligned=True))
        top_sq = top_sq[: n_live * bq: bq].cpu().numpy()
        top_ids = top_ids[: n_live * bq: bq].cpu().numpy()
        st = st[: n_live * bq: bq].cpu().numpy()

        stalled: list[int] = []
        for t, h in enumerate(live):
            slot = self._slots[h]
            slot["top_sq"] = top_sq[t: t + 1]
            slot["top_ids"] = top_ids[t: t + 1]
            slot["sem"] += st[t, :4]
            slot["s1"] += float(st[t, 5])
            slot["s2"] += float(st[t, 4])
            # The kernel's carry rule, replayed on the host: the next
            # chunk's r0 is where the single launch would be.
            slot["r"] = min(slot["r"], float(slot["top_sq"][0, k - 1]))
            slot["pos"] += chunk
            slot["launches"] += 1
            if self.slo is not None:
                rho = slo_signal(slot["r_prev"], slot["r"])
                slot["n_eff"] = max(1, min(self.n_probe, int(round(self.slo.dial(rho)))))
                slot["stall"] = 0 if rho > 0.0 else slot["stall"] + 1
                if (self.slo.stall_waves is not None
                        and slot["stall"] >= self.slo.stall_waves):
                    stalled.append(h)
            slot["r_prev"] = slot["r"]
        for h in stalled:
            retired.append(self._finish(h, "stall"))
        return retired
