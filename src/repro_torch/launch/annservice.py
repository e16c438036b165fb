"""The paper's serving workload on one card: the int8 fused flat route of
``repro.launch.annservice.build_search_step``, and the graph route of
``build_graph_engine``.

The corpus (rotated into the PCA basis at ingest) lives on the card as
rows (bf16 or f32) plus per-block int8 codes.  One search step seeds each
query's threshold from an exact-verified sample (two-phase search), then
runs the whole corpus through the fused wave-scan kernel as
``corpus // wave`` waves of ``wave // 128`` candidate tiles: int8 stage 1,
demand-paged fp stage 2, and the running top-K / r² kept on the card
between waves.  ``shards`` cuts the waves into that many contiguous runs,
each walked from the same seeded r² with an empty window, and merges the
windows as the reference's ``hierarchical_topk`` does across a mesh of as
many shards (``ivf_scan_kernel_call(segments=...)``): one launch, with
``shards`` times as many independent walks to fill the card.  Each segment
seeds from the first wave of its own run and the seeds' minimum starts them
all, the reference's ``pmin`` over its shards' seeds.

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

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core.estimators import SEED_SLACK, first_enabled_eps
from repro_torch.core.transforms import as_tensor
from repro_torch.index.graph import (
    _graph_stats, _prep_wave_state, _select_wave, search_graph_fused,
)
from repro_torch.index.ivf import BLOCK_Q, _fused_stats, _quant_seed_rsq, _route_tiles
from repro_torch.kernels import ops
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.obs.trace import current_tracer
from repro_torch.quant.scalar import quantize_queries_block
from repro_torch.runtime.chaos import current_chaos

__all__ = ["build_search_step", "build_graph_engine", "seed_rsq",
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


def seed_rsq(svc: ServiceConfig, corpus, queries, eps, segments: int = 1):
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
    adds nothing to the minimum.  Runs in float32 on the upcast rows, the
    arithmetic the kernel uses."""
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


def build_search_step(svc: ServiceConfig, *, with_stats: bool = False,
                      shards: int = SHARDS):
    """Returns ``step(corpus, codes, bscales, queries, eps, scale, eps_lo)
    -> (dists, ids[, scan])`` for the int8 fused route.

    ``corpus`` (N, D) rotated rows (bf16 or f32), ``codes`` (N, D) int8
    per-block codes, ``bscales`` (S,), ``queries`` (Q, D) rotated, and the
    blocked table.  The step runs on the tensors' device.  ``shards`` is
    the reference's shard count, run as that many segments of one scan
    (1: the reference's one-device step).  ``with_stats`` appends a (6,)
    float64 vector of the kernel's scan counters summed over queries and
    shards (the tile-level fetch counters 4-5 counted once per tile).
    """

    def step(corpus, codes, bscales, queries, eps, scale, eps_lo):
        del eps_lo  # the fused route widens from eps alone
        r0 = seed_rsq(svc, corpus, queries, eps, segments=shards)
        args, kwargs = fused_scan_inputs(svc, corpus, codes, bscales, queries,
                                         eps, scale, r0)
        top_sq, top_ids, stats = ivf_scan_kernel_call(*args, segments=shards, **kwargs)
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
        # current_tracer() resolves at call time, so a tracer serve.py
        # installs after the engine is built is seen (NULL_TRACER: no-op).
        with current_tracer().span("engine.step", route="graph", batch=len(batch_np)):
            d, i, st = search_graph_fused(index, batch_np, k=k, ef=ef,
                                          expand=expand, device=device)
            return d.cpu().numpy(), i.cpu().numpy(), st

    return step


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
    fixed-parameter engine bit for bit."""
    if hi < lo:
        raise ValueError(f"slo_effort needs hi >= lo, got lo={lo} hi={hi}")
    s = min(max(float(signal), 0.0), 1.0)
    return lo + (hi - lo) * s


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
    host keeps per-slot counters (waves walked, ``expand``, the SLO state)
    and reads back one count per slot each wave, and a retiring slot's
    window row.

    ``slo`` (an :class:`SLOPolicy` or ``--slo`` spec) adapts each query's
    ``expand`` from its threshold-tightening rate and optionally retires
    stalled walks; ``None`` keeps the engine bit-identical to the batch
    search.  The walk is the one ``serve`` runs: unseeded, decoupled
    (threshold column ``k - 1``), no routing slack, at most ``MAX_WAVES``
    waves.  ``num_shards`` other than 1 (the host-simulated sharded walk)
    is not ported.
    """

    MAX_WAVES = 64

    def __init__(self, index, *, k: int, ef: int = 48, expand: int = 2,
                 block_q: int = 8, num_shards: int = 1, slo=None):
        if num_shards != 1:
            raise NotImplementedError(
                f"num_shards={num_shards}: the sharded continuous walk is not "
                f"ported (ROADMAP queue 1 item 7)")
        if not 1 <= k <= ef:
            raise ValueError(f"need 1 <= k <= ef, got k={k} ef={ef}")
        self.index = index
        self.k, self.ef, self.expand = k, ef, expand
        self.block_q = block_q
        self.slo = parse_slo(slo)
        self.thresh_col = k - 1
        self._n, self._dim = index.corpus_rot.shape
        words = ops.graph_vis_words(self._n)
        dev = index.device
        # The live slots, stacked in admission order: tile t is rows
        # [t * block_q, (t + 1) * block_q) of the row-indexed fields.
        self._handles: list[int] = []
        self._q = torch.zeros((0, self._dim), device=dev)
        self._top_sq = torch.zeros((0, ef), device=dev)
        self._top_ids = torch.zeros((0, ef), dtype=torch.int32, device=dev)
        self._seed = torch.zeros((0,), device=dev)
        self._vis = torch.zeros((0, words), dtype=torch.int32, device=dev)
        self._sem = torch.zeros((0, 4), dtype=torch.float64, device=dev)
        self._fetch = torch.zeros((0, 2), dtype=torch.float64, device=dev)  # s1, s2
        self._depth = np.zeros((0,), np.int64)
        self._expand = np.zeros((0,), np.int64)
        self._r_prev = np.zeros((0,), np.float64)
        self._stall = np.zeros((0,), np.int64)
        self._pending: list[tuple[int, tuple]] = []  # admitted, not yet stacked
        self._live: set[int] = set()
        self._next = 0
        self._wave_idx = 0

    def live_count(self) -> int:
        return len(self._live)

    def admit(self, row) -> int:
        """Admit one query mid-walk; returns its handle.  The slot is freshly
        seeded from ``_prep_wave_state`` on the one-query batch, so a
        backfilled slot never inherits a retired walk's window."""
        _, q, _, _, _, _, top_sq, top_ids, seed = _prep_wave_state(
            self.index, np.asarray(row, np.float32)[None], k=self.k, ef=self.ef,
            block_q=self.block_q, seed_r=False)
        h = self._next
        self._next += 1
        self._pending.append((h, (q, top_sq, top_ids, seed)))
        self._live.add(h)
        return h

    def shed(self, handle: int) -> None:
        """Drop a live walk without retiring it (deadline/error sheds)."""
        self._live.discard(handle)

    def _stack_pending(self) -> None:
        if not self._pending:
            return
        hs, states = zip(*self._pending)
        self._pending = []
        q, top_sq, top_ids, seed = (torch.cat(f) for f in zip(*states))
        dev, m = q.device, len(hs)
        self._handles.extend(hs)
        self._q = torch.cat([self._q, q])
        self._top_sq = torch.cat([self._top_sq, top_sq])
        self._top_ids = torch.cat([self._top_ids, top_ids])
        self._seed = torch.cat([self._seed, seed])
        self._vis = torch.cat([self._vis, torch.zeros(
            (m, self._vis.shape[1]), dtype=torch.int32, device=dev)])
        self._sem = torch.cat([self._sem, torch.zeros((m, 4), dtype=torch.float64, device=dev)])
        self._fetch = torch.cat([self._fetch, torch.zeros(
            (m, 2), dtype=torch.float64, device=dev)])
        self._depth = np.concatenate([self._depth, np.zeros(m, np.int64)])
        self._expand = np.concatenate([self._expand, np.full(m, self.expand, np.int64)])
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
        self._depth, self._expand, self._r_prev, self._stall = (
            a[keep] for a in (self._depth, self._expand, self._r_prev, self._stall))

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
            stats = _graph_stats(
                self.index, dim=self._dim, k=self.k, seed_r=False, qn=1,
                waves=int(self._depth[t]), sem=sem[j], s1_tiles=float(fetch[j, 0]),
                s2_slabs=float(fetch[j, 1]))
            h = self._handles[t]
            self._live.discard(h)
            out.append(RetiredQuery(
                handle=h, dists=np.sqrt(np.maximum(top_sq[j], 0.0)),
                ids=top_ids[j].astype(np.int32), stats=stats,
                waves=int(self._depth[t]), reason=reason, degraded=False))
        keep = np.ones(len(self._handles), bool)
        keep[list(slots)] = False
        self._keep(keep)
        return out

    def step(self) -> list[RetiredQuery]:
        """Run one frontier wave over the whole live set; returns the
        queries that retired (converged frontier, wave budget, or SLO
        stall).  Safe to call with an empty live set (returns [])."""
        tr = current_tracer()
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
                table[rows, 0] = self.index.entry
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
        ix = self.index
        with tr.span("continuous.wave", live=n, bucket=bucket, steps=steps):
            sq, ids_, st, vis_out = tr.fence(ops.graph_scan_kernel(
                ix.estimator, q_cat, offs, top_sq, top_ids, r0_cat, ix.adj_rot,
                ix.adj_codes, ix.adj_ids, ix.gscales, vis_cat, vis_base=0,
                vis_nodes=self._n, ef=self.ef, thresh_col=tc, block_q=bq,
                block_c=ix.adj_block, block_d=ix.scan_block_d, tighten=True))
        with tr.span("continuous.commit"):
            self._top_sq, self._top_ids = sq[: n * bq], ids_[: n * bq]
            self._vis = vis_out[:n]
            # Row 0 of each tile is its only real query — the qn=1 crop the
            # solo search's epilogue sums over.
            first = st[: n * bq: bq].double()
            self._sem += first[:, :4]
            self._fetch += first[:, [5, 4]]
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
