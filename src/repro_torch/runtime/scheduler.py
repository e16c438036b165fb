"""Request batching for the serving routes (port of
``repro.runtime.scheduler``; pure Python on numpy rows).

``BatchScheduler`` packs variable-size requests into fixed batches for a
search step (padding the tail), dispatches, and scatters results back per
request.  ``ContinuousScheduler`` drives a continuous engine instead:
queries join its wave step mid-walk.

Every request ends in exactly one terminal status — ``served``, or shed
with a distinct reason — so ``submitted == served + shed`` holds by
construction (``scripts/check_metrics_schema.py`` checks it on every serve
snapshot):

  * ``shed_queue``    — rejected at submit: accepting the request would
    push the queue past ``max_queue_rows`` (the depth watermark; chaos
    ``queue_overload`` pressure counts against it).
  * ``shed_deadline`` — dropped at dispatch (or admission): its deadline
    passed while it queued.
  * ``shed_error``    — the dispatch failed after ``max_retries`` bounded
    exponential-backoff retries (chaos ``step_error`` or a real engine
    fault).  The batch's requests are shed and serving continues.

Counters flow into a metrics registry when one is attached
(``serve.requests.submitted/served``, ``serve.shed.*``,
``serve.retry.attempts``, the admission ledger); without one the same
tallies live in ``stats``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from repro_torch.obs.metrics import WAVE_DEPTH_BUCKETS
from repro_torch.runtime.chaos import current_chaos

__all__ = ["BatchScheduler", "ContinuousScheduler", "Request"]

# stats key -> obs counter name (the dotted families the schema check
# cross-validates)
_METRIC_NAMES = {
    "submitted": "serve.requests.submitted",
    "served": "serve.requests.served",
    "shed_queue": "serve.shed.queue",
    "shed_deadline": "serve.shed.deadline",
    "shed_error": "serve.shed.error",
    "retries": "serve.retry.attempts",
    # Continuous-batching admission ledger (ContinuousScheduler only):
    # per-QUERY counts, closed by construction —
    # admitted == retired + admission_shed — next to the per-REQUEST
    # ledger above (the schema check cross-foots both).
    "admitted": "serve.admission.admitted",
    "retired": "serve.admission.retired",
    "admission_shed": "serve.admission.shed",
    "waves": "serve.admission.waves",
    "retire_frontier": "serve.retire.frontier",
    "retire_budget": "serve.retire.budget",
    "retire_stall": "serve.retire.stall",
}


@dataclasses.dataclass
class Request:
    rid: int
    queries: np.ndarray  # (n_i, D) rotated+padded queries
    enqueued_at: float = dataclasses.field(default_factory=time.perf_counter)
    result: tuple[np.ndarray, np.ndarray] | None = None  # (dists, ids)
    deadline_at: float | None = None  # perf_counter deadline (None = none)
    completed_at: float | None = None  # perf_counter at "served"
    status: str = "pending"  # pending|queued|served|shed_queue|
    #                          shed_deadline|shed_error
    degraded: bool = False  # any of its batches ran with a dead shard

    @property
    def shed(self) -> bool:
        return self.status.startswith("shed_")


class BatchScheduler:
    """Packs requests into fixed-size batches for a search step.

    Args:
      step_fn: callable(batch (B, D)) -> (dists (B, K), ids (B, K)).
      batch_size: the step's fixed query-batch B.
      max_wait_s: flush a partial batch after this long (latency bound).
      max_queue_rows: queue-depth watermark — submits that would push the
        pending row count (plus chaos queue pressure) past it are shed
        with ``shed_queue``.  0 (default) = unbounded.
      max_retries: bounded retries around a failing dispatch (exponential
        backoff, ``retry_backoff_s * 2**attempt``); exhausted retries shed
        the batch's requests with ``shed_error`` instead of raising.
      retry_backoff_s: first-retry backoff (doubles per attempt).
      registry: optional ``repro_torch.obs.MetricsRegistry`` —
        request/shed/retry counters land under their ``serve.*`` names.
    """

    def __init__(self, step_fn: Callable, batch_size: int,
                 *, max_wait_s: float = 0.005, max_queue_rows: int = 0,
                 max_retries: int = 0, retry_backoff_s: float = 0.02,
                 registry: Any = None):
        self.step_fn = step_fn
        self.batch = batch_size
        self.max_wait = max_wait_s
        self.max_queue_rows = max_queue_rows
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.registry = registry
        self._queue: deque[tuple[Request, int]] = deque()  # (req, row offset)
        self._next_rid = 0
        self.stats = {"batches": 0, "padded_rows": 0, "rows": 0,
                      "submitted": 0, "served": 0, "shed_queue": 0,
                      "shed_deadline": 0, "shed_error": 0, "retries": 0}

    def _count(self, key: str, delta: int = 1) -> None:
        self.stats[key] += delta
        if self.registry is not None:
            self.registry.counter(_METRIC_NAMES[key]).add(delta)

    def submit(self, queries: np.ndarray, *,
               deadline_s: float | None = None) -> Request:
        """Enqueue a request; ``deadline_s`` is a latency budget from NOW.
        Returns the request — check ``status`` (a watermark shed returns
        immediately with ``shed_queue`` and never occupies a queue slot)."""
        req = Request(rid=self._next_rid, queries=np.asarray(queries))
        self._next_rid += 1
        if deadline_s is not None:
            req.deadline_at = req.enqueued_at + deadline_s
        self._count("submitted")
        depth = len(self._queue) + len(req.queries) \
            + current_chaos().queue_pressure()
        if self.max_queue_rows and depth > self.max_queue_rows:
            req.status = "shed_queue"
            self._count("shed_queue")
            return req
        req.status = "queued"
        for i in range(len(req.queries)):
            self._queue.append((req, i))
        return req

    def _pending(self) -> int:
        return len(self._queue)

    def _take_slots(self) -> list[tuple[Request, int]]:
        """Pop up to one batch of live rows, shedding requests whose
        deadline passed while they queued (their remaining rows are
        dropped as they surface — a shed request never costs a slot)."""
        now = time.perf_counter()
        slots: list[tuple[Request, int]] = []
        while self._queue and len(slots) < self.batch:
            req, i = self._queue.popleft()
            if req.status != "queued":
                continue  # already shed: discard its remaining rows
            if req.deadline_at is not None and now > req.deadline_at:
                req.status = "shed_deadline"
                self._count("shed_deadline")
                continue
            slots.append((req, i))
        return slots

    def _dispatch(self, qs: np.ndarray):
        """One engine step with bounded retry/backoff.  Chaos step errors
        and real engine faults retry alike; after ``max_retries`` the
        exception propagates (``drain`` sheds the batch)."""
        attempt = 0
        while True:
            try:
                current_chaos().maybe_fail_step()
                return self.step_fn(qs)
            except Exception:
                if attempt >= self.max_retries:
                    raise
                self._count("retries")
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def drain(self, *, force: bool = True) -> list[Request]:
        """Run batches until the queue empties (force) or only a fresh
        partial batch remains.  Returns requests completed this call."""
        done: dict[int, Request] = {}
        parts: dict[int, list[tuple[int, np.ndarray, np.ndarray]]] = {}

        while self._queue:
            if not force and self._pending() < self.batch:
                oldest = self._queue[0][0].enqueued_at
                if time.perf_counter() - oldest < self.max_wait:
                    break
            slots = self._take_slots()
            if not slots:
                continue  # everything popped was shed; re-check the queue
            take = len(slots)
            qs = np.stack([r.queries[i] for r, i in slots])
            pad = self.batch - take
            if pad:
                qs = np.pad(qs, ((0, pad), (0, 0)))
            current_chaos().on_engine_step()  # the drill clock: one tick
            #                                   per dispatched batch
            try:
                dists, ids = self._dispatch(qs)
            except Exception:
                # Retries exhausted: shed this batch's requests (their
                # other rows drop in _take_slots) and keep serving.
                for req, _ in slots:
                    if req.status == "queued":
                        req.status = "shed_error"
                        self._count("shed_error")
                        parts.pop(req.rid, None)
                continue
            degraded = current_chaos().degraded_now()
            dists, ids = np.asarray(dists), np.asarray(ids)
            self.stats["batches"] += 1
            self.stats["padded_rows"] += pad
            self.stats["rows"] += take
            for j, (req, i) in enumerate(slots):
                req.degraded = req.degraded or degraded
                parts.setdefault(req.rid, []).append((i, dists[j], ids[j]))
                if len(parts[req.rid]) == len(req.queries):
                    order = sorted(parts.pop(req.rid))
                    req.result = (
                        np.stack([d for _, d, _ in order]),
                        np.stack([x for _, _, x in order]),
                    )
                    req.status = "served"
                    req.completed_at = time.perf_counter()
                    self._count("served")
                    done[req.rid] = req
        return [done[k] for k in sorted(done)]


class ContinuousScheduler:
    """Continuous batching: queries join the engine's wave step mid-walk.

    Where :class:`BatchScheduler` forms a FULL fixed batch and walks it to
    completion before the next batch starts (a query arriving one tick
    after a batch closed waits the whole walk out), this front end drives a
    *continuous engine* (``launch.annservice.ContinuousGraphEngine`` /
    ``ContinuousIVFEngine``): every wave it admits queued queries into free
    live slots, steps the whole live set ONE frontier wave, and retires the
    queries that converged — so a new arrival starts walking on the very
    next wave while older queries are mid-walk, and the engine's pow2
    live-set bucketing keeps launch shapes few as occupancy churns.
    The engine guarantees interleaving invariance (each retired query is
    bit-identical to a solo batch-path run), so this scheduler changes
    *when* work happens, never *what* is computed.

    The request ledger (``submitted == served + shed``) carries over
    unchanged.  A second per-QUERY admission ledger is closed by the same
    construction: every admitted query either retires or is shed with its
    request, so ``serve.admission.admitted == serve.admission.retired +
    serve.admission.shed`` for ANY interleaving of arrivals, deadline
    expiries, chaos faults, and retirement order.  Deadline expiry mid-walk
    sheds the whole request atomically (its live walks are withdrawn from
    the engine; partial results are discarded) — a request is never half
    answered.

    Args:
      engine: the continuous engine (``admit``/``shed``/``step``/
        ``live_count`` protocol; ``step`` returns ``RetiredQuery`` rows).
      max_live: live-walk slot cap — admission stops while the live set is
        full (the occupancy knob).
      max_queue_rows / max_retries / retry_backoff_s / registry: as on
        :class:`BatchScheduler` (watermark shed at submit; bounded
        retry/backoff around a failing wave; exhausted retries shed every
        request with live walks and serving continues).
    """

    def __init__(self, engine: Any, *, max_live: int,
                 max_queue_rows: int = 0, max_retries: int = 0,
                 retry_backoff_s: float = 0.02, registry: Any = None):
        if max_live < 1:
            raise ValueError(f"max_live must be >= 1, got {max_live}")
        self.engine = engine
        self.max_live = max_live
        self.max_queue_rows = max_queue_rows
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.registry = registry
        self._queue: deque[tuple[Request, int]] = deque()  # (req, row offset)
        self._live: dict[int, tuple[Request, int]] = {}  # handle -> (req, i)
        self._next_rid = 0
        self.scan_stats: list = []  # per-retired-query engine ledgers
        self.stats = {"waves": 0, "live_rows": 0, "submitted": 0, "served": 0,
                      "shed_queue": 0, "shed_deadline": 0, "shed_error": 0,
                      "retries": 0, "admitted": 0, "retired": 0,
                      "admission_shed": 0, "retire_frontier": 0,
                      "retire_budget": 0, "retire_stall": 0}

    def _count(self, key: str, delta: int = 1) -> None:
        self.stats[key] += delta
        if self.registry is not None:
            self.registry.counter(_METRIC_NAMES[key]).add(delta)

    def submit(self, queries: np.ndarray, *,
               deadline_s: float | None = None) -> Request:
        """Enqueue a request (same contract as ``BatchScheduler.submit``:
        a watermark shed returns immediately with ``shed_queue``)."""
        req = Request(rid=self._next_rid, queries=np.asarray(queries))
        self._next_rid += 1
        if deadline_s is not None:
            req.deadline_at = req.enqueued_at + deadline_s
        self._count("submitted")
        depth = len(self._queue) + len(req.queries) \
            + current_chaos().queue_pressure()
        if self.max_queue_rows and depth > self.max_queue_rows:
            req.status = "shed_queue"
            self._count("shed_queue")
            return req
        req.status = "queued"
        for i in range(len(req.queries)):
            self._queue.append((req, i))
        return req

    def _pending(self) -> int:
        return len(self._queue)

    def _shed_request(self, req: Request, status: str,
                      parts: dict) -> None:
        """Terminal-shed ``req`` atomically: withdraw its live walks from
        the engine (each one closes the admission ledger as
        ``admission_shed``), drop its partial results, and let its queued
        rows discard as they surface.  Idempotent on already-shed
        requests."""
        if req.status != "queued":
            return
        req.status = status
        self._count(status)
        for h in [h for h, (r, _) in self._live.items() if r is req]:
            del self._live[h]
            self.engine.shed(h)
            self._count("admission_shed")
        parts.pop(req.rid, None)

    def _admit(self, parts: dict) -> None:
        """Fill free live slots from the queue.  Deadline-expired requests
        shed here (at admission) exactly as ``BatchScheduler._take_slots``
        sheds them at dispatch; rows of already-shed requests discard."""
        now = time.perf_counter()
        while self._queue and self.engine.live_count() < self.max_live:
            req, i = self._queue.popleft()
            if req.status != "queued":
                continue
            if req.deadline_at is not None and now > req.deadline_at:
                self._shed_request(req, "shed_deadline", parts)
                continue
            handle = self.engine.admit(req.queries[i])
            self._live[handle] = (req, i)
            self._count("admitted")

    def _dispatch_wave(self):
        """One engine wave with bounded retry/backoff (chaos ``step_error``
        raises from ``maybe_fail_step`` BEFORE the engine mutates, so a
        retried wave re-enters with identical state)."""
        attempt = 0
        while True:
            try:
                current_chaos().maybe_fail_step()
                return self.engine.step()
            except Exception:
                if attempt >= self.max_retries:
                    raise
                self._count("retries")
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def drain(self, *, force: bool = True) -> list[Request]:
        """Run waves until queue AND live set empty; returns requests
        completed this call.  ``force`` is accepted for drop-in
        compatibility with ``BatchScheduler`` but ignored: a continuous
        engine admits into a RUNNING wave loop, so there is no "wait for a
        fuller batch" state to preserve — arrivals between ``drain`` calls
        simply join the next wave."""
        del force
        done: dict[int, Request] = {}
        parts: dict[int, dict[int, tuple[np.ndarray, np.ndarray]]] = {}

        while self._queue or self._live:
            self._admit(parts)
            if not self._live:
                if not self._queue:
                    break  # everything left in the queue was already shed
                continue  # shed rows discarded; re-check for admissible ones
            now = time.perf_counter()
            for req in {r.rid: r for r, _ in self._live.values()}.values():
                if req.deadline_at is not None and now > req.deadline_at:
                    self._shed_request(req, "shed_deadline", parts)
            if not self._live:
                continue
            self.stats["live_rows"] += self.engine.live_count()
            if self.registry is not None:
                self.registry.gauge("serve.wave.occupancy").set(
                    float(self.engine.live_count()))
            current_chaos().on_engine_step()  # the drill clock: one tick
            #                                   per dispatched wave
            try:
                retired = self._dispatch_wave()
            except Exception:
                # Retries exhausted: shed every request with live walks
                # (their queued rows drop at admission) and keep serving.
                for req in {r.rid: r for r, _ in self._live.values()}.values():
                    self._shed_request(req, "shed_error", parts)
                continue
            self._count("waves")
            degraded = current_chaos().degraded_now()
            for rq in retired:
                req, i = self._live.pop(rq.handle)
                self._count("retired")
                self._count(f"retire_{rq.reason}")
                if self.registry is not None:
                    self.registry.histogram(
                        "serve.wave.depth",
                        WAVE_DEPTH_BUCKETS).observe(float(rq.waves))
                self.scan_stats.append(rq.stats)
                req.degraded = req.degraded or rq.degraded
                parts.setdefault(req.rid, {})[i] = (rq.dists, rq.ids)
                if len(parts[req.rid]) == len(req.queries):
                    rows = parts.pop(req.rid)
                    req.result = (
                        np.stack([rows[j][0] for j in sorted(rows)]),
                        np.stack([rows[j][1] for j in sorted(rows)]),
                    )
                    req.status = "served"
                    req.completed_at = time.perf_counter()
                    self._count("served")
                    done[req.rid] = req
            if degraded:
                for req, _ in self._live.values():
                    req.degraded = True
        return [done[k] for k in sorted(done)]
