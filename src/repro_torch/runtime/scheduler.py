"""Request batching for the flat serving route (the batching part of
``repro.runtime.scheduler.Request`` / ``BatchScheduler``; pure Python).

The search step has a fixed query-batch shape; traffic arrives as
variable-size requests.  The scheduler packs queued requests' rows into
fixed batches (zero-padding the last), runs the step on each and scatters
the result rows back to their requests.  An exception from the step
propagates to the caller.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np

__all__ = ["BatchScheduler", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    queries: np.ndarray  # (n_i, D) rotated+padded queries
    result: tuple[np.ndarray, np.ndarray] | None = None  # (dists, ids)
    status: str = "queued"  # queued|served


class BatchScheduler:
    """Packs requests into fixed-size batches for a search step.

    Args:
      step_fn: callable(batch (B, D)) -> (dists (B, K), ids (B, K)).
      batch_size: the step's fixed query-batch B.
    """

    def __init__(self, step_fn: Callable, batch_size: int):
        self.step_fn = step_fn
        self.batch = batch_size
        self._queue: deque[tuple[Request, int]] = deque()  # (req, row offset)
        self._next_rid = 0
        self.stats = {"batches": 0, "padded_rows": 0, "rows": 0,
                      "submitted": 0, "served": 0}

    def submit(self, queries: np.ndarray) -> Request:
        """Enqueue a request's rows."""
        req = Request(rid=self._next_rid, queries=np.asarray(queries))
        self._next_rid += 1
        self.stats["submitted"] += 1
        for i in range(len(req.queries)):
            self._queue.append((req, i))
        return req

    def drain(self) -> list[Request]:
        """Run batches until the queue is empty; returns the requests
        completed by this call (in submission order: rows leave FIFO)."""
        done: list[Request] = []
        parts: dict[int, list[tuple[int, np.ndarray, np.ndarray]]] = {}
        while self._queue:
            slots = [self._queue.popleft()
                     for _ in range(min(self.batch, len(self._queue)))]
            take = len(slots)
            qs = np.stack([r.queries[i] for r, i in slots])
            pad = self.batch - take
            if pad:
                qs = np.pad(qs, ((0, pad), (0, 0)))
            dists, ids = self.step_fn(qs)
            dists, ids = np.asarray(dists), np.asarray(ids)
            self.stats["batches"] += 1
            self.stats["padded_rows"] += pad
            self.stats["rows"] += take
            for j, (req, i) in enumerate(slots):
                parts.setdefault(req.rid, []).append((i, dists[j], ids[j]))
                if len(parts[req.rid]) == len(req.queries):
                    order = sorted(parts.pop(req.rid), key=lambda p: p[0])
                    req.result = (np.stack([d for _, d, _ in order]),
                                  np.stack([x for _, _, x in order]))
                    req.status = "served"
                    self.stats["served"] += 1
                    done.append(req)
        return done
