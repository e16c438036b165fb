"""The one traffic generator.  A traffic mix is a data file,
``bench/traffic/<name>.json``; this module reads it and drives the front
end with it.  Keys:

* ``k``: the neighbours each request asks for.
* ``mix_seed``: draws the mix's fixed multiset of request sizes (and, in
  an open loop, how many requests each phase holds).  ``--seed`` orders
  that multiset, places the arrivals and picks the queries, so every seed
  offers the same work in another order.
* ``query_pool``: distinct queries drawn for a run; requests take the next
  rows of the pool in turn (the pool is reused from its start if a run
  outgrows it).
* ``request_rows``: ``{"dist": "uniform", "low", "high"}`` (``[low,
  high)``) or ``{"dist": "loguniform", "low", "high"}`` (``[low, high]``).
* ``arrivals``: ``{"kind": "closed", "group_rows": R}``: bulk requests
  sent in groups of R rows, each answered whole before the next is sent;
  or ``{"kind": "open",
  "phases": [[seconds, rate_rps], ...]}``: open-loop Poisson arrivals at a
  piecewise-constant rate, the phases repeating (one phase: a fixed rate;
  two: on/off bursts).
* ``max_wait_s``: the front end's flush of a partial batch (null: its
  default).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np


@dataclasses.dataclass
class Sent:
    """One request of the window: where its queries sit in the stream of
    pool rows, when it was due (open loop), and the front end's request."""

    offset: int
    rows: int
    due: float | None
    req: object


@dataclasses.dataclass
class Window:
    start: float
    end: float  # the last answer of the window
    sent: list
    late_ms: list  # open loop: how late each request was sent


def _sizes(spec: dict, count: int, rng) -> np.ndarray:
    lo, hi = spec["low"], spec["high"]
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi, count)
    if spec["dist"] == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), count))
        return np.clip(x.astype(np.int64), lo, hi)
    raise ValueError(f"unknown request_rows dist {spec['dist']!r}")


def _mean_size(spec: dict) -> float:
    return float(np.mean(_sizes(spec, 4096, np.random.default_rng(0))))


class Mix:
    """A traffic file's draws for one ``--seed``."""

    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.fixed = np.random.default_rng(traffic["mix_seed"])
        self.rng = np.random.default_rng([seed % (1 << 63), 7])

    def closed_sizes(self) -> np.ndarray:
        """Sizes enough to cover the pool twice, in this seed's order."""
        n = math.ceil(2 * self.t["query_pool"] / _mean_size(self.t["request_rows"]))
        return self.rng.permutation(_sizes(self.t["request_rows"], n, self.fixed))

    def open_schedule(self, seconds: float):
        """(due times from the window's start, sizes) of the open loop."""
        phases = self.t["arrivals"]["phases"]
        times, t = [], 0.0
        while t < seconds:
            for length, rps in phases:
                length = min(length, seconds - t)
                if length <= 0:
                    break
                count = self.fixed.poisson(rps * length)
                times.append(t + np.sort(self.rng.uniform(0.0, length, count)))
                t += length
        due = np.concatenate(times) if times else np.zeros(0)
        sizes = self.rng.permutation(_sizes(self.t["request_rows"], len(due), self.fixed))
        return due, sizes


class Pool:
    """The run's queries (host, float32) handed out as a stream of rows."""

    def __init__(self, queries: np.ndarray):
        self.q = queries
        self.offset = 0

    def take(self, n: int) -> tuple[int, np.ndarray]:
        p = self.q.shape[0]
        off = self.offset
        self.offset += n
        start = off % p
        if start + n <= p:
            return off, self.q[start:start + n]
        idx = (start + np.arange(n)) % p
        return off, self.q[idx]


def drive(sched, pool: Pool, mix: Mix, seconds: float, spans) -> Window:
    """Run the mix against the front end ``sched`` for ``seconds``."""
    if mix.t["arrivals"]["kind"] == "closed":
        return _closed(sched, pool, mix, seconds, spans)
    if mix.t["arrivals"]["kind"] == "open":
        return _open(sched, pool, mix, seconds, spans)
    raise ValueError(f"unknown arrivals kind {mix.t['arrivals']['kind']!r}")


def _closed(sched, pool, mix, seconds, spans) -> Window:
    """Bulk: a group of requests of ``group_rows`` rows (the last request
    of a group cut to fit), all of it answered by one forced drain, then
    the next group, until the window ends.  A group of whole batches pads
    none, so the work does not hang on how a seed's sizes add up.  (The
    front end keeps a request's answered rows only within one drain call,
    so a bulk client that drained without forcing would lose the request
    a batch boundary splits.)"""
    sizes = mix.closed_sizes()
    group = mix.t["arrivals"]["group_rows"]
    sent, i = [], 0
    with spans("window"):
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            with spans("frontend.submit"):
                queued = 0
                while queued < group:
                    n = min(int(sizes[i % len(sizes)]), group - queued)
                    i += 1
                    off, q = pool.take(n)
                    sent.append(Sent(off, n, None, sched.submit(q)))
                    queued += n
            with spans("frontend.drain"):
                sched.drain(force=True)
        end = time.perf_counter()
    return Window(t0, end, sent, [])


def _open(sched, pool, mix, seconds, spans) -> Window:
    due, sizes = mix.open_schedule(seconds)
    sent, late, i, n_req = [], [], 0, len(due)
    with spans("window"):
        t0 = time.perf_counter()
        while i < n_req:
            now = time.perf_counter() - t0
            if due[i] <= now:
                with spans("frontend.submit"):
                    while i < n_req and due[i] <= now:
                        off, q = pool.take(int(sizes[i]))
                        t_sent = time.perf_counter()
                        sent.append(Sent(off, int(sizes[i]), t0 + due[i], sched.submit(q)))
                        late.append((t_sent - t0 - due[i]) * 1e3)
                        i += 1
            b0 = sched.stats["batches"]
            with spans("frontend.drain"):
                sched.drain(force=False)
            if sched.stats["batches"] == b0 and i < n_req:
                wait = min(due[i] - (time.perf_counter() - t0), 0.0005)
                if wait > 0:
                    with spans("frontend.wait"):
                        time.sleep(wait)
        with spans("frontend.drain"):
            sched.drain(force=True)
        end = time.perf_counter()
    return Window(t0, end, sent, late)
