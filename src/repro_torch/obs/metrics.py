"""Metrics registry: counters, gauges, fixed-bucket histograms (port of
``repro.obs.metrics``; the metric names and the snapshot bytes are the
reference's, so ``scripts/check_metrics_schema.py`` reads the port's
snapshots unchanged).

The serving routes' byte ledgers (``FusedScanStats``, ``GraphScanStats``)
reach one sink through the bridge functions (``record_fused_scan`` and
friends), which map each stats family onto stable dotted metric names.

  * **Dependency-free.**  Pure stdlib, so the module imports anywhere;
    the bridges duck-type the stats NamedTuples (attribute access only).
  * **Mergeable snapshots.**  ``snapshot()`` returns a plain JSON-able
    dict; ``merge_snapshots`` combines any number of them (counters and
    histogram bucket counts add, gauges keep the last writer).
  * **Fail-fast names.**  Metric names are dotted lowercase identifiers;
    re-registering a name as a different type (or a histogram with
    different bounds) raises, naming the colliding key.

The sharded-graph bridge (``record_graph_sharded``) adds the per-shard
fetch counters, the exchange ledger and the failover counters.
"""

from __future__ import annotations

import re

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_snapshots",
    "LATENCY_BUCKETS_MS", "WAVE_DEPTH_BUCKETS",
    "record_fused_scan", "record_graph_scan", "record_graph_sharded",
    "record_fused_serve_totals",
    "record_dco_method", "DCO_METHODS", "record_mutations", "record_drift",
]

_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")

# Default request-latency bucket bounds (milliseconds): geometric-ish from
# 100 us to a minute.  The +inf overflow bucket is implicit.
LATENCY_BUCKETS_MS = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

# Wave-depth bucket bounds for ``serve.wave.depth`` (waves a query walked
# before retiring under continuous batching): powers of two up to the
# ``max_waves`` budget ceiling the graph engines default to.
WAVE_DEPTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class Counter:
    """Monotonic accumulator.  ``add`` rejects negative deltas."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, delta: float = 1.0) -> "Counter":
        delta = float(delta)
        if delta < 0.0:
            raise ValueError(
                f"counter {self.name!r}: negative delta {delta} (counters "
                f"are monotonic; use a gauge for level quantities)")
        self.value += delta
        return self

    def to_snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-writer-wins level quantity (a rate, a config echo, a ratio)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> "Gauge":
        self.value = float(value)
        return self

    def to_snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with an implicit +inf overflow bucket.

    ``bounds`` are strictly increasing upper edges; an observation lands in
    the first bucket whose bound is >= the value.  Fixed buckets (vs
    reservoirs) keep snapshots mergeable by plain addition — the property
    the per-shard rollup needs.
    """

    __slots__ = ("name", "bounds", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, bounds):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError(f"histogram {self.name_of(name)}: empty bounds")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name!r}: bounds must be strictly increasing, "
                f"got {bounds}")
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = overflow
        self.sum = 0.0
        self.count = 0

    @staticmethod
    def name_of(name):  # pragma: no cover - trivial
        return repr(name)

    def observe(self, value: float) -> "Histogram":
        value = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # bisect over the upper edges
            mid = (lo + hi) // 2
            if self.bounds[mid] >= value:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += value
        self.count += 1
        return self

    def percentile(self, p: float) -> float:
        """Bucket-resolved percentile estimate, ``p`` in [0, 100].

        Linear interpolation inside the covering bucket; observations in
        the overflow bucket report the last finite bound (a floor — the
        honest statement a fixed-bucket histogram can make).
        """
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile needs p in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                if i >= len(self.bounds):  # overflow bucket
                    return self.bounds[-1]
                lo_edge = self.bounds[i - 1] if i else 0.0
                frac = (rank - seen) / c
                return lo_edge + (self.bounds[i] - lo_edge) * frac
            seen += c
        return self.bounds[-1]

    def to_snapshot(self) -> dict:
        return {"type": "histogram", "bounds": list(self.bounds),
                "counts": list(self.counts), "sum": self.sum,
                "count": self.count}


class MetricsRegistry:
    """Named metric store with deterministic, mergeable snapshots."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} is not a dotted lowercase "
                f"identifier (segments of [a-z0-9_] joined by '.')")
        existing = self._metrics.get(name)
        if existing is None:
            metric = cls(name, *args)
            self._metrics[name] = metric
            return metric
        if type(existing) is not cls:
            raise ValueError(
                f"metric name collision on {name!r}: registered as "
                f"{existing.kind}, requested as {cls.kind}")
        if cls is Histogram:
            bounds = tuple(float(b) for b in args[0])
            if existing.bounds != bounds:
                raise ValueError(
                    f"metric name collision on {name!r}: histogram bounds "
                    f"{existing.bounds} != requested {bounds}")
        return existing

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=LATENCY_BUCKETS_MS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict snapshot, keys sorted — byte-for-byte deterministic
        for a given metric state, whatever the registration order."""
        return {name: self._metrics[name].to_snapshot()
                for name in sorted(self._metrics)}


def merge_snapshots(*snapshots: dict) -> dict:
    """Combine snapshot dicts: counters and histogram counts/sums add,
    gauges keep the LAST writer (document order).  Type or bucket-bound
    mismatches fail fast naming the key — silently adding a counter into a
    gauge is how fleet rollups lie."""
    out: dict = {}
    for snap in snapshots:
        for name, entry in snap.items():
            if name not in out:
                out[name] = {k: (list(v) if isinstance(v, list) else v)
                             for k, v in entry.items()}
                continue
            cur = out[name]
            if cur["type"] != entry["type"]:
                raise ValueError(
                    f"merge collision on {name!r}: {cur['type']} vs "
                    f"{entry['type']}")
            if entry["type"] in ("counter",):
                cur["value"] += entry["value"]
            elif entry["type"] == "gauge":
                cur["value"] = entry["value"]
            elif entry["type"] == "histogram":
                if list(cur["bounds"]) != list(entry["bounds"]):
                    raise ValueError(
                        f"merge collision on {name!r}: histogram bounds "
                        f"{cur['bounds']} != {entry['bounds']}")
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], entry["counts"])]
                cur["sum"] += entry["sum"]
                cur["count"] += entry["count"]
            else:
                raise ValueError(
                    f"merge collision on {name!r}: unknown metric type "
                    f"{entry['type']!r}")
    return {name: out[name] for name in sorted(out)}


# ---------------------------------------------------------------------------
# Ledger bridges: the existing stats families -> stable dotted names.
#
# Duck-typed on purpose (attribute access only): obs stays import-free of
# the index and quant packages, and any object carrying the documented
# fields (including a test double) feeds the same names.  The four ``dco.*.bytes``
# counters are the canonical accounting regimes of quant/accounting.py —
# semantic (dims-consumed), fetched (DMA-granular), gathered
# (row-granular), exchanged (cross-shard) — so a snapshot always reports
# the regime totals whichever engine produced them.
# ---------------------------------------------------------------------------


def record_fused_scan(reg: MetricsRegistry, st, *, queries: int) -> None:
    """Feed a ``FusedScanStats`` (fused IVF wave scan) into the registry."""
    qn = float(queries)
    reg.counter("dco.semantic.bytes").add(st.bytes_per_query * qn)
    reg.counter("dco.fetched.bytes").add(st.fetched_bytes_per_query * qn)
    reg.counter("ivf.fused.queries").add(qn)
    reg.counter("ivf.fused.rows").add(st.rows_per_query * qn)
    reg.counter("ivf.fused.passed").add(st.passed_per_query * qn)
    reg.counter("ivf.fused.s1_tiles_fetched").add(st.s1_tiles_fetched)
    reg.counter("ivf.fused.s2_slabs_total").add(st.s2_slabs_total)
    reg.counter("ivf.fused.s2_slabs_fetched").add(st.s2_slabs_fetched)
    reg.gauge("ivf.fused.s2_skip_rate").set(st.s2_skip_rate)


def record_graph_scan(reg: MetricsRegistry, st, *, queries: int) -> None:
    """Feed a ``GraphScanStats`` (single-replica beam scan) into the
    registry.  The gather ledger is this engine family's third regime."""
    qn = float(queries)
    reg.counter("dco.semantic.bytes").add(st.bytes_per_query * qn)
    reg.counter("dco.fetched.bytes").add(st.fetched_bytes_per_query * qn)
    reg.counter("dco.gathered.bytes").add(st.gather_bytes_per_query * qn)
    reg.counter("graph.scan.queries").add(qn)
    reg.counter("graph.scan.waves").add(st.waves)
    reg.counter("graph.scan.expansions").add(st.expansions_per_query * qn)
    reg.counter("graph.scan.rows").add(st.rows_per_query * qn)
    reg.counter("graph.scan.passed").add(st.passed_per_query * qn)
    reg.counter("graph.scan.s1_tiles_fetched").add(st.s1_tiles_fetched)
    reg.counter("graph.scan.s2_slabs_total").add(st.s2_slabs_total)
    reg.counter("graph.scan.s2_slabs_fetched").add(st.s2_slabs_fetched)
    reg.gauge("graph.scan.s2_skip_rate").set(st.s2_skip_rate)


def record_graph_sharded(reg: MetricsRegistry, st, *, queries: int) -> None:
    """Feed a ``GraphShardedStats`` (corpus-sharded beam scan) into the
    registry: the summed ledgers plus per-shard fetch counters (shards fetch
    concurrently, so capacity planning needs each shard's own stream) and
    the exchange ledger.  ``graph.sharded.shard<i>.fetched_bytes`` sum to
    ``dco.fetched.bytes``'s contribution when threshold seeding is off (the
    serving default); the schema check asserts it."""
    qn = float(queries)
    reg.counter("dco.semantic.bytes").add(st.bytes_per_query * qn)
    reg.counter("dco.fetched.bytes").add(st.fetched_bytes_per_query * qn)
    reg.counter("dco.exchanged.bytes").add(st.exchange_bytes_per_query * qn)
    reg.counter("graph.sharded.queries").add(qn)
    reg.counter("graph.sharded.waves").add(st.waves)
    reg.counter("graph.sharded.rows").add(st.rows_per_query * qn)
    reg.counter("graph.sharded.passed").add(st.passed_per_query * qn)
    reg.gauge("graph.sharded.num_shards").set(st.num_shards)
    reg.gauge("graph.sharded.s2_skip_rate").set(st.s2_skip_rate)
    reg.gauge("graph.sharded.exchange_bytes_per_wave").set(st.exchange_bytes_per_wave)
    for s, per_q in enumerate(st.shard_fetched_bytes_per_query):
        reg.counter(f"graph.sharded.shard{s}.fetched_bytes").add(per_q * qn)
        reg.counter(f"graph.sharded.shard{s}.s1_tiles_fetched").add(
            st.shard_s1_tiles_fetched[s])
        reg.counter(f"graph.sharded.shard{s}.s2_slabs_fetched").add(
            st.shard_s2_slabs_fetched[s])
    # Failover telemetry: only when the batch ran with tombstoned nodes.
    if getattr(st, "tombstoned_nodes", 0):
        reg.counter("graph.sharded.degraded.queries").add(qn)
        reg.gauge("graph.sharded.degraded.tombstoned_nodes").set(st.tombstoned_nodes)
        reg.gauge("graph.sharded.degraded.num_dead").set(float(len(st.dead_shards)))


def record_mutations(reg: MetricsRegistry, ledger, *,
                     tombstones: int | None = None) -> None:
    """Feed a ``MutationLedger`` (``index.mutable``) into the registry as
    the ``mutate.*`` family, once per snapshot (the ledger is cumulative).
    The family closes by construction, and the schema check holds the
    snapshot to ``mutate.applied == mutate.upserts + mutate.deletes +
    mutate.rejected``; ``tombstones`` (live deleted rows) is a gauge."""
    reg.counter("mutate.applied").add(ledger.applied)
    reg.counter("mutate.upserts").add(ledger.upserts)
    reg.counter("mutate.deletes").add(ledger.deletes)
    reg.counter("mutate.rejected").add(ledger.rejected)
    reg.counter("mutate.requantize").add(ledger.requantizes)
    if tombstones is not None:
        reg.gauge("mutate.tombstones").set(float(tombstones))


def record_drift(reg: MetricsRegistry, watchdog) -> None:
    """Feed a ``DriftWatchdog`` (``index.mutable``) into the registry as
    the ``calib.drift.*`` family, once per snapshot: checks taken,
    threshold crossings, completed swaps, chaos-suppressed swaps, swaps
    refused by the parity proof, and ``calib.drift.stat``, the last worst
    non-final-checkpoint violation rate."""
    reg.counter("calib.drift.checks").add(watchdog.checks)
    reg.counter("calib.drift.fired").add(watchdog.fired)
    reg.counter("calib.drift.recalibrations").add(watchdog.recalibrations)
    reg.counter("calib.drift.suppressed").add(watchdog.suppressed)
    reg.counter("calib.drift.parity_failed").add(watchdog.parity_failed)
    reg.gauge("calib.drift.stat").set(float(watchdog.last_stat))


def record_fused_serve_totals(reg: MetricsRegistry, *, s1_tiles: float,
                              s2_slabs: float, s1_bytes: float,
                              s2_bytes: float, sem_bytes: float) -> None:
    """Feed the flat fused serving route's scan-counter totals (the (6,)
    ``STATS_COLS`` vector the search step sums) into the registry —
    the serve driver computes the byte figures with the same
    ``accounting.py`` helpers it prints."""
    reg.counter("ivf.fused.s1_tiles_fetched").add(s1_tiles)
    reg.counter("ivf.fused.s2_slabs_fetched").add(s2_slabs)
    reg.counter("dco.semantic.bytes").add(sem_bytes)
    reg.counter("dco.fetched.bytes").add(s1_bytes + s2_bytes)


# DCO methods a snapshot may be tagged with — the serving CLI surface plus
# the host-only fixed-dim baselines.  scripts/check_metrics_schema.py
# mirrors this list (pure stdlib, can't import us).
DCO_METHODS = ("fdscanning", "adsampling", "dade", "pca_fixed", "rp_fixed")


def record_dco_method(reg: MetricsRegistry, method: str, *,
                      queries: float) -> None:
    """Tag the snapshot with the DCO method that served ``queries``.

    Metric names are the only dimension the dependency-free registry has
    (``_NAME_RE`` forbids label syntax on purpose — mergeability stays
    trivial), so the method rides in the name: ``dco.method.adsampling``
    counts queries answered under ADSampling tables.  Counters from
    different methods merge additively across snapshots like every other
    counter, so a mixed-fleet merge keeps the per-method breakdown."""
    if method not in DCO_METHODS:
        raise ValueError(
            f"unknown DCO method {method!r} for metrics tag; known: "
            f"{DCO_METHODS}")
    reg.counter(f"dco.method.{method}").add(queries)
