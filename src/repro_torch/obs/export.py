"""Exporters: Chrome-trace/Perfetto JSON, metrics envelopes, provenance
(port of ``repro.obs.export``).

The trace format is the Trace Event JSON Array Format's object form —
``{"traceEvents": [...]}`` with ``"ph": "X"`` complete events (``ts`` and
``dur`` in microseconds) — which both chrome://tracing and ui.perfetto.dev
open directly.  Spans all live on one pid/tid; nesting is conveyed by
timestamp containment.

The metrics envelope is the schema ``scripts/check_metrics_schema.py``
validates: versioned, carrying the run's provenance and a config echo next
to the snapshot so a stored file is attributable without its command
line.
"""

from __future__ import annotations

import datetime
import json
import subprocess

__all__ = ["SCHEMA_VERSION", "provenance", "chrome_trace",
           "write_chrome_trace", "metrics_envelope", "write_metrics_json",
           "span_totals"]

SCHEMA_VERSION = 1


def provenance() -> dict:
    """Best-effort run attribution: git sha, the torch and CUDA versions,
    the card's name (``cpu`` without one), ISO date.  ``jax_version`` is
    ``"unavailable"``, the reference's own placeholder without JAX: the
    schema requires the key and the port never imports JAX.  Every field
    degrades to a placeholder rather than raising."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except Exception:
        sha = "unknown"
    try:
        import torch
        torch_version = torch.__version__
        cuda_version = torch.version.cuda or "none"
        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")
    except Exception:
        torch_version = cuda_version = device_kind = "unavailable"
    return {
        "git_sha": sha,
        "jax_version": "unavailable",
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "device_kind": device_kind,
        "date": datetime.datetime.now(datetime.timezone.utc)
                .strftime("%Y-%m-%dT%H:%M:%SZ"),
    }


def chrome_trace(tracer) -> dict:
    """Convert a ``Tracer``'s event list to a Chrome-trace dict.

    Timestamps are rebased to the first event so traces start near t=0
    (Perfetto renders absolute perf_counter_ns origins as a day-long empty
    prefix otherwise).  Instant events become ``"ph": "i"`` with
    thread scope — visible as annotation ticks inside their parent span.
    """
    events = tracer.events
    t0 = min((e["ts"] for e in events), default=0)
    out = []
    for e in events:
        rec = {
            "name": e["name"],
            "ph": e["ph"],
            "ts": (e["ts"] - t0) / 1000.0,  # ns -> us
            "pid": 0,
            "tid": 0,
        }
        if e["ph"] == "X":
            rec["dur"] = e["dur"] / 1000.0
        else:
            rec["s"] = "t"
        if e.get("args"):
            rec["args"] = e["args"]
        out.append(rec)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": dict(getattr(tracer, "meta", {}) or {},
                          **{"schema_version": SCHEMA_VERSION}),
    }


def write_chrome_trace(tracer, path: str) -> dict:
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def span_totals(tracer, *, arg_keys: tuple = ()) -> dict:
    """Aggregate the trace by span name: total duration (ms), count, and
    summed numeric args for ``arg_keys`` (byte attributions summed against
    the stats ledgers, per-stage timings from a capture)."""
    totals: dict[str, dict] = {}
    for e in tracer.events:
        row = totals.setdefault(e["name"], {
            "count": 0, "total_ms": 0.0,
            **{k: 0.0 for k in arg_keys}})
        row["count"] += 1
        if e["ph"] == "X":
            row["total_ms"] += e["dur"] / 1e6
        for k in arg_keys:
            v = e.get("args", {}).get(k)
            if isinstance(v, (int, float)):
                row[k] += v
    return totals


def metrics_envelope(registry, *, config: dict | None = None,
                     extra: dict | None = None) -> dict:
    """Schema-versioned machine-readable snapshot: provenance + config echo
    + the registry snapshot (``scripts/check_metrics_schema.py`` holds the
    contract)."""
    doc = {
        "schema_version": SCHEMA_VERSION,
        "provenance": provenance(),
        "config": dict(config or {}),
        "metrics": registry.snapshot(),
    }
    if extra:
        doc.update(extra)
    return doc


def write_metrics_json(registry, path: str, *, config: dict | None = None,
                       extra: dict | None = None) -> dict:
    doc = metrics_envelope(registry, config=config, extra=extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc
