"""Telemetry: metrics registry, span tracer, Chrome-trace/JSON export (port
of ``repro.obs``).

  * ``obs.metrics`` — counters / gauges / fixed-bucket histograms under the
    reference's dotted names, mergeable snapshots, and bridges from the
    port's stats families (``FusedScanStats``, ``GraphScanStats``,
    ``GraphShardedStats``).
  * ``obs.trace``   — explicit begin/end spans; ``fence`` waits for the
    card; disabled mode is a module-level null tracer that never waits.
  * ``obs.export``  — Perfetto-loadable Chrome-trace JSON, the
    schema-versioned metrics envelope, and run provenance.

Stdlib-only at import.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, merge_snapshots,
    LATENCY_BUCKETS_MS, WAVE_DEPTH_BUCKETS, record_fused_scan,
    record_graph_scan, record_graph_sharded, record_fused_serve_totals, record_dco_method,
    DCO_METHODS, record_mutations, record_drift,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer, NullTracer, NULL_TRACER, current_tracer, set_tracer, use_tracer,
)
from repro_torch.obs.export import (  # noqa: F401
    SCHEMA_VERSION, provenance, chrome_trace, write_chrome_trace,
    metrics_envelope, write_metrics_json, span_totals,
)
