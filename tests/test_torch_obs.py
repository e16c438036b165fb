"""Port parity for the telemetry layer: ``repro_torch.obs`` against
``repro.obs`` on the same calls (snapshot and merge bytes, the ledger
bridges on equal stats), the Chrome-trace structure, the spans the port's
routes open, and the null tracer's promise to add no synchronisation."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.obs as j_obs  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
from _torch_carry import carry_graph, carry_ivf  # noqa: E402
from repro.index.graph import GraphScanStats as JGraphScanStats  # noqa: E402
from repro.index.ivf import FusedScanStats as JFusedScanStats  # noqa: E402
from repro.index.ivf import search_ivf_fused as j_search_ivf  # noqa: E402
from repro_torch.index.graph import GraphScanStats, search_graph_fused  # noqa: E402
from repro_torch.index.ivf import FusedScanStats, search_ivf_fused  # noqa: E402
from repro_torch.launch.annservice import ContinuousGraphEngine  # noqa: E402
from repro_torch.obs.trace import current_tracer  # noqa: E402


def _drive(obs):
    """One sequence of registry calls, made against either package."""
    reg = obs.MetricsRegistry()
    reg.counter("serve.requests.submitted").add(3).add(2)
    reg.gauge("serve.report.qps").set(1234.5)
    h = reg.histogram("serve.request.latency_ms")
    for v in (0.05, 0.7, 3.0, 3.0, 250.0, 1e5):
        h.observe(v)
    d = reg.histogram("serve.wave.depth", obs.metrics.WAVE_DEPTH_BUCKETS)
    for v in (1, 7, 24, 200):
        d.observe(v)
    obs.record_dco_method(reg, "dade", queries=5)
    return reg, h


def test_snapshot_bytes_equal_reference():
    (reg_t, h_t), (reg_j, h_j) = _drive(t_obs), _drive(j_obs)
    assert json.dumps(reg_t.snapshot(), sort_keys=True) == json.dumps(
        reg_j.snapshot(), sort_keys=True)
    for p in (0, 37.5, 50, 95, 99, 100):
        assert h_t.percentile(p) == h_j.percentile(p)
    assert t_obs.LATENCY_BUCKETS_MS == j_obs.LATENCY_BUCKETS_MS
    assert t_obs.DCO_METHODS == j_obs.DCO_METHODS


def test_merge_equal_reference_and_fails_alike():
    snaps_t = [_drive(t_obs)[0].snapshot() for _ in range(3)]
    snaps_j = [_drive(j_obs)[0].snapshot() for _ in range(3)]
    assert t_obs.merge_snapshots(*snaps_t) == j_obs.merge_snapshots(*snaps_j)
    bad = {"serve.report.qps": {"type": "counter", "value": 1.0}}
    for obs, snaps in ((t_obs, snaps_t), (j_obs, snaps_j)):
        with pytest.raises(ValueError, match="serve.report.qps"):
            obs.merge_snapshots(snaps[0], bad)
    with pytest.raises(ValueError, match="dotted"):
        t_obs.MetricsRegistry().counter("Bad.Name")


def test_ledger_bridges_equal_reference():
    """The bridges map the port's stats families onto the reference's names
    and values: equal stats give byte-equal snapshots."""
    g = dict(waves=12.0, expansions_per_query=20.5, rows_per_query=310.0,
             avg_int8_dims=64.0, avg_fp_dims=21.25, passed_per_query=14.0,
             bytes_per_query=41000.0, fetched_bytes_per_query=93000.0,
             gather_bytes_per_query=250000.0, s1_tiles_fetched=1640.0,
             s2_slabs_total=6560.0, s2_slabs_fetched=900.0, s2_skip_rate=0.86)
    f = dict(avg_fp_dims=12.0, avg_int8_dims=70.0, rows_per_query=4000.0,
             bytes_per_query=300000.0, passed_per_query=33.0, s1_tiles_fetched=96.0,
             s2_slabs_total=384.0, s2_slabs_fetched=150.0, s2_skip_rate=0.61,
             fetched_bytes_per_query=800000.0)
    snaps = []
    for obs, GS, FS in ((t_obs, GraphScanStats, FusedScanStats),
                        (j_obs, JGraphScanStats, JFusedScanStats)):
        reg = obs.MetricsRegistry()
        obs.record_graph_scan(reg, GS(**g), queries=8)
        obs.record_fused_scan(reg, FS(**f), queries=3)
        obs.record_fused_serve_totals(reg, s1_tiles=10.0, s2_slabs=4.0, s1_bytes=5e5,
                                      s2_bytes=7e4, sem_bytes=1.5e5)
        snaps.append(json.dumps(reg.snapshot(), sort_keys=True))
    assert snaps[0] == snaps[1]


def test_chrome_trace_structure_and_totals():
    tr = t_obs.Tracer(tool="test")
    with tr.span("outer", a=1):
        with tr.span("inner") as sp:
            sp.annotate(bytes=10)
            tr.instant("tick", bytes=5)
        tr.annotate(extra=2)
    doc = t_obs.chrome_trace(tr)
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["outer"]["ph"] == "X" and ev["inner"]["ph"] == "X"
    assert ev["tick"]["ph"] == "i" and ev["tick"]["s"] == "t"
    assert min(e["ts"] for e in doc["traceEvents"]) == 0.0
    o, i = ev["outer"], ev["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert o["args"] == {"a": 1, "extra": 2} and i["args"] == {"bytes": 10}
    assert doc["otherData"] == {"tool": "test", "schema_version": 1}
    tot = t_obs.span_totals(tr, arg_keys=("bytes",))
    assert tot["inner"]["bytes"] == 10 and tot["tick"]["bytes"] == 5
    assert tot["outer"]["count"] == 1 and tot["outer"]["total_ms"] >= tot["inner"]["total_ms"]
    with t_obs.use_tracer(tr):
        assert current_tracer() is tr
    assert current_tracer() is t_obs.NULL_TRACER


def test_envelope_provenance_without_jax(tmp_path):
    reg = t_obs.MetricsRegistry()
    reg.counter("serve.queries").add(4)
    doc = t_obs.write_metrics_json(reg, str(tmp_path / "m.json"), config={"k": 10},
                                   extra={"report": {"queries": 4}})
    prov = doc["provenance"]
    assert prov["jax_version"] == "unavailable"
    assert prov["torch_version"] == torch.__version__
    assert prov["device_kind"] == ("cpu" if not torch.cuda.is_available()
                                   else torch.cuda.get_device_name())
    assert set(j_obs.metrics_envelope(j_obs.MetricsRegistry())) == set(doc) - {"report"}
    assert json.load(open(tmp_path / "m.json")) == doc


def _no_sync(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    return calls


def test_null_tracer_adds_no_synchronisation(graph_idx, queries, monkeypatch):
    """The untraced path never waits for the card: the null tracer's fence
    is the identity and its spans are one shared object; the recording
    tracer waits only on CUDA tensors."""
    calls = _no_sync(monkeypatch)
    port = carry_graph(graph_idx[1])
    q = np.asarray(queries)[:8]
    assert current_tracer() is t_obs.NULL_TRACER
    assert t_obs.NULL_TRACER.span("a") is t_obs.NULL_TRACER.span("b")
    x = torch.ones(3)
    assert t_obs.NULL_TRACER.fence(x) is x
    search_graph_fused(port, q, k=10, device="cpu")
    eng = ContinuousGraphEngine(port, k=10, ef=48)
    eng.admit(q[0])
    while eng.live_count():
        eng.step()
    assert calls == []
    tr = t_obs.Tracer()
    with t_obs.use_tracer(tr):
        search_graph_fused(port, q, k=10, device="cpu")
        assert tr.fence((x, [x], {"a": x})) is not None
    assert calls == []  # CPU tensors are done when the host has them


def test_route_spans_and_byte_instants(graph_idx, fused_idx, queries):
    """The graph batch route opens prologue / launch (with the walk's waves)
    / readback; the IVF search route / seed / launch, and its byte instants
    sum to the ledger's fetched bytes; a continuous wave opens one
    ``continuous.wave`` per launch."""
    port = carry_graph(graph_idx[1])
    q = np.asarray(queries)[:16]
    tr = t_obs.Tracer()
    with t_obs.use_tracer(tr):
        _, _, st = search_graph_fused(port, q, k=10, device="cpu")
    names = [e["name"] for e in tr.events]
    assert names == ["graph.prologue", "graph.launch", "graph.readback"]
    assert tr.events[1]["args"]["waves"] == st.waves

    pivf = carry_ivf(fused_idx)
    tr = t_obs.Tracer()
    with t_obs.use_tracer(tr):
        _, _, st = search_ivf_fused(pivf, q, k=10, n_probe=6)
    assert [e["name"] for e in tr.events if e["ph"] == "X"] == [
        "ivf.route", "ivf.seed", "ivf.launch"]
    tot = t_obs.span_totals(tr, arg_keys=("bytes",))
    ledger = st.fetched_bytes_per_query - (pivf.capacity * pivf.seed_codes.shape[1]
                                           + 4 * 10 * pivf.flat_rot.shape[1])
    assert tot["ivf.stage1_dma"]["bytes"] + tot["ivf.stage2"]["bytes"] == pytest.approx(
        ledger * len(q), rel=1e-12)
    _, _, j_st = j_search_ivf(fused_idx, jnp.asarray(q), k=10, n_probe=6, use_ref=True)
    assert st.fetched_bytes_per_query == j_st.fetched_bytes_per_query

    tr = t_obs.Tracer()
    eng = ContinuousGraphEngine(port, k=10, ef=48)
    with t_obs.use_tracer(tr):
        for row in q[:3]:
            eng.admit(row)
        steps = 0
        while eng.live_count():
            eng.step()
            steps += 1
    tot = t_obs.span_totals(tr)
    assert tot["continuous.wave"]["count"] == steps - 1  # the last wave retires only
    assert tot["continuous.select"]["count"] == steps
