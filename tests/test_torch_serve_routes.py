"""The port's serve CLI on the CPU at test size, route by route — flat
(fused, ``--fused off`` and ``--quant none``), graph, graph
``--continuous`` (closed loop, and open loop under a deadline, a
watermark, retries and a ``step_error`` drill) and the churn route
(``--mutate-rate`` with its write-ahead log, a ``torn_upsert`` crash and
``--verify-graph-oracle``) — each run's ``--metrics-json`` held to
``scripts/check_metrics_schema.py`` unchanged, run as a subprocess; the
``--index-ckpt`` round trips of the flat and graph routes (and the
``slab_corruption`` drill's fallback); and the reference's flag rules and
the flags that do not apply to a route, refused by name."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.dade_ivf import ServiceConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLAT = ["--device", "cpu", "--requests", "2", "--corpus", "2048", "--dim", "64",
        "--batch", "16", "--k", "10", "--wave", "256", "--delta-d", "16"]
GRAPH = ["--index", "graph", "--device", "cpu", "--requests", "2", "--corpus", "1024",
         "--dim", "64", "--batch", "16", "--k", "10", "--delta-d", "16"]


@pytest.fixture(scope="module")
def graph():
    svc = ServiceConfig(corpus_per_device=1024, dim=64, query_batch=16, k=10,
                        delta_d=16)
    return serve.prepare_graph(svc, "dade", m=16, ef=48, device="cpu")


def _schema(path):
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                          str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(Path(path).read_text())


@pytest.mark.parametrize("route", ["flat", "graph", "continuous"])
def test_route_metrics_pass_schema(route, graph, tmp_path, capsys):
    path = tmp_path / "metrics.json"
    argv = {"flat": FLAT, "graph": GRAPH,
            "continuous": GRAPH + ["--continuous", "--max-live", "8",
                                   "--verify-graph-oracle"]}[route]
    report = serve.main(argv + ["--metrics-json", str(path)],
                        graph=None if route == "flat" else graph)
    doc = _schema(path)
    m = doc["metrics"]
    assert doc["provenance"]["jax_version"] == "unavailable"
    assert doc["report"]["queries"] == report["queries"] == m["serve.queries"]["value"]
    assert m["serve.requests.submitted"]["value"] == m["serve.requests.served"]["value"] == 2
    assert m["dco.method.dade"]["value"] == report["queries"]
    assert report["recall"] >= 0.9
    if route == "flat":
        assert m["ivf.fused.s1_tiles_fetched"]["value"] > 0
    else:
        assert m["graph.scan.queries"]["value"] > 0
    if route == "continuous":
        assert m["serve.admission.admitted"]["value"] == report["queries"]
        assert m["serve.wave.depth"]["count"] == report["queries"]
        assert "verify: continuous engine bit-identical" in capsys.readouterr().out


def test_continuous_open_loop_drill_closes_ledgers(graph, tmp_path, capsys):
    """Poisson arrivals, a step error absorbed by a retry, a deadline and a
    watermark: every request ends served or shed, every admission retires or
    is shed, and the snapshot still passes the schema check."""
    path = tmp_path / "metrics.json"
    trace = tmp_path / "trace.json"
    report = serve.main(GRAPH + ["--requests", "6", "--continuous", "--max-live", "16",
                                 "--open-loop", "200", "--deadline-ms", "60000",
                                 "--queue-watermark", "4096", "--retries", "2",
                                 "--retry-backoff-ms", "1", "--chaos", "step_error:count=2",
                                 "--metrics-json", str(path), "--trace", str(trace)],
                        graph=graph)
    m = _schema(path)["metrics"]
    assert report["retries"] == 2 and m["serve.fault.step_error"]["value"] == 2
    assert m["serve.requests.served"]["value"] == report["requests_served"] == 6
    assert m["serve.admission.admitted"]["value"] == m["serve.admission.retired"]["value"]
    assert 0 < m["serve.request.p50_ms"]["value"] <= m["serve.request.p99_ms"]["value"]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"serve.drive", "continuous.wave", "continuous.select"} <= names
    assert "latency_ms(p50=" in capsys.readouterr().out


def test_watermark_sheds_on_the_batch_graph_route(graph, tmp_path):
    path = tmp_path / "metrics.json"
    report = serve.main(GRAPH + ["--requests", "4", "--queue-watermark", "30",
                                 "--metrics-json", str(path)], graph=graph)
    m = _schema(path)["metrics"]
    assert m["serve.shed.queue"]["value"] > 0 and report["requests_shed"] > 0
    assert m["serve.requests.submitted"]["value"] == 4


@pytest.mark.parametrize("argv,says", [
    (["--graph-shards", "2"], "--index graph"),
    (["--verify-degraded-oracle"], "--index graph"),
    (["--mutate-rate", "0.5"], "requires --index graph"),
    (["--continuous"], "requires --index graph"),
], ids=lambda a: a[0] if isinstance(a, list) else "")
def test_unported_flags_refused_by_name(argv, says, capsys):
    """Refused by name: the sharded walk's flags, churn and continuous
    batching off the graph route (the reference's own rules for the last
    two)."""
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    err = capsys.readouterr().err
    assert argv[0] in err and says in err


@pytest.mark.parametrize("kind", ["shard_death:shard=0"])
def test_unported_fault_kinds_refused_by_name(kind, graph):
    """A shard death needs shards to kill: refused by name on the
    single-replica graph route."""
    with pytest.raises(SystemExit, match=kind.split(":")[0]):
        serve.main(GRAPH + ["--chaos", kind], graph=graph)


def test_churn_refuses_continuous_and_shards(capsys):
    """The reference's churn rules: one replica, not beside --continuous."""
    for extra in (["--continuous"], ["--graph-shards", "2"]):
        with pytest.raises(SystemExit):
            serve.parse_args(["--index", "graph", "--mutate-rate", "2"] + extra)
        assert "--mutate-rate" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [["--fused", "off"], ["--quant", "none"]],
                         ids=["fused_off", "quant_none"])
def test_unfused_flat_routes_served(mode, tmp_path):
    """The reference's unfused routes on one card: served, recall as the
    fused route's, metrics through the schema check."""
    path = tmp_path / "metrics.json"
    report = serve.main(FLAT + mode + ["--metrics-json", str(path)])
    m = _schema(path)["metrics"]
    assert report["requests_served"] == 2 and report["recall"] >= 0.9
    assert m["serve.queries"]["value"] == report["queries"]
    assert "ivf.fused.s1_tiles_fetched" not in m


# The reference's CI churn drill (docs/SERVING.md §7), on the CPU.
CHURN = ["--index", "graph", "--device", "cpu", "--corpus", "600", "--dim", "48",
         "--requests", "5", "--batch", "16", "--ef", "32", "--delta-d", "32",
         "--mutate-rate", "6", "--verify-graph-oracle"]


def test_churn_drill_recovers_torn_upsert_and_matches_rebuild(tmp_path, capsys):
    """The churn drill: 30 mutations write-ahead logged, a torn append after
    one batch, recovery by rebuild and replay, and the post-churn index
    returning the ids of a rebuild of the final corpus; the snapshot passes
    the schema check with a closed ``mutate.*`` ledger."""
    path = tmp_path / "metrics.json"
    wal = tmp_path / "churn_wal" / "mutations.wal"
    report = serve.main(CHURN + ["--wal", str(wal), "--chaos", "torn_upsert:after=1",
                                 "--metrics-json", str(path)])
    m = _schema(path)["metrics"]
    out = capsys.readouterr().out
    assert "(torn tail truncated)" in out and "verify-churn:" in out
    assert report["verified"] and report["wal_recovered_torn"] == 1
    assert report["requests_served"] == 5 and report["recall"] >= 0.9
    assert m["mutate.applied"]["value"] == (m["mutate.upserts"]["value"]
                                           + m["mutate.deletes"]["value"]
                                           + m["mutate.rejected"]["value"]) == 30
    assert m["serve.fault.torn_upsert"]["value"] == 1
    assert m["serve.wal.recovered_torn"]["value"] == 1
    assert m["calib.drift.checks"]["value"] >= 1
    assert report["boots"] == 2


def test_churn_replays_an_existing_log_at_boot(tmp_path, capsys):
    """A second serve over the first's log replays it onto a fresh base
    before serving (the crash-recovery path at start-up), and logs its own
    mutations after the replayed ones."""
    wal = tmp_path / "m.wal"
    argv = CHURN[:-1] + ["--requests", "2", "--wal", str(wal)]
    first = serve.main(argv)
    second = serve.main(argv)
    out = capsys.readouterr().out
    assert "wal: replayed" in out
    assert second["upserts"] + second["deletes"] > first["upserts"] + first["deletes"]
    from repro_torch.checkpoint.wal import MutationLog
    assert MutationLog(str(wal)).seq == first["wal_records"] + second["wal_records"]


def test_churn_stale_transform_drill_suppresses_swaps(tmp_path):
    """Under ``stale_transform`` the watchdog may fire but never swaps."""
    report = serve.main(CHURN[:-1] + ["--requests", "3", "--chaos", "stale_transform"])
    assert report["drift_recalibrations"] == 0
    assert report["drift_suppressed"] == report["drift_fired"]


def test_flat_index_ckpt_saves_then_restores(tmp_path, capsys):
    """The flat route's estimator snapshot: the first serve saves it, the
    second restores it and serves the same ids; a corrupted leaf falls back
    to recalibration."""
    ckpt = str(tmp_path / "ckpt")
    served = []

    def step_ids(argv):
        report = serve.main(FLAT + argv + ["--index-ckpt", ckpt])
        served.append(report)
        return report

    step_ids([])
    step_ids([])
    out = capsys.readouterr().out
    assert "saved estimator" in out and "restored estimator" in out
    assert served[0]["recall"] == served[1]["recall"]
    step_ids(["--chaos", "slab_corruption"])
    out = capsys.readouterr().out
    assert "digest mismatch" in out and "recalibrating" in out


def test_graph_index_ckpt_saves_then_restores(graph, tmp_path, capsys):
    """The graph route's whole-index snapshot: saved from the handed-in
    graph, restored by a serve that builds nothing, its searches equal to
    the original's bit for bit; the ``slab_corruption`` drill's digest
    failure names the leaf and falls back to a rebuild."""
    from repro_torch.checkpoint.index_io import load_graph_index
    from repro_torch.index.graph import search_graph_fused
    from repro_torch.data.pipeline import synthetic_queries
    ckpt = str(tmp_path / "ckpt")
    first = serve.main(GRAPH + ["--index-ckpt", ckpt], graph=graph)
    second = serve.main(GRAPH + ["--index-ckpt", ckpt])
    out = capsys.readouterr().out
    assert "saved graph index" in out and "restored graph index" in out
    assert first["recall"] == second["recall"]
    restored = load_graph_index(ckpt, device="cpu")
    q = synthetic_queries(16, 64, graph.corpus, seed=5)
    a = search_graph_fused(graph.index, q, k=10, device="cpu")
    b = search_graph_fused(restored, q, k=10, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
    third = serve.main(GRAPH + ["--index-ckpt", ckpt, "--chaos", "slab_corruption:leaf=3"],
                       graph=graph)
    out = capsys.readouterr().out
    assert "corrupted snapshot leaf 3" in out and "digest mismatch" in out
    assert "falling back to rebuild" in out and third["recall"] == first["recall"]
