"""The port's serve CLI on the CPU at test size, route by route — flat,
graph, and graph ``--continuous`` (closed loop, and open loop under a
deadline, a watermark, retries and a ``step_error`` drill) — each run's
``--metrics-json`` held to ``scripts/check_metrics_schema.py`` unchanged,
run as a subprocess; and the reference's flags for routes the port does
not serve, refused by name."""

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


@pytest.mark.parametrize("argv", [
    ["--graph-shards", "2"], ["--verify-degraded-oracle"], ["--index-ckpt", "ckpt"],
    ["--mutate-rate", "0.5"], ["--wal", "log"], ["--continuous"],
], ids=lambda a: a[0])
def test_unported_flags_refused_by_name(argv, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert argv[0] in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["shard_death:shard=0", "slab_corruption", "torn_upsert",
                                  "stale_transform"])
def test_unported_fault_kinds_refused_by_name(kind, graph):
    with pytest.raises(SystemExit, match=kind.split(":")[0]):
        serve.main(GRAPH + ["--chaos", kind], graph=graph)
