"""BENCHMARK.json against the benchmark's rules, and every name in it
resolving to its files."""

import json

import pytest

from bench import manifest


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def test_bench_manifest_has_no_problems(m):
    assert manifest.problems(m) == []


def test_bench_every_cell_resolves(m):
    for w in m["workloads"]:
        c = manifest.cell(w["name"], m)
        assert c.config["name"] == w["config"]
        assert {"k", "mix_seed", "query_pool", "request_rows", "arrivals",
                "max_wait_s"} <= set(c.traffic)
        assert {"sample_queries", "bad", "unserved", "gap", "dist_err"} == set(c.limits)
        names = [e["name"] for e in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_bench_every_reader_loads(m):
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"]))


def test_bench_configs_state_their_cuts(m):
    for c in m["configs"]:
        f = json.loads((manifest.ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        changed = [k for k, v in f["published"].items() if f[k] != v]
        assert sorted(changed) == sorted(c["reduced"])
        assert f["rows"] % (f["service"]["shards"] * f["service"]["wave"]) == 0
        assert f["assumed"]


@pytest.mark.parametrize("name,ok", [
    ("deep1m.batch", True), ("_x-1.y", True), ("a" * 64, True), ("a" * 65, False),
    ("has space", False), ("a,b", False), ("a/b", False), (".lead", False), ("µs", False)])
def test_bench_name_rule(name, ok):
    assert bool(manifest.NAME.match(name)) == ok


@pytest.mark.parametrize("unit,ok", [
    ("queries/s", True), ("%", True), ("ms", True), ("ratio", True), ("tokens per s", False),
    ("µs", False), ("", False), ("a" * 17, False)])
def test_bench_unit_rule(unit, ok):
    assert bool(manifest.UNIT.match(unit)) == ok


@pytest.mark.parametrize("edit,needle", [
    (lambda m: m["end_to_end"][0].update(why="x"), "keys"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"][0].update(source="program_counter"), "source"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["per_layer"][0].update(unit="per cent"), "unit"),
    (lambda m: m["workloads"][1].update(config="deep1m"), "pair"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
    (lambda m: m["workloads"][0].update(traffic="nosuch"), "traffic"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
])
def test_bench_manifest_refuses(m, edit, needle):
    bad = json.loads(json.dumps(m))
    edit(bad)
    assert any(needle in p for p in manifest.problems(bad))
