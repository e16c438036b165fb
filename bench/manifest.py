"""``BENCHMARK.json`` and the files its names resolve to.

A cell (an entry of ``workloads``) names a configuration (its ``file``), a
traffic mix (``bench/traffic/<traffic>.json``) and, through the metric
lists, the readers ``bench/metrics/<metric>.py``; its limits of
``correct`` are ``bench/checks/<cell>.json``.  Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "bench" / "traffic" / f"{name}.json"


def checks_path(cell: str, root: Path = ROOT) -> Path:
    return root / "bench" / "checks" / f"{cell}.json"


def reader_path(metric: str, root: Path = ROOT) -> Path:
    return root / "bench" / "metrics" / f"{metric}.py"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, m: dict | None = None, root: Path = ROOT) -> Cell:
    m = load(root) if m is None else m
    (w,) = [w for w in m["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (c,) = [c for c in m["configs"] if c["name"] == w["config"]]
    return Cell(name=name, chips=w["chips"], config=_json(root / c["file"]),
                traffic=_json(traffic_path(w["traffic"], root)),
                limits=_json(checks_path(name, root)),
                end_to_end=[e for e in m["end_to_end"] if _applies(e, name)],
                per_layer=[e for e in m["per_layer"] if _applies(e, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of a metric's reader file."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(m: dict, root: Path = ROOT) -> list[str]:
    """Breaches of the benchmark's rules in ``m`` (empty: none)."""
    out = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
    names = set()
    for group, keys in KEYS.items():
        for e in m.get(group, []):
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer")
                                     else set())
            if set(e) & keys != keys or extra:
                out.append(f"{group} entry {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                out.append(f"{group} name {e.get('name')!r}")
            if (group, e.get("name")) in names:
                out.append(f"{group} name {e.get('name')!r} twice")
            names.add((group, e.get("name")))
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                v = e.get(key)
                if key in e and (not 1 <= len(v) <= 200 or "\n" in v or "\t" in v):
                    out.append(f"{group} {e.get('name')}: {key} of {len(v)} characters")
    workloads = {w["name"] for w in m.get("workloads", [])}
    configs = {c["name"]: c for c in m.get("configs", [])}
    e2e = {e["name"] for e in m.get("end_to_end", [])}
    for c in configs.values():
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"config {c['name']}: reduced key {key!r}")
    for w in m.get("workloads", []):
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']!r}")
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"workload {w['name']}: {key} {w[key]!r}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if not traffic_path(w["traffic"], root).is_file():
            out.append(f"workload {w['name']}: no traffic file for {w['traffic']!r}")
        if not checks_path(w["name"], root).is_file():
            out.append(f"workload {w['name']}: no checks file")
    pairs = [(w["config"], w["traffic"]) for w in m.get("workloads", [])]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    for group in ("end_to_end", "per_layer"):
        for e in m.get(group, []):
            if not UNIT.match(e["unit"]):
                out.append(f"{e['name']}: unit {e['unit']!r}")
            if e["better"] not in ("lower", "higher"):
                out.append(f"{e['name']}: better {e['better']!r}")
            if e["source"] not in (E2E_SOURCES if group == "end_to_end" else SOURCES):
                out.append(f"{e['name']}: source {e['source']!r}")
            if set(e.get("workloads", workloads)) - workloads:
                out.append(f"{e['name']}: workloads outside the cells")
            if not reader_path(e["name"], root).is_file():
                out.append(f"{e['name']}: no reader file")
    for e in m.get("end_to_end", []):
        if not 0 < e["bound"] <= 0.25:
            out.append(f"{e['name']}: bound {e['bound']}")
    for e in m.get("per_layer", []):
        if e["moves"] not in e2e:
            out.append(f"{e['name']}: moves {e['moves']!r}, not an end-to-end metric")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for w in workloads:
        mine = [e for e in m.get("end_to_end", []) if _applies(e, w)]
        if "setup_s" not in {e["name"] for e in mine} or len(mine) < 2:
            out.append(f"workload {w}: needs setup_s and another end-to-end metric")
        if not [e for e in m.get("per_layer", []) if _applies(e, w)]:
            out.append(f"workload {w}: no per-layer metric")
    return out
