#!/usr/bin/env python3
"""Served QPS of this tree's and another tree's ``repro_torch.launch.serve``
in one process, on one card, in turns.

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 tools/serve_trees.py build/other

Both trees' packages are imported side by side (each under the module
name ``repro_torch``, swapped in and out of ``sys.modules``), and each
builds its own kernels into its own ``src/repro_torch/kernels/build/``.
Two routes, each at ``chip_smoke.py``'s settings with telemetry off:
flat serving at the ``dade_ivf`` configuration (40 requests, the default
shard count; phase 4) and graph serving on one 32,768 x 256 NSW graph
built once by this tree and handed to both (200 requests; phase 8).  Per
route, rounds of other, this, this, other: each run a full ``serve.main``
(its warm-up outside the clock), printing its QPS; then each tree's
median.  Prints the card's name and power limit first.  Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2
FLAT = ["--device", "cuda", "--requests", "40"]
GRAPH = ["--index", "graph", "--device", "cuda", "--requests", "200", "--k", "10",
         "--batch", "1024", "--delta-d", "64", "--p-s", "0.02", "--ef", "48",
         "--expand", "2", "--m", "16"]


def _own(name: str) -> bool:
    return name == "repro_torch" or name.startswith("repro_torch.")


def _take() -> dict:
    return {k: sys.modules.pop(k) for k in [k for k in sys.modules if _own(k)]}


@contextlib.contextmanager
def using(mods: dict):
    """Run with ``mods`` (a tree's ``repro_torch`` modules) in
    ``sys.modules``, keeping any it imports on the way."""
    saved = _take()
    sys.modules.update(mods)
    try:
        yield
    finally:
        mods.update(_take())
        sys.modules.update(saved)


def load_serve(tree: Path):
    """``tree``'s ``repro_torch.launch.serve`` and the modules it imported."""
    mods: dict = {}
    sys.path.insert(0, str(tree / "src"))
    try:
        with using(mods):
            serve = importlib.import_module("repro_torch.launch.serve")
    finally:
        sys.path.remove(str(tree / "src"))
    return serve, mods


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_trees: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    trees = {"other": load_serve(Path(sys.argv[1]).resolve()), "this": load_serve(ROOT)}
    serve = trees["this"][0]
    svc = serve.ServiceConfig(corpus_per_device=serve.GRAPH_NODES, dim=256, query_batch=1024,
                              k=10, delta_d=64, p_s=0.02, dtype="float32")
    with using(trees["this"][1]):
        graph = serve.prepare_graph(svc, "dade", m=16, ef=48, device="cuda")
    for route, argv, kw in (("flat", FLAT, {}), ("graph", GRAPH, {"graph": graph})):
        qps = {"other": [], "this": []}
        for r in range(ROUNDS):
            for name in ("other", "this", "this", "other"):
                with using(trees[name][1]):
                    report = trees[name][0].main(argv, **kw)
                qps[name].append(report["qps"])
                print(f"serve-ab {route} round {r} {name}: qps={report['qps']:.1f} "
                      f"recall={report['recall']:.4f} queries={report['queries']}", flush=True)
        med = {k: statistics.median(v) for k, v in qps.items()}
        print(f"serve-ab {route}: median qps other={med['other']:.1f} this={med['this']:.1f} "
              f"(this/other {med['this'] / med['other']:.4f}) over {len(qps['this'])} runs "
              f"each", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
