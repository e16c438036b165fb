"""On the card: one short run of every cell prints a result line of the
contract's form with ``correct`` true.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest
import torch

from bench import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_bench_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                          "2718281828", "--seconds", "3", "--trace", "1"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["metrics"]


def test_bench_run_refuses_without_the_cells_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "deep1m.batch",
                          "--seed", "1", "--seconds", "1"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
