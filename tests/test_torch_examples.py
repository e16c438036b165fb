"""The four ported examples (``examples_torch/``), each run on the CPU in a
subprocess (``--device cpu``) as a user starts it: it must exit 0, print
its reference's lines (``examples/``) and keep its contract asserts:
quickstart's fused recall@10 >= 0.95 with fewer fetched bytes than the
fp32 screen consumed (its ``OK``), ``serve_ann.py``'s recall@k >= 0.95
(over 2 gloo ranks at its smallest honest corpus: one 4,096-row wave a
rank), the trainer's restart after the failure it injects."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples_torch" / script), *args,
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def _num(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return float(m.group(1))


def test_quickstart():
    text = _run("quickstart.py")
    assert re.search(r"^fp32 DADE     recall@10=\d\.\d{3} avg dims=[\d.]+/96 ~\d+ kB/query$",
                     text, re.M), text
    assert _num(r"fused int8    recall@10=(\d\.\d{3}) fetched=\d+ kB/query \(s2 skip rate "
                r"\d+%, int8 dims/row [\d.]+, fp32 dims/row [\d.]+\)", text) >= 0.95
    assert text.rstrip().endswith("OK")


def test_rag_retrieval():
    text = _run("rag_retrieval.py")
    assert "[embed] corpus embeddings (2048, " in text
    assert _num(r"\[retrieve\] recall@5 vs exact = (\d\.\d{3}); perturbed-self hit rate = "
                r"\d\.\d{3}; avg dims = [\d.]+/\d+", text) >= 0.95


def test_serve_ann_over_two_ranks():
    text = _run("serve_ann.py", "--ranks", "2", "--corpus", "8192", "--requests", "2")
    assert "[ingest] corpus 8192x96 over 2 ranks" in text
    assert len(re.findall(r"^\[serve\] request \d: 64 queries in [\d.]+ ms \(\d+ QPS\)$",
                          text, re.M)) == 2
    assert _num(r"\[serve\] total \d+ QPS, recall@10 = (\d\.\d{3})", text) >= 0.95


def test_train_lm_restarts_and_finishes():
    text = _run("train_lm.py")
    assert re.search(r"^\[done\] steps=60 restarts=1 ", text, re.M), text
    first, last = (_num(rf"{w}=([\d.]+)", text) for w in ("first10", "last10"))
    assert last < first
