"""The end-to-end arithmetic, the form check and the trace reading on
hand-made inputs."""

import math

import numpy as np
import pytest

from bench import judge, stats, tracefile


def test_bench_rate():
    assert stats.rate(30000, 1.5) == 20000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_bench_p95_over_all_requests():
    lat = list(range(1, 101))  # 1 .. 100 ms
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile(lat, 50) == 50
    # a request that never got its answer counts as missing every limit
    assert stats.percentile(lat[:95] + [math.inf] * 5, 95) == 95
    assert stats.percentile(lat[:94] + [math.inf] * 6, 95) == math.inf
    assert stats.percentile([7.0], 95) == 7.0


def test_bench_recall():
    served = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    exact = np.array([[4, 3, 2, 1], [5, 6, 9, 10]])
    assert judge.recall(served, exact) == pytest.approx((4 + 2) / 8)


def test_bench_form_faults():
    ids = np.array([[0, 1, 2], [3, 3, 4], [5, 6, 9], [-1, 1, 2], [0, 1, 2], [0, 1, 2]])
    d = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3], [1, 2, 3], [1, np.inf, 3], [2, 1, 3]],
                 np.float32)
    # a repeat, an id past the corpus, an id < 0, a distance not finite, one descending
    assert judge.form_faults(ids, d, rows=9) == 5
    assert judge.form_faults(ids[:1], d[:1], rows=9) == 0


def test_bench_gaps():
    exact = np.array([[1.0, 2.0, 4.0]])
    own = np.array([[1.0, 2.0, 5.0]])  # the third served id lies 25 % past d_k
    served = np.array([[1.0, 2.2, 5.0]])  # a served distance 0.2 off its id's
    g = judge.gaps(served, own, exact)
    assert g["gap"] == pytest.approx(0.25) and g["dist_err"] == pytest.approx(0.05)
    g = judge.gaps(served, np.array([[1.0, 2.0, np.inf]]), exact)
    assert g["gap"] == judge.BIG


def test_bench_verdict():
    ok, c = judge.verdict({"bad": 0, "gap": 0.1}, {"bad": 0, "gap": 0.2})
    assert ok and c == {"bad": {"value": 0, "limit": 0}, "gap": {"value": 0.1, "limit": 0.2}}
    assert not judge.verdict({"bad": 1, "gap": 0.1}, {"bad": 0, "gap": 0.2})[0]
    assert not judge.verdict({"bad": 0, "gap": 0.3}, {"bad": 0, "gap": 0.2})[0]


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_bench_trace_analysis():
    ua = "user_annotation"
    ev = [_x("window", 0, 1000, ua),
          _x("frontend.drain", 0, 900, ua),
          _x("step", 100, 400, ua), _x("step.search", 100, 100, ua),
          _x("step.readback", 200, 300, ua),
          _x("step", 600, 200, ua), _x("step.readback", 650, 150, ua),
          _x("aten::mm", 100, 10, "cpu_op"),
          _x("ivf_scan_kernel<16>", 150, 250, "kernel"),  # inside step 1
          _x("Memcpy DtoH", 400, 50, "gpu_memcpy"),
          _x("ivf_scan_kernel<16>", 620, 100, "kernel"),  # inside step 2
          _x("late", 990, 50, "kernel")]  # clipped at the window's end
    t = tracefile.analyse(ev, ("window", "frontend.drain", "step", "step.search",
                               "step.readback"))
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx((300 + 100 + 10) / 1e6)
    assert t["kernels"]["ivf_scan_kernel<16>"] == [2, pytest.approx(350 / 1e6)]
    assert t["step_host_ms"] == [pytest.approx(0.1), pytest.approx(0.1)]
    idle = t["idle_by_span"]
    # the gaps [0, 150), [450, 620) and [720, 990) are named by their midpoints
    assert idle == {"frontend.drain": pytest.approx((150 + 170 + 270) / 1e6)}
    b = tracefile.breakdown(t)
    assert b["device_ops"][0] == ["ivf_scan_kernel<16>", pytest.approx(350 / 1e6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_bench_trace_without_window_reads_nothing():
    assert tracefile.analyse([_x("k", 0, 5, "kernel")], ("window",)) is None


def test_bench_innermost_span():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    assert tracefile.innermost(spans, [5, 25, 40, 65, 80, 200]) == [
        "a", "c", "b", "d", "a", "none"]
