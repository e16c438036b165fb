"""The frozen least-work count equals the program's ``ivf_scan.work``
without stats, at every cell's shapes."""

import pytest

from bench import manifest, work
from repro_torch.kernels import ivf_scan


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_bench_least_work_is_the_programs(cell):
    c = manifest.cell(cell)
    s = c.config["service"]
    d_pad = -(-c.config["dim"] // s["delta_d"]) * s["delta_d"]
    shape = dict(queries=s["query_batch"], rows=c.config["rows"], dim=d_pad,
                 k=c.traffic["k"], block_d=s["delta_d"])
    theirs = ivf_scan.work(**shape, block_q=16, row_bytes=2)
    assert work.least_work(**shape) == theirs


def test_bench_bound_is_the_larger_term():
    w = work.least_work(queries=1024, rows=1 << 20, dim=256, k=100, block_d=64)
    assert w["bytes"] == 274_804_736
    assert work.bound_s(w) == pytest.approx(w["bytes"] / work.PEAK_BYTES)
    w2 = dict(w, int8_ops=w["int8_ops"] * 100)
    assert work.bound_s(w2) == pytest.approx(w2["int8_ops"] / work.PEAK_INT8_OPS)
