"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same code paths (the program's plain scan on CPU tensors) at the
configuration's widths (dims, block, k), with fewer rows and smaller
batches."""

import copy
import io
import time

from bench import harness, manifest


def tiny_cell(name: str = "deep1m.batch") -> manifest.Cell:
    c = manifest.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config.update(rows=8192)
    c.config["service"].update(query_batch=16, wave=1024, estimator_rows=4096)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic.update(query_pool=4096)
    if c.traffic["arrivals"]["kind"] == "closed":
        c.traffic["request_rows"] = {"dist": "uniform", "low": 8, "high": 32}
        c.traffic["arrivals"]["group_rows"] = 64
    else:
        c.traffic["arrivals"]["phases"] = [[1.0, 20.0]]
    c.limits = dict(c.limits, sample_queries=128)
    return c


def run(cell, seed=987654321012, seconds=1.0, trace=False, control=False):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            t_start=time.perf_counter(), control=control,
                            log=io.StringIO())
