"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the metrics of the cell's entry.

Set-up makes the corpus and the query pool on the device from ``--seed``
(``bench.data``), builds the program's index and step (``bench.service``),
warms one batch of the cell's shapes twice, and frees the raw corpus.  The
window drives the program's front end (``runtime.scheduler.
BatchScheduler``) with the cell's mix (``bench.loadgen``).  After it the
program's state is freed, the corpus is drawn again from the seed, and the
plain reference (``bench.reference``) judges a sample of the served answers
(``bench.judge``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from bench import data, judge, loadgen, manifest, reference, service, tracefile
from repro_torch.kernels import ivf_scan
from repro_torch.runtime.scheduler import BatchScheduler

SPANS = ("window", "frontend.submit", "frontend.drain", "frontend.wait", "step",
         "step.h2d", "step.search", "step.readback")
WARMUP_BATCHES = 2


class Spans:
    """The harness's spans: ``torch.profiler.record_function`` ranges in a
    traced run, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


class Clock:
    """Closes the parts of the set-up, each at a device synchronise."""

    def __init__(self, t0: float, device: torch.device):
        self.t, self.dev, self.parts = t0, device, {}

    def __call__(self, part: str) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.t
        self.t = now


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: manifest.Cell
    setup_s: float
    window: loadgen.Window
    stats: dict  # the front end's counters
    batch: int
    rows_done: int  # queries answered in the window
    scan: np.ndarray | None  # the kernel's counters summed over the window
    recall: float
    latencies_ms: list  # every due request, inf where it got no answer
    trace: dict | None


def _data_spec(config: dict) -> dict:
    return {**config["data"], "rows": config["rows"], "dim": config["dim"]}


def _build_step(cell, corpus, seed, clock, spans, control: bool):
    cfg, k = cell.config, cell.traffic["k"]
    if control:
        step = reference.Int8Search(corpus, block_d=cfg["service"]["delta_d"], k=k)
        clock("control")
        return step
    served = service.build(cfg, k, corpus, seed, clock)
    if corpus.device.type == "cuda":
        ivf_scan.build()
        clock("library")
    return service.SearchStep(served, spans)


def _answers(window: loadgen.Window, closed: bool):
    """(served Sent list, due count, unserved count)."""
    served = [s for s in window.sent if s.req.status == "served"]
    if closed:  # a request still queued at the close was not yet due
        due = [s for s in window.sent if s.req.status != "queued"]
    else:
        due = window.sent
    return served, len(due), len(due) - len(served)


def _sample(served, count: int, seed: int, pool_rows: int):
    """A seeded sample of the served queries: (pool rows, served dists,
    served ids)."""
    sizes = np.array([s.rows for s in served], np.int64)
    ends = np.cumsum(sizes)
    total = int(ends[-1]) if len(ends) else 0
    if total == 0:
        return np.zeros(0, np.int64), None, None
    pick = np.sort(np.random.default_rng([seed % (1 << 63), 11]).choice(
        total, min(count, total), replace=False))
    req = np.searchsorted(ends, pick, side="right")
    row = pick - (ends[req] - sizes[req])
    pool_idx = np.array([(served[r].offset + j) % pool_rows for r, j in zip(req, row)])
    d = np.stack([served[r].req.result[0][j] for r, j in zip(req, row)])
    ids = np.stack([served[r].req.result[1][j] for r, j in zip(req, row)])
    return pool_idx, d, ids


def _profile(on: bool):
    if not on:
        return contextlib.nullcontext(None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _read_trace(prof) -> dict | None:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracefile.analyse(tracefile.load(path), SPANS)
    finally:
        os.remove(path)


@dataclasses.dataclass
class Prepared:
    step: object  # batch (B, dim) float32 on the host -> (dists, ids) on the host
    pool: np.ndarray  # the run's queries
    clock: Clock
    batch: int


def prepare(cell: manifest.Cell, seed: int, *, device, t_start: float, spans,
            control: bool = False) -> Prepared:
    """The set-up of a run: the data, the program's index and step (or the
    control in its place), the warm-up; the raw corpus freed."""
    dev = torch.device(device)
    clock = Clock(t_start, dev)
    torch.zeros(1, device=dev)
    clock("torch_cuda")
    cfg, tr = cell.config, cell.traffic
    corpus = data.corpus(_data_spec(cfg), seed, dev)
    pool = data.query_pool(corpus, tr["query_pool"], seed, jitter=cfg["data"]["query_jitter"])
    clock("data")
    step = _build_step(cell, corpus, seed, clock, spans, control)
    del corpus
    batch = cfg["service"]["query_batch"]
    for i in range(WARMUP_BATCHES):
        step(pool[i * batch:(i + 1) * batch].copy())
    clock("warmup")
    if hasattr(step, "scan"):
        step.scan[:] = 0.0
    return Prepared(step=step, pool=pool, clock=clock, batch=batch)


def front_end(traffic: dict, p: Prepared):
    """The program's front end over the prepared step."""
    wait = traffic["max_wait_s"]
    kw = {} if wait is None else {"max_wait_s": wait}
    return BatchScheduler(p.step, batch_size=p.batch, **kw)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, control: bool = False, log=sys.stderr):
    """Run ``cell`` once; returns (the result's object, the checks)."""
    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    spans = Spans(trace)
    p = prepare(cell, seed, device=dev, t_start=t_start, spans=spans, control=control)
    step, pool, clock, batch = p.step, p.pool, p.clock, p.batch
    sched = front_end(tr, p)
    del p
    setup_s = time.perf_counter() - t_start
    print("setup_s " + " ".join(f"{k}={v:.3f}" for k, v in clock.parts.items())
          + f" total={setup_s:.3f}", file=log, flush=True)

    with _profile(trace) as prof:
        window = loadgen.drive(sched, loadgen.Pool(pool), loadgen.Mix(tr, seed), seconds, spans)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    scan = step.scan.copy() if hasattr(step, "scan") else None
    del step, sched.step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    tr_fig = _read_trace(prof) if trace else None
    t_ref = time.perf_counter()

    closed = tr["arrivals"]["kind"] == "closed"
    served, due, unserved = _answers(window, closed)
    if served:
        all_ids = np.concatenate([s.req.result[1] for s in served])
        all_d = np.concatenate([s.req.result[0] for s in served])
    else:
        all_ids = all_d = np.zeros((0, tr["k"]))
    numbers = {"bad": judge.form_faults(all_ids, all_d, cfg["rows"]), "unserved": unserved}
    pool_idx, s_d, s_ids = _sample(served, cell.limits["sample_queries"], seed, pool.shape[0])
    rec = 0.0
    if len(pool_idx):
        corpus = data.corpus(_data_spec(cfg), seed, dev)
        q = torch.from_numpy(pool[pool_idx]).to(dev)
        ex_d, ex_i = reference.exact_topk(corpus, q, tr["k"])
        own = reference.distances(corpus, q, torch.from_numpy(s_ids.astype(np.int64)).to(dev))
        numbers.update(judge.gaps(s_d, own.cpu().numpy(), ex_d.cpu().numpy()))
        rec = judge.recall(s_ids, ex_i.cpu().numpy())
        del corpus, q, ex_d, ex_i, own
    else:
        numbers.update(judge.gaps(np.zeros((0, 1)), None, None))
    limits = {k: v for k, v in cell.limits.items() if k != "sample_queries"}
    ok, checks = judge.verdict(numbers, limits)
    t_end = time.perf_counter()

    lat = None
    if not closed:
        lat = [((s.req.completed_at - s.due) * 1e3 if s.req.status == "served" else float("inf"))
               for s in window.sent]
    if window.late_ms:
        late = sorted(window.late_ms)
        print(f"generator late_ms p50={late[len(late) // 2]:.3f} "
              f"p99={late[int(len(late) * 0.99)]:.3f} max={late[-1]:.3f}", file=log, flush=True)
    print(f"window_s={window.end - window.start:.4f} requests_sent={len(window.sent)} "
          f"due={due} served={len(served)} rows={sched.stats['rows']} "
          f"batches={sched.stats['batches']} padded_rows={sched.stats['padded_rows']} "
          f"recall={rec:.5f} "
          f"trace_read_s={t_ref - t_trace:.2f} check_s={t_end - t_ref:.2f}",
          file=log, flush=True)

    run = Run(cell=cell, setup_s=setup_s, window=window,
              stats=dict(sched.stats), batch=batch, rows_done=sched.stats["rows"], scan=scan,
              recall=rec, latencies_ms=lat, trace=tr_fig)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": due, "failed": unserved, "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace and tr_fig is not None:
        result["device"].update(busy_s=tr_fig["busy_s"], window_s=tr_fig["window_s"])
        result["breakdown"] = tracefile.breakdown(tr_fig)
    result["checks"] = checks
    return result, checks
