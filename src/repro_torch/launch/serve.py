"""DADE vector-search serving on one card (the flat, graph and continuous
graph routes of ``repro.launch.serve``: ``--index flat|graph --quant int8
--fused on [--continuous]``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cuda] \
        [--index flat] [--requests 10] [--corpus 1048576] [--batch 1024] [--k 100] \
        [--shards G]
    PYTHONPATH=src python -m repro_torch.launch.serve --index graph \
        [--corpus 32768] [--k 10] [--ef 48] [--expand 2] [--m 16] \
        [--continuous --max-live SLOTS --slo LO:HI[:STALL]] [--verify-graph-oracle]

Flat route defaults are the ``dade_ivf`` serving configuration (2^20 x 256
corpus, batch 1024, k=100, wave 8192, Δd=64, bf16 rows, int8 codes, DADE
at p_s=0.02).  Builds the estimator on a corpus sample, rotates and
encodes the corpus on the card, serves batched requests through the fused
wave-scan kernel and prints one report line: QPS, recall@k against exact
ground truth, the warm-up step's time (``compile_ms``; it includes the
first kernel build) and the fetch figures.  ``--shards`` is the
reference's shard count (its ``--devices``), run on the one card as that
many segments of each scan, merged as the reference merges shards.

The graph route builds the NSW graph (m=16, ef_construction=max(2·ef, 64),
f32 adjacency rows, int8 codes; the insertion loop runs on the host, so
its corpus defaults to 32,768 rows and k to 10) and serves each batch
through one launch of the beam walk; its line adds waves and fetched
bytes per query.  ``--continuous`` serves the same graph with continuous
batching: queries join the one-wave kernel's wave step mid-walk
(``annservice.ContinuousGraphEngine`` under
``runtime.scheduler.ContinuousScheduler``), at most ``--max-live`` at a
time, each retired query bit-identical to its solo search.

Load and robustness (the reference's flags): ``--open-loop RATE`` serves
Poisson arrivals at RATE requests/s instead of one closed-loop drain and
reports p50/p95/p99 request latency; ``--deadline-ms``,
``--queue-watermark`` and ``--retries`` / ``--retry-backoff-ms`` shed late,
excess and failing work (``submitted == served + shed`` always);
``--chaos SPEC`` arms fault drills (``step_error``, ``queue_overload``,
``shard_stall``).  Telemetry: ``--metrics-json PATH`` writes the
schema-versioned metrics snapshot that ``scripts/check_metrics_schema.py``
validates; ``--trace PATH`` writes a Chrome trace of the run's spans (its
fences wait for the card at span ends: leave it off for peak QPS).

Not ported (refused by name): unquantized or unfused routes, sharded graph
serving (``--graph-shards``, ``--verify-degraded-oracle``, chaos
``shard_death``) and the mutable index with its snapshots and log
(``--index-ckpt``, ``--mutate-rate``, ``--wal``, chaos ``slab_corruption``,
``torn_upsert``, ``stale_transform``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.dade_ivf import CONFIG, ServiceConfig
from repro_torch.core.estimators import Estimator, build_estimator, kernel_spec
from repro_torch.core.topk import exact_knn
from repro_torch.core.transforms import as_tensor
from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
from repro_torch.index.graph import (
    GraphIndex, build_graph, search_graph_beam_host, search_graph_fused,
)
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import (
    FUSED_BLOCK_C, SHARDS, ContinuousGraphEngine, build_graph_engine,
    build_search_step, parse_slo,
)
from repro_torch.obs import (
    MetricsRegistry, Tracer, current_tracer, record_dco_method,
    record_fused_serve_totals, record_graph_scan, set_tracer,
    write_chrome_trace, write_metrics_json,
)
from repro_torch.quant.accounting import (
    ID_BYTES, fetched_tile_bytes, stage2_fetch_report, two_stage_bytes,
)
from repro_torch.quant.scalar import fit_block_scales, quantize_block
from repro_torch.runtime.chaos import parse_chaos, set_chaos
from repro_torch.runtime.scheduler import BatchScheduler, ContinuousScheduler

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The graph route's corpus and k when not given: the host-side NSW build
# makes 2^20 rows an hours-long build.
GRAPH_NODES = 32768
GRAPH_K = 10
# What the port does not serve yet, by flag and by chaos kind, with the
# ROADMAP item that brings it.
UNPORTED_FLAGS = {"graph_shards": "queue 1 item 7", "verify_degraded_oracle": "queue 1 item 7",
                  "index_ckpt": "queue 1 item 6", "mutate_rate": "queue 1 item 6",
                  "wal": "queue 1 item 6"}
UNPORTED_FAULTS = {"shard_death": "queue 1 item 7", "slab_corruption": "queue 1 item 6",
                   "torn_upsert": "queue 1 item 6", "stale_transform": "queue 1 item 6"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--corpus", type=int, default=None,
                    help=f"corpus rows (default {CONFIG.corpus_per_device}; "
                         f"{GRAPH_NODES} for --index graph)")
    ap.add_argument("--dim", type=int, default=CONFIG.dim)
    ap.add_argument("--k", type=int, default=None,
                    help=f"neighbours per query (default {CONFIG.k}; "
                         f"{GRAPH_K} for --index graph)")
    ap.add_argument("--batch", type=int, default=CONFIG.query_batch)
    ap.add_argument("--wave", type=int, default=CONFIG.wave)
    ap.add_argument("--delta-d", type=int, default=CONFIG.delta_d)
    ap.add_argument("--dtype", default=CONFIG.dtype, choices=sorted(_DTYPES))
    ap.add_argument("--method", default="dade",
                    choices=["dade", "adsampling", "fdscanning"])
    ap.add_argument("--p-s", type=float, default=CONFIG.p_s)
    ap.add_argument("--index", default="flat", choices=["flat", "graph"])
    ap.add_argument("--ef", type=int, default=48,
                    help="beam width of the --index graph route")
    ap.add_argument("--expand", type=int, default=2,
                    help="frontier expansions per query per wave (--index graph)")
    ap.add_argument("--m", type=int, default=16,
                    help="graph degree of the --index graph route")
    ap.add_argument("--shards", type=int, default=SHARDS,
                    help="flat route: corpus shards, walked as segments of one "
                         "scan on the card and merged as the reference's mesh "
                         "merges them")
    ap.add_argument("--quant", default="int8", choices=["int8"])
    ap.add_argument("--fused", default="on", choices=["on"])
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (--index graph): queries join the "
                         "one-wave kernel's wave step mid-walk, each retired "
                         "query bit-identical to its solo search")
    ap.add_argument("--max-live", type=int, default=0, metavar="SLOTS",
                    help="live-walk slot cap of --continuous; 0 = --batch")
    ap.add_argument("--slo", default="off", metavar="LO:HI[:STALL]",
                    help="SLO effort adaptation of --continuous: per-query expand "
                         "within [LO, HI] from the threshold-tightening rate; "
                         ":STALL retires a walk after STALL waves without "
                         "tightening; 'off' keeps the fixed-parameter engine")
    ap.add_argument("--verify-graph-oracle", action="store_true",
                    help="before serving, require the graph engine's ids, "
                         "distances and ledgers to equal the solo walk's and the "
                         "plain walk's (exits nonzero on a mismatch)")
    ap.add_argument("--open-loop", type=float, default=0.0, metavar="RATE",
                    help="Poisson arrivals at RATE requests/s with p50/p95/p99 "
                         "latency; 0 keeps the closed-loop drain")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the schema-versioned metrics snapshot to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the run's spans to PATH")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="arm a fault drill: ';'-joined kind[:key=val]* tokens "
                         "(step_error, queue_overload, shard_stall)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget: requests still queued past "
                         "it are shed (0 = no deadline)")
    ap.add_argument("--queue-watermark", type=int, default=0, metavar="ROWS",
                    help="queue-depth watermark in query rows: submits past it are "
                         "shed at the door (0 = unbounded)")
    ap.add_argument("--retries", type=int, default=0,
                    help="bounded retries per engine batch or wave (exponential "
                         "backoff); exhausted retries shed and serving continues")
    ap.add_argument("--retry-backoff-ms", type=float, default=20.0,
                    help="first-retry backoff (doubles per attempt)")
    # The reference's flags for routes the port does not serve: refused.
    ap.add_argument("--graph-shards", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--verify-degraded-oracle", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--index-ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mutate-rate", type=float, default=0.0, help=argparse.SUPPRESS)
    ap.add_argument("--wal", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for name, item in UNPORTED_FLAGS.items():
        if getattr(args, name) != ap.get_default(name):
            ap.error(f"--{name.replace('_', '-')} {getattr(args, name)}: not ported "
                     f"(ROADMAP {item})")
    if args.continuous and args.index != "graph":
        ap.error("--continuous requires --index graph (mid-walk admission is a "
                 "property of the wave-synchronous beam walk)")
    graph = args.index == "graph"
    if args.corpus is None:
        args.corpus = GRAPH_NODES if graph else CONFIG.corpus_per_device
    if args.k is None:
        args.k = GRAPH_K if graph else CONFIG.k
    return args


@dataclasses.dataclass
class Service:
    """The served corpus on the card: the estimator, its blocked table, the
    rotated rows in the row dtype and their per-block int8 codes."""

    svc: ServiceConfig
    corpus: np.ndarray  # (N, dim) raw vectors (ground truth, query source)
    corpus_t: torch.Tensor  # the same, float32 on the card
    est: Estimator
    eps: torch.Tensor
    scale: torch.Tensor
    eps_lo: torch.Tensor
    d_pad: int
    rows: torch.Tensor  # (N, d_pad) rotated, row dtype
    codes: torch.Tensor  # (N, d_pad) int8 per-block codes
    bscales: torch.Tensor  # (d_pad // delta_d,) f32

    def prep(self, q) -> torch.Tensor:
        """Rotate and pad queries, rounded to the row dtype."""
        x = self.est.rotate(as_tensor(q, self.rows.device))
        return torch.nn.functional.pad(x, (0, self.d_pad - self.svc.dim)).to(self.rows.dtype)


def prepare_service(svc: ServiceConfig, method: str, device) -> Service:
    """Build the estimator on a corpus sample, then rotate and encode the
    ``synthetic_vectors(seed=0)`` corpus on ``device``."""
    dev = resolve_device(device)
    corpus = synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0)
    corpus_t = as_tensor(corpus, dev)
    est = build_estimator(method, corpus_t[:50000], torch.Generator().manual_seed(0),
                          p_s=svc.p_s, delta_d=svc.delta_d, device=dev)
    kernel_spec(est, svc.dim, svc.delta_d)  # refuse what the kernel can't express
    eps, scale, d_pad, eps_lo = block_table(est.table, svc.dim, svc.delta_d)
    c_rot = torch.nn.functional.pad(est.rotate(corpus_t), (0, d_pad - svc.dim))
    # Per-BLOCK codes (one scale per Δd-dim block) feed the int8 stage 1;
    # padded dims land in an all-zero block (scale 0) and add nothing.
    bscales = fit_block_scales(c_rot, svc.delta_d)
    codes = quantize_block(c_rot, bscales, svc.delta_d)
    return Service(svc=svc, corpus=corpus, corpus_t=corpus_t, est=est, eps=eps,
                   scale=scale, eps_lo=eps_lo, d_pad=d_pad,
                   rows=c_rot.to(_DTYPES[svc.dtype]), codes=codes, bscales=bscales)


@dataclasses.dataclass
class GraphService:
    """The graph route's corpus and its index on the card."""

    corpus: np.ndarray  # (N, dim) raw vectors (ground truth, query source)
    corpus_t: torch.Tensor  # the same, float32 on the card
    index: GraphIndex


def prepare_graph(svc: ServiceConfig, method: str, *, m: int, ef: int,
                  device) -> GraphService:
    """Build the estimator on a corpus sample as the flat route does, then
    the NSW graph of the ``synthetic_vectors(seed=0)`` corpus with the
    reference's serving settings: degree ``m``, ``ef_construction =
    max(2·ef, 64)``, f32 adjacency rows, int8 codes, Δd-wide blocks."""
    dev = resolve_device(device)
    corpus = synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0)
    corpus_t = as_tensor(corpus, dev)
    est = build_estimator(method, corpus_t[:50000], torch.Generator().manual_seed(0),
                          p_s=svc.p_s, delta_d=svc.delta_d, quant="int8", device=dev)
    index = build_graph(corpus_t, estimator=est, m=m,
                        ef_construction=max(2 * ef, 64), quant="int8", device=dev)
    return GraphService(corpus=corpus, corpus_t=corpus_t, index=index)


class ServeRun:
    """One serve invocation's load driver and telemetry: the metrics
    registry (always collecting; written under ``--metrics-json``), the
    scheduler's request accounting, and the report line's figures."""

    def __init__(self, args, svc: ServiceConfig, dev, reg: MetricsRegistry, tracer):
        self.args, self.svc, self.dev, self.reg, self.tracer = args, svc, dev, reg, tracer
        self.config = {k.replace("-", "_"): v for k, v in vars(args).items()}
        self.config.update(devices=1, corpus=svc.corpus_per_device)

    def warmup(self, step_fn, queries) -> float:
        """Run one engine step outside every timed window (its first kernel
        build and launch); returns its wall-clock ms."""
        t0 = time.perf_counter()
        with current_tracer().span("serve.warmup"):
            step_fn(queries)
        ms = (time.perf_counter() - t0) * 1e3
        self.reg.gauge("serve.compile_ms").set(ms)
        return ms

    def payloads(self, corpus, corpus_t, prep):
        """Every request's queries and exact ground truth, made before the
        clock starts — ground truth is evaluation, not serving work."""
        svc = self.svc
        rng = np.random.default_rng(9)
        out = []
        for r in range(self.args.requests):
            nq = int(rng.integers(svc.query_batch // 2, 2 * svc.query_batch))
            q = synthetic_queries(nq, svc.dim, corpus, seed=100 + r)
            _, gt = exact_knn(q, corpus_t, svc.k, device=self.dev)
            out.append((prep(q), gt.cpu().numpy()))
        return out

    def scheduler(self, step_fn) -> BatchScheduler:
        a = self.args
        return BatchScheduler(step_fn, batch_size=self.svc.query_batch,
                              max_queue_rows=a.queue_watermark, max_retries=a.retries,
                              retry_backoff_s=a.retry_backoff_ms / 1e3, registry=self.reg)

    def drive(self, sched, payloads):
        """Push the payloads through the scheduler.  Closed loop (default):
        enqueue everything, one forced drain.  Open loop (``--open-loop
        RATE``): submit at Poisson arrival times (``default_rng(17)``),
        draining opportunistically.  Returns (reqs, gts, wall seconds,
        latencies ms); a latency runs from enqueue to the serving instant
        the scheduler stamps."""
        a = self.args
        lat = self.reg.histogram("serve.request.latency_ms")
        reqs, gts, lat_ms = [], [], []
        deadline_s = a.deadline_ms / 1e3 if a.deadline_ms else None

        def collect(done):
            t_done = time.perf_counter()
            for req in done:
                t_req = req.completed_at or t_done
                ms = (t_req - req.enqueued_at) * 1e3
                lat.observe(ms)
                lat_ms.append(ms)
                # Served but late: the request was already dispatched when
                # its budget expired.
                if req.deadline_at is not None and t_req > req.deadline_at:
                    self.reg.counter("serve.deadline.missed").add(1)

        t0 = time.perf_counter()
        with current_tracer().span("serve.drive", open_loop=a.open_loop > 0):
            if a.open_loop > 0:
                arr = np.random.default_rng(17).exponential(1.0 / a.open_loop,
                                                            size=len(payloads))
                t_next = t0
                for (q, gt), gap in zip(payloads, arr):
                    t_next += gap
                    now = time.perf_counter()
                    if t_next > now:
                        time.sleep(t_next - now)
                    reqs.append(sched.submit(q, deadline_s=deadline_s))
                    gts.append(gt)
                    collect(sched.drain(force=False))
                collect(sched.drain(force=True))
            else:
                for q, gt in payloads:
                    reqs.append(sched.submit(q, deadline_s=deadline_s))
                    gts.append(gt)
                collect(sched.drain(force=True))
        return reqs, gts, time.perf_counter() - t0, lat_ms

    def accounting(self, sched, reqs, gts):
        """Split the run into served and shed requests and enforce the
        terminal-status invariant: every submitted request is exactly one
        of served / shed_queue / shed_deadline / shed_error."""
        served = [(r, g) for r, g in zip(reqs, gts) if r.status == "served"]
        shed = sum(sched.stats[k] for k in ("shed_queue", "shed_deadline", "shed_error"))
        if sched.stats["submitted"] != sched.stats["served"] + shed or any(
                r.result is None for r, _ in served):
            raise RuntimeError(f"request accounting does not close: {sched.stats}")
        self.reg.counter("serve.requests").add(len(served))
        self.reg.counter("serve.queries").add(sum(len(g) for _, g in served))
        return served, shed

    def recall(self, served) -> float:
        """Mean recall@k over the served requests (shed ones have none)."""
        k = self.svc.k
        per = [np.mean([len(set(req.result[1][i]) & set(gt[i])) / k
                        for i in range(len(gt))]) for req, gt in served]
        return float(np.mean(per)) if per else 0.0

    @staticmethod
    def shed_note(sched) -> str:
        s = sched.stats
        if not any(s[k] for k in ("shed_queue", "shed_deadline", "shed_error", "retries")):
            return ""
        return (f" shed(queue={s['shed_queue']} deadline={s['shed_deadline']}"
                f" error={s['shed_error']}) retries={s['retries']}")

    def latency_note(self, lat_ms) -> str:
        if not lat_ms:
            return ""
        lat = self.reg.histogram("serve.request.latency_ms")
        p = {q: lat.percentile(q) for q in (50, 95, 99)}
        for q, v in p.items():
            self.reg.gauge(f"serve.request.p{q}_ms").set(v)
        return f" latency_ms(p50={p[50]:.1f} p95={p[95]:.1f} p99={p[99]:.1f})"

    def emit(self, report: dict) -> dict:
        """Tag the snapshot with the DCO method, echo the report's numbers
        as gauges, and write the machine-readable outputs."""
        a = self.args
        record_dco_method(self.reg, a.method,
                          queries=self.reg.counter("serve.queries").value)
        for key, val in report.items():
            if isinstance(val, (int, float)):
                self.reg.gauge(f"serve.report.{key}").set(val)
        if a.metrics_json:
            write_metrics_json(self.reg, a.metrics_json, config=self.config,
                               extra={"report": report})
            print(f"metrics-json: wrote {a.metrics_json}", flush=True)
        if self.tracer is not None:
            write_chrome_trace(self.tracer, a.trace)
            print(f"trace: wrote {a.trace} ({len(self.tracer.events)} events)", flush=True)
        return report


def _check_graph_oracle(srv: GraphService, engine_ids, engine_d, engine_st, vq, *,
                        args, k: int, dev, label: str) -> None:
    """Hold a graph engine's results on ``vq`` against the plain walk
    (``search_graph_beam_host``) on the same queries, bit for bit: ids,
    distances and every ledger field (``engine_st`` a ledger or a list of
    per-query ledgers)."""
    if isinstance(engine_st, list):
        outs = [search_graph_beam_host(srv.index, vq[i: i + 1], k=k, ef=args.ef,
                                       expand=args.expand, device=dev)
                for i in range(len(vq))]
        d_o = np.concatenate([o[0].cpu().numpy() for o in outs])
        i_o = np.concatenate([o[1].cpu().numpy() for o in outs])
        st_ok = all(s == o[2] for s, o in zip(engine_st, outs))
    else:
        d_t, i_t, st_o = search_graph_beam_host(srv.index, vq, k=k, ef=args.ef,
                                                expand=args.expand, device=dev)
        d_o, i_o, st_ok = d_t.cpu().numpy(), i_t.cpu().numpy(), engine_st == st_o
    if not np.array_equal(engine_ids, i_o):
        raise SystemExit(f"{label}: ids diverge from the plain walk")
    if not np.array_equal(engine_d, d_o):
        raise SystemExit(f"{label}: distances diverge from the plain walk")
    if not st_ok:
        raise SystemExit(f"{label}: ledgers diverge from the plain walk")


def serve_graph(run: ServeRun, prepared: GraphService | None) -> dict:
    """The ``--index graph`` route: serve ``--requests`` requests through
    the beam-walk engine, or with ``--continuous`` through the continuous
    engine; prints the report line and returns it as a dict."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    t0 = time.perf_counter()
    srv = prepared or prepare_graph(svc, args.method, m=args.m, ef=args.ef, device=dev)
    build_note = "" if prepared else f" build_s={time.perf_counter() - t0:.1f}"
    if (srv.index.corpus_rot.shape != (svc.corpus_per_device, svc.dim)
            or srv.index.degree != args.m):
        raise ValueError("the prepared graph does not match --corpus/--dim/--m")
    corpus, n = srv.corpus, svc.corpus_per_device
    if args.continuous:
        return serve_continuous(run, srv, build_note)
    engine = build_graph_engine(srv.index, k=svc.k, ef=args.ef,
                                expand=args.expand, device=dev)
    if args.verify_graph_oracle:
        vq = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=77)
        dv, iv, st = engine(vq)
        _check_graph_oracle(srv, iv, dv, st, vq, args=args, k=svc.k, dev=dev,
                            label="graph serving")
        print(f"verify: the graph engine is bit-identical to the plain walk "
              f"({svc.query_batch} queries)", flush=True)
    g_stats = []

    def g_step(batch_np):
        d, i, st = engine(batch_np)
        g_stats.append(st)
        return d, i

    # The warm-up hits the engine directly, so its ledgers are not counted.
    compile_ms = run.warmup(engine, synthetic_queries(svc.query_batch, svc.dim,
                                                      corpus, seed=999))
    sched = run.scheduler(g_step)
    payloads = run.payloads(corpus, srv.corpus_t, lambda q: q)
    reqs, gts, dt, lat_ms = run.drive(sched, payloads)
    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)
    waves = sum(st.waves for st in g_stats)
    fetched = float(np.mean([st.fetched_bytes_per_query for st in g_stats])) if g_stats else 0.0
    skip = float(np.mean([st.s2_skip_rate for st in g_stats])) if g_stats else 0.0
    # Every drained batch carries the full padded batch: the per-query
    # ledgers scale back to totals by exactly that.
    for st in g_stats:
        record_graph_scan(reg, st, queries=svc.query_batch)
    lat_note = run.latency_note(lat_ms)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_submitted": sched.stats["submitted"],
              "requests_served": sched.stats["served"], "requests_shed": shed,
              "batches": sched.stats["batches"], "waves": float(waves),
              "fetched_bytes_per_query": fetched, "s2_skip_rate": skip,
              "device": str(dev)}
    print(f"method={args.method} index=graph quant={args.quant} devices=1 corpus={n} "
          f"requests={sched.stats['served']}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} ef={args.ef} expand={args.expand} "
          f"m={args.m} QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f}{build_note} waves={waves:.0f} "
          f"fetched_B_per_q={fetched:.0f} s2_skip_rate={skip:.3f} device={dev}"
          f"{run.shed_note(sched)}{lat_note}", flush=True)
    return run.emit(report)


def serve_continuous(run: ServeRun, srv: GraphService, build_note: str) -> dict:
    """``--index graph --continuous``: the continuous engine under the
    continuous scheduler, with its warm-up and (``--verify-graph-oracle``)
    the interleaving check: 8 queries walking concurrently must equal each
    one served alone by ``search_graph_fused`` and by the plain walk."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    corpus, n = srv.corpus, svc.corpus_per_device
    max_live = args.max_live or svc.query_batch
    slo = parse_slo(args.slo)

    def new_engine(policy):
        return ContinuousGraphEngine(srv.index, k=svc.k, ef=args.ef,
                                     expand=args.expand, slo=policy)

    engine = new_engine(slo)
    reg.gauge("serve.continuous.max_live").set(float(max_live))
    # Warm-up: one solo walk outside every timed window (the first kernel
    # build and launch).
    t0 = time.perf_counter()
    with current_tracer().span("serve.warmup"):
        engine.admit(synthetic_queries(1, svc.dim, corpus, seed=999)[0])
        while engine.live_count():
            engine.step()
    compile_ms = (time.perf_counter() - t0) * 1e3
    reg.gauge("serve.compile_ms").set(compile_ms)

    if args.verify_graph_oracle:
        # Through a fresh SLO-off engine: the solo walks run at fixed expand.
        nv = min(svc.query_batch, 8)
        vq = synthetic_queries(nv, svc.dim, corpus, seed=77)
        veng = new_engine(None)
        hmap = {veng.admit(vq[i]): i for i in range(nv)}
        out = {}
        while veng.live_count():
            for rq in veng.step():
                out[hmap[rq.handle]] = rq
        rqs = [out[i] for i in range(nv)]
        dv, iv = np.stack([r.dists for r in rqs]), np.stack([r.ids for r in rqs])
        solo = [search_graph_fused(srv.index, vq[i: i + 1], k=svc.k, ef=args.ef,
                                   expand=args.expand, device=dev) for i in range(nv)]
        if not (np.array_equal(iv, np.concatenate([s[1].cpu().numpy() for s in solo]))
                and np.array_equal(dv, np.concatenate([s[0].cpu().numpy() for s in solo]))
                and all(r.stats == s[2] for r, s in zip(rqs, solo))):
            raise SystemExit("continuous serving diverges from the solo walks")
        _check_graph_oracle(srv, iv, dv, [r.stats for r in rqs], vq, args=args,
                            k=svc.k, dev=dev, label="continuous serving")
        print(f"verify: continuous engine bit-identical to the solo walk and to "
              f"the plain walk ({nv} interleaved queries)", flush=True)

    sched = ContinuousScheduler(engine, max_live=max_live,
                                max_queue_rows=args.queue_watermark,
                                max_retries=args.retries,
                                retry_backoff_s=args.retry_backoff_ms / 1e3, registry=reg)
    payloads = run.payloads(corpus, srv.corpus_t, lambda q: q)
    reqs, gts, dt, lat_ms = run.drive(sched, payloads)
    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)
    for st in sched.scan_stats:
        record_graph_scan(reg, st, queries=1)
    s = sched.stats
    occupancy = s["live_rows"] / max(s["waves"], 1)
    scans = sched.scan_stats
    mean_depth = float(np.mean([st.waves for st in scans])) if scans else 0.0
    fetched = float(np.mean([st.fetched_bytes_per_query for st in scans])) if scans else 0.0
    lat_note = run.latency_note(lat_ms)
    print(f"method={args.method} index=graph mode=continuous shards=1 corpus={n} "
          f"requests={len(served)}/{s['submitted']} rows={total_q} ef={args.ef} "
          f"expand={args.expand} max_live={max_live} slo={args.slo} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} compile_ms={compile_ms:.0f}"
          f"{build_note} waves={s['waves']} occupancy={occupancy:.1f} "
          f"mean_depth={mean_depth:.1f} admission(admitted={s['admitted']} "
          f"retired={s['retired']} shed={s['admission_shed']}) "
          f"retire(frontier={s['retire_frontier']} budget={s['retire_budget']} "
          f"stall={s['retire_stall']}) fetched_B_per_q={fetched:.0f} device={dev}"
          f"{run.shed_note(sched)}{lat_note}", flush=True)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "waves": float(s["waves"]), "occupancy": float(occupancy),
              "mean_depth": mean_depth, "fetched_bytes_per_query": fetched,
              "queries": total_q, "admitted": s["admitted"], "retired": s["retired"],
              "admission_shed": s["admission_shed"], "retries": s["retries"],
              "requests_submitted": s["submitted"], "requests_served": s["served"],
              "requests_shed": shed, "device": str(dev)}
    return run.emit(report)


def serve_flat(run: ServeRun) -> dict:
    """The flat route: batched requests through the fused wave scan."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    srv = prepare_service(svc, args.method, dev)
    corpus, n, d_pad = srv.corpus, svc.corpus_per_device, srv.d_pad
    step = build_search_step(svc, with_stats=True, shards=args.shards)
    scan_totals = np.zeros((6,), np.float64)

    def fixed_step(batch_np):
        with current_tracer().span("engine.step", route="flat", batch=len(batch_np)):
            q = torch.as_tensor(batch_np, device=dev).to(srv.rows.dtype)
            d, i, st = step(srv.rows, srv.codes, srv.bscales, q, srv.eps, srv.scale,
                            srv.eps_lo)
            scan_totals[:] += st.cpu().numpy()
            return d.cpu().numpy(), i.cpu().numpy()

    def prep(q):
        # Queries travel as the row dtype (rounded), held in float32 numpy.
        return srv.prep(q).float().cpu().numpy()

    # The warm-up step's counters are discarded.
    compile_ms = run.warmup(fixed_step, prep(synthetic_queries(
        svc.query_batch, svc.dim, corpus, seed=999)))
    scan_totals[:] = 0.0
    sched = run.scheduler(fixed_step)
    payloads = run.payloads(corpus, srv.corpus_t, prep)
    reqs, gts, dt, lat_ms = run.drive(sched, payloads)
    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)

    # Stage-2 fetch report: every scanned wave tile ships its int8 block;
    # fp rows move in (128, Δd) slabs fetched only while stage 2 still has
    # active candidates.  A wave spans wave // 128 candidate tiles.
    s1_tiles, s2_slabs = scan_totals[5], scan_totals[4]
    fp_bytes = srv.rows.element_size()
    fetched, skipped, skip, _ = stage2_fetch_report(
        s1_tiles, s2_slabs, block_c=FUSED_BLOCK_C, d_pad=d_pad,
        block_d=svc.delta_d, fp_bytes=fp_bytes)
    waves = max(s1_tiles / (svc.wave // FUSED_BLOCK_C), 1.0)
    s1_bytes = fetched_tile_bytes(s1_tiles, block_c=FUSED_BLOCK_C, dims=d_pad,
                                  bytes_per_dim=1, id_bytes=ID_BYTES)
    record_fused_serve_totals(
        reg, s1_tiles=float(s1_tiles), s2_slabs=float(s2_slabs),
        s1_bytes=float(s1_bytes), s2_bytes=float(fetched),
        sem_bytes=float(two_stage_bytes(scan_totals[0], scan_totals[1],
                                        fp_bytes=fp_bytes)))
    # Fetched bytes of whole batches (pad rows included) per query served.
    fetched_q = (s1_bytes + fetched) / max(sched.stats["rows"], 1)
    lat_note = run.latency_note(lat_ms)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_submitted": sched.stats["submitted"],
              "requests_served": sched.stats["served"], "requests_shed": shed,
              "shards": args.shards, "fetched_bytes_per_query": float(fetched_q),
              "s2_skip_rate": float(skip), "device": str(dev)}
    print(f"method={args.method} quant={args.quant} devices=1 shards={args.shards} "
          f"corpus={n} "
          f"requests={len(served)}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} "
          f"pad_frac={sched.stats['padded_rows']/max(sched.stats['rows'], 1):.2f} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f} fused=megakernel"
          f" s2_fetched_B_per_wave={fetched/waves:.0f}"
          f" s2_skipped_B_per_wave={skipped/waves:.0f}"
          f" s2_skip_rate={skip:.3f} fetched_B_per_q={fetched_q:.0f}"
          f" device={dev}{run.shed_note(sched)}{lat_note}", flush=True)
    return run.emit(report)


def main(argv=None, *, graph: GraphService | None = None) -> dict:
    """Serve and print the report line; returns the report as a dict.
    ``graph`` hands the graph route an index :func:`prepare_graph` built
    for the same flags, in place of building it again."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    svc = ServiceConfig(
        corpus_per_device=args.corpus, dim=args.dim, query_batch=args.batch,
        k=args.k, delta_d=args.delta_d, wave=args.wave, p_s=args.p_s,
        dtype=args.dtype)
    # Telemetry: the registry always collects (writing is opt-in); the
    # tracer is installed only under --trace, so the default path keeps the
    # NULL_TRACER no-ops.  Chaos: the same null-object pattern.
    reg = MetricsRegistry()
    tracer = Tracer(tool="serve", index=args.index) if args.trace else None
    chaos = parse_chaos(args.chaos, registry=reg) if args.chaos else None
    for spec in chaos.specs if chaos else ():
        if spec.kind in UNPORTED_FAULTS:
            raise SystemExit(f"--chaos {spec.kind}: not ported "
                             f"(ROADMAP {UNPORTED_FAULTS[spec.kind]})")
    if chaos is not None:
        print("chaos: armed " + "; ".join(s.kind for s in chaos.specs), flush=True)
    if args.deadline_ms:
        reg.gauge("serve.deadline.budget_ms").set(args.deadline_ms)
    run = ServeRun(args, svc, dev, reg, tracer)
    set_tracer(tracer)
    set_chaos(chaos)
    try:
        if args.index == "graph":
            return serve_graph(run, graph)
        return serve_flat(run)
    finally:
        set_tracer(None)
        set_chaos(None)


if __name__ == "__main__":
    main()
