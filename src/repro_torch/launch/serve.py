"""DADE vector-search serving (the flat, graph, sharded graph, continuous
graph and churn routes of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cuda] \
        [--index flat] [--requests 10] [--corpus 1048576] [--batch 1024] [--k 100] \
        [--shards G] [--ranks R --dist-backend nccl|gloo] [--quant int8|none] \
        [--fused on|off] [--index-ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.serve --index graph \
        [--corpus 32768] [--k 10] [--ef 48] [--expand 2] [--m 16] [--index-ckpt DIR] \
        [--graph-shards N --dist-backend nccl|gloo] [--verify-degraded-oracle] \
        [--continuous --max-live SLOTS --slo LO:HI[:STALL]] [--verify-graph-oracle]
    PYTHONPATH=src python -m repro_torch.launch.serve --index graph \
        --mutate-rate MUTS [--wal PATH] [--verify-graph-oracle]

Flat route defaults are the ``dade_ivf`` serving configuration (2^20 x 256
corpus, batch 1024, k=100, wave 8192, Δd=64, bf16 rows, int8 codes, DADE
at p_s=0.02).  Builds the estimator on a corpus sample, rotates and
encodes the corpus on the card, serves batched requests through the fused
wave-scan kernel and prints one report line: QPS, recall@k against exact
ground truth, the warm-up step's time (``compile_ms``; it includes the
first kernel build) and the fetch figures.  ``--shards`` is the
reference's shard count (its ``--devices``), run on the one card as that
many segments of each scan, merged as the reference merges shards.
``--ranks R`` serves the flat route over R rank processes (the
reference's (R, G/R) mesh): each rank holds a 1/R share of the corpus and
walks it as G/R segments, and the windows merge across the ranks
(``annservice.RankedFlatStep``); R must divide ``--shards``.  ``--fused
off`` and ``--quant none`` serve the reference's unfused one-device routes
in plain PyTorch (a budget of exact refinements per wave over
per-dimension int8 codes; the fp rows alone).

The graph route builds the NSW graph (m=16, ef_construction=max(2·ef, 64),
f32 adjacency rows, int8 codes; the insertion loop runs on the host, so
its corpus defaults to 32,768 rows and k to 10) and serves each batch
through one launch of the beam walk; its line adds waves and fetched
bytes per query.  ``--graph-shards N`` splits the graph's nodes over N rank
processes (``annservice.sharded_graph_engine``): each rank holds its slab
rows, loaded from the index snapshot (``--index-ckpt``, or one written for
the run), and every wave is one launch per rank and an all-gather of the
windows; the walk equals ``search_graph_sharded(num_shards=1,
use_ref=True)``, which ``--verify-graph-oracle`` checks.  ``--chaos
shard_death:shard=S:after=B`` kills a shard mid-run: the survivors serve on
with its nodes tombstoned, and ``--verify-degraded-oracle`` holds them to
the surviving-corpus oracle.  ``--continuous`` serves the same graph with continuous
batching: queries join the one-wave kernel's wave step mid-walk
(``annservice.ContinuousGraphEngine`` under
``runtime.scheduler.ContinuousScheduler``), at most ``--max-live`` at a
time, each retired query bit-identical to its solo search; with
``--graph-shards N`` the host-simulated sharded walk (one launch per shard
a wave, in this process).  ``--index-ckpt DIR`` warm-restarts from a digest-verified snapshot (the
graph route's whole index, the flat route's estimator), or builds once and
saves there; a corrupted leaf falls back to a rebuild.

Churn (``--mutate-rate MUTS``, graph route): the graph is the streaming
mutable index (``index.mutable.MutableGraph``); MUTS mutations (3:1
upserts to deletes, upserts from the drifted distribution) run before each
request, each written to ``--wal`` before it is applied, and an existing
log is replayed onto a fresh base at boot (the crash-recovery path,
drilled by ``--chaos torn_upsert``).  A drift watchdog checks DADE
staleness before each request and swaps a recalibrated epsilon table in
behind a parity proof (suppressed under ``--chaos stale_transform``).  With
``--verify-graph-oracle`` the post-churn index must return the ids of a
from-scratch rebuild of the final corpus under the same tombstones, and
hold its arrays bit for bit.

Load and robustness (the reference's flags): ``--open-loop RATE`` serves
Poisson arrivals at RATE requests/s instead of one closed-loop drain and
reports p50/p95/p99 request latency; ``--deadline-ms``,
``--queue-watermark`` and ``--retries`` / ``--retry-backoff-ms`` shed late,
excess and failing work (``submitted == served + shed`` always);
``--chaos SPEC`` arms fault drills (``step_error``, ``queue_overload``,
``shard_stall``, ``shard_death``, ``slab_corruption``, ``torn_upsert``,
``stale_transform``).  Telemetry: ``--metrics-json PATH`` writes the
schema-versioned metrics snapshot that ``scripts/check_metrics_schema.py``
validates; ``--trace PATH`` writes a Chrome trace of the run's spans (its
fences wait for the card at span ends: leave it off for peak QPS).

Rank processes (``--ranks``, ``--graph-shards``) join a process group over
``--dist-backend``: ``nccl`` where every rank has a card of its own,
``gloo`` for several ranks on one card (or on the CPU); the report line
names it.  Ranks sharing one card are not chips: their rates are not
multi-chip rates.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.index_io import (
    load_estimator, load_graph_index, save_estimator, save_graph_index,
)
from repro_torch.checkpoint.wal import MutationLog, replay_into
from repro_torch.configs.dade_ivf import CONFIG, ServiceConfig
from repro_torch.core.estimators import Estimator, build_estimator, kernel_spec
from repro_torch.core.topk import exact_knn
from repro_torch.core.transforms import as_tensor
from repro_torch.data.pipeline import (
    drifted_vectors, synthetic_queries, synthetic_vectors,
)
from repro_torch.index.graph import (
    GraphIndex, build_graph, dead_shard_tombstones, search_graph_beam_host,
    search_graph_fused, search_graph_sharded,
)
from repro_torch.index.mutable import DriftWatchdog, MutableGraph
from repro_torch.kernels.graph_scan import KERNEL_TILE
from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import (
    FUSED_BLOCK_C, SHARDS, ContinuousGraphEngine, RankedFlatStep,
    autotune_refine_budget, build_graph_engine, build_search_step,
    flat_rank_worker, parse_slo, sharded_graph_engine,
)
from repro_torch.launch.mesh import LeadRank, make_mesh, mesh_device_type
from repro_torch.obs import (
    MetricsRegistry, Tracer, current_tracer, record_dco_method,
    record_drift, record_fused_serve_totals, record_graph_scan, record_graph_sharded,
    record_mutations, set_tracer, write_chrome_trace, write_metrics_json,
)
from repro_torch.quant.accounting import (
    ID_BYTES, fetched_tile_bytes, stage2_fetch_report, two_stage_bytes,
)
from repro_torch.quant.scalar import fit_block_scales, quantize_block, quantize_corpus
from repro_torch.runtime.chaos import (
    ChaosError, corrupt_checkpoint_leaf, current_chaos, parse_chaos, set_chaos,
)
from repro_torch.runtime.scheduler import BatchScheduler, ContinuousScheduler

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The graph route's corpus and k when not given: the host-side NSW build
# makes 2^20 rows an hours-long build.
GRAPH_NODES = 32768
GRAPH_K = 10
# The arrays the churn route's oracle holds equal to the rebuild's.
CHURN_ARRAYS = ("neighbors", "corpus_rot", "corpus_q", "qscales", "adj_rot",
                "adj_codes", "adj_ids", "gscales")


def backend_label(args) -> str:
    """The process-group backend as the report line names it: a gloo group
    on the card moves each collective's tensors through the host
    (``distributed.collectives.staged``)."""
    if args.dist_backend == "gloo" and args.device == "cuda":
        return "gloo(host-staged)"
    return args.dist_backend


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
    ap.add_argument("--ranks", type=int, default=1,
                    help="flat route: rank processes, each holding 1/R of the "
                         "corpus and walking --shards/R segments (the reference's "
                         "(R, G/R) mesh); R must divide --shards")
    ap.add_argument("--graph-shards", type=int, default=1,
                    help="--index graph: rank processes the graph's nodes split "
                         "over, with a frontier exchange every wave (with "
                         "--continuous: the host-simulated sharded walk); the "
                         "node count must divide evenly")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of --ranks / --graph-shards: nccl "
                         "(a card per rank) or gloo (ranks sharing a card, or the "
                         "CPU); default nccl on cuda, gloo on cpu")
    ap.add_argument("--verify-degraded-oracle", action="store_true",
                    help="after a --chaos shard_death drill on the sharded graph "
                         "route, require the degraded engine to return the "
                         "surviving-corpus oracle's results")
    ap.add_argument("--quant", default="int8", choices=["int8", "none"],
                    help="int8: stream the corpus as 1-byte codes (none: the fp "
                         "rows alone, the reference's plain wave screen)")
    ap.add_argument("--fused", default="on", choices=["on", "off"],
                    help="on: the fused wave-scan kernel; off: the reference's "
                         "unfused int8 route (a budget of exact refinements a wave)")
    ap.add_argument("--refine-per-wave", type=int, default=0,
                    help="exact refinements a wave of --fused off (0: autotuned "
                         "from the stage-1 band width)")
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
    ap.add_argument("--index-ckpt", default=None, metavar="DIR",
                    help="warm-restart snapshot dir: restore the built index (graph "
                         "route: graph and estimator; flat route: estimator) from "
                         "DIR instead of building it, or build once and save "
                         "there; per-leaf sha256 digests reject corrupted slabs "
                         "and fall back to a rebuild")
    ap.add_argument("--mutate-rate", type=float, default=0.0, metavar="MUTS",
                    help="churn drill (--index graph): apply MUTS mutations between "
                         "requests through the streaming mutable index (3:1 "
                         "upsert:delete, upserts from the drifted distribution), "
                         "write-ahead logged to --wal; reports recall under churn "
                         "and the mutate.* and calib.drift.* families")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="mutation-log path of --mutate-rate (default "
                         "<--index-ckpt>/mutations.wal with a snapshot dir, else "
                         "unlogged); an existing log is replayed onto a fresh base "
                         "before serving, its torn tail truncated")
    args = ap.parse_args(argv)
    if args.mutate_rate > 0 and args.index != "graph":
        ap.error("--mutate-rate requires --index graph (the streaming mutable "
                 "index is the graph route)")
    if args.mutate_rate > 0 and args.graph_shards != 1:
        ap.error("--mutate-rate serves a single replica (--graph-shards 1): "
                 "mutable growth slabs are not corpus-sharded")
    if args.continuous and args.index != "graph":
        ap.error("--continuous requires --index graph (mid-walk admission is a "
                 "property of the wave-synchronous beam walk)")
    if args.continuous and args.mutate_rate > 0:
        ap.error("--continuous and --mutate-rate are separate drills; run them "
                 "in separate serves")
    if args.graph_shards < 1 or args.ranks < 1:
        ap.error("--graph-shards and --ranks must be >= 1")
    if args.graph_shards > 1 and args.index != "graph":
        ap.error(f"--graph-shards {args.graph_shards}: it shards the --index graph route")
    if args.verify_degraded_oracle and args.index != "graph":
        ap.error("--verify-degraded-oracle checks the sharded --index graph route")
    if args.ranks > 1 and (args.index != "flat" or args.quant != "int8"
                           or args.fused != "on"):
        ap.error("--ranks serves the fused flat route (--index flat --quant int8 "
                 "--fused on)")
    if args.shards % args.ranks:
        ap.error(f"--ranks {args.ranks} must divide --shards {args.shards}")
    if args.dist_backend is None:
        args.dist_backend = "nccl" if args.device == "cuda" else "gloo"
    if args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl needs --device cuda")
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


def prepare_service(svc: ServiceConfig, method: str, device,
                    est: Estimator | None = None) -> Service:
    """Build the estimator on a corpus sample (unless ``est``, a restored
    one, is given), then rotate and encode the ``synthetic_vectors(seed=0)``
    corpus on ``device``."""
    dev = resolve_device(device)
    corpus = synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0)
    corpus_t = as_tensor(corpus, dev)
    if est is None:
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


def graph_estimator(svc: ServiceConfig, method: str, corpus_t: torch.Tensor) -> Estimator:
    """The graph routes' estimator: fitted on a corpus sample as the flat
    route's, with the int8 policy, on the corpus's device."""
    return build_estimator(method, corpus_t[:50000], torch.Generator().manual_seed(0),
                           p_s=svc.p_s, delta_d=svc.delta_d, quant="int8",
                           device=corpus_t.device)


def prepare_graph(svc: ServiceConfig, method: str, *, m: int, ef: int,
                  device) -> GraphService:
    """Build the estimator on a corpus sample as the flat route does, then
    the NSW graph of the ``synthetic_vectors(seed=0)`` corpus with the
    reference's serving settings: degree ``m``, ``ef_construction =
    max(2·ef, 64)``, f32 adjacency rows, int8 codes, Δd-wide blocks."""
    dev = resolve_device(device)
    corpus = synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0)
    corpus_t = as_tensor(corpus, dev)
    index = build_graph(corpus_t, estimator=graph_estimator(svc, method, corpus_t),
                        m=m, ef_construction=max(2 * ef, 64), quant="int8", device=dev)
    return GraphService(corpus=corpus, corpus_t=corpus_t, index=index)


def maybe_corrupt_snapshot(directory: str) -> None:
    """The ``slab_corruption`` drill: flip one byte of a committed snapshot
    leaf (when one exists) so the restore's digest check must catch it."""
    step_dir = os.path.join(directory, f"step_{0:09d}")
    if not os.path.isdir(step_dir):
        return
    spec = current_chaos().take_corruption()
    if spec is not None:
        path = corrupt_checkpoint_leaf(step_dir, leaf=spec.leaf)
        print(f"chaos: corrupted snapshot leaf {spec.leaf} ({path})", flush=True)


class ServeRun:
    """One serve invocation's load driver and telemetry: the metrics
    registry (always collecting; written under ``--metrics-json``), the
    scheduler's request accounting, and the report line's figures."""

    def __init__(self, args, svc: ServiceConfig, dev, reg: MetricsRegistry, tracer):
        self.args, self.svc, self.dev, self.reg, self.tracer = args, svc, dev, reg, tracer
        self.config = {k.replace("-", "_"): v for k, v in vars(args).items()}
        # Rank processes (the host-simulated continuous walk runs in one),
        # and the distinct cards they ran on: ranks sharing a card are not
        # devices.
        ranks = max(args.ranks,
                    args.graph_shards if args.index == "graph" and not args.continuous else 1)
        cards = min(ranks, torch.cuda.device_count()) if dev.type == "cuda" else 1
        self.config.update(rank_processes=ranks, devices=cards, corpus=svc.corpus_per_device)

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
        spread = np.std(corpus, axis=0, keepdims=True)  # one pass for every request
        out = []
        for r in range(self.args.requests):
            nq = int(rng.integers(svc.query_batch // 2, 2 * svc.query_batch))
            q = synthetic_queries(nq, svc.dim, corpus, seed=100 + r, spread=spread)
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

    @staticmethod
    def ids_digest(served) -> str:
        """sha256 of every served request's ids, in request order: two runs
        that served the same neighbours give the same digest."""
        h = hashlib.sha256()
        for req, _ in served:
            h.update(np.ascontiguousarray(req.result[1], np.int64).tobytes())
        return h.hexdigest()

    def recall(self, served) -> float:
        """Mean recall@k over the served requests (shed ones have none)."""
        k = self.svc.k
        per = [np.mean([len(set(req.result[1][i]) & set(gt[i])) / k
                        for i in range(len(gt))]) for req, gt in served]
        return float(np.mean(per)) if per else 0.0

    def degraded_split(self, served) -> tuple[str, dict]:
        """Recall of the requests served with a dead shard against the
        healthy ones: the cost of failover, measured on this run's traffic."""
        deg = [(r, g) for r, g in served if r.degraded]
        if not deg:
            return "", {}
        healthy = [(r, g) for r, g in served if not r.degraded]
        dr = self.recall(deg)
        delta = self.recall(healthy) - dr if healthy else 0.0
        self.reg.counter("graph.sharded.degraded.requests").add(len(deg))
        self.reg.gauge("graph.sharded.degraded.recall").set(dr)
        self.reg.gauge("graph.sharded.degraded.recall_delta").set(delta)
        return (f" degraded(requests={len(deg)} recall={dr:.3f} delta={delta:+.3f})",
                {"degraded_requests": len(deg), "degraded_recall": dr,
                 "degraded_recall_delta": delta})

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
    srv, restored = prepared, False
    graph_cfg = {"corpus": svc.corpus_per_device, "dim": svc.dim, "method": args.method,
                 "m": args.m, "ef_construction": max(2 * args.ef, 64), "quant": "int8"}
    if args.index_ckpt:
        maybe_corrupt_snapshot(args.index_ckpt)
        gidx = None
        try:
            gidx = load_graph_index(args.index_ckpt, expect_config=graph_cfg, device=dev)
        except IOError as e:
            print(f"index-ckpt: {e}; falling back to rebuild", flush=True)
        if gidx is not None:
            restored = True
            reg.counter("serve.ckpt.restored").add(1)
            print(f"index-ckpt: restored graph index from {args.index_ckpt}", flush=True)
            corpus = (prepared.corpus if prepared is not None
                      else synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0))
            srv = GraphService(corpus=corpus, corpus_t=as_tensor(corpus, dev), index=gidx)
    if srv is None:
        srv = prepare_graph(svc, args.method, m=args.m, ef=args.ef, device=dev)
    if args.index_ckpt and not restored:
        save_graph_index(args.index_ckpt, srv.index, config=graph_cfg)
        reg.counter("serve.ckpt.saved").add(1)
        print(f"index-ckpt: saved graph index to {args.index_ckpt}", flush=True)
    build_note = "" if prepared or restored else f" build_s={time.perf_counter() - t0:.1f}"
    if (srv.index.corpus_rot.shape != (svc.corpus_per_device, svc.dim)
            or srv.index.degree != args.m):
        raise ValueError("the prepared graph does not match --corpus/--dim/--m")
    corpus, n = srv.corpus, svc.corpus_per_device
    if args.continuous:
        return serve_continuous(run, srv, build_note)
    if args.graph_shards > 1:
        return serve_graph_sharded(run, srv, build_note)
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
              "ckpt": "restored" if restored else ("saved" if args.index_ckpt else "off"),
              "ids_sha256": run.ids_digest(served), "device": str(dev)}
    print(f"method={args.method} index=graph quant={args.quant} devices=1 corpus={n} "
          f"requests={sched.stats['served']}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} ef={args.ef} expand={args.expand} "
          f"m={args.m} QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f}{build_note} waves={waves:.0f} "
          f"fetched_B_per_q={fetched:.0f} s2_skip_rate={skip:.3f} device={dev}"
          f"{run.shed_note(sched)}{lat_note}", flush=True)
    return run.emit(report)


def serve_graph_sharded(run: ServeRun, srv: GraphService, build_note: str) -> dict:
    """``--index graph --graph-shards N``: the graph's nodes split over N rank
    processes (``annservice.sharded_graph_engine``), this process rank 0.
    The other ranks load their slab rows from the ``--index-ckpt`` snapshot,
    or from one written for the run and removed after it.  With
    ``--verify-graph-oracle`` the engine must return the ids and distances
    of ``search_graph_sharded(num_shards=1, use_ref=True)`` (the
    frozen-threshold oracle) bit for bit; with ``--verify-degraded-oracle``,
    after a ``shard_death`` drill, those of the same oracle over the
    surviving corpus."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    corpus, n, shards = srv.corpus, svc.corpus_per_device, args.graph_shards
    snapshot = args.index_ckpt
    if snapshot is None:
        snapshot = tempfile.mkdtemp(prefix="graph-shards-")
        save_graph_index(snapshot, srv.index)
    try:
        with sharded_graph_engine(srv.index, snapshot, num_shards=shards,
                                  backend=args.dist_backend, k=svc.k, ef=args.ef,
                                  expand=args.expand, device=args.device) as engine:
            report = _serve_sharded(run, srv, engine, build_note)
    finally:
        if args.index_ckpt is None:
            shutil.rmtree(snapshot, ignore_errors=True)
    report["rank_launches"] = [engine.ranks[r]["launches"] for r in sorted(engine.ranks)]
    return run.emit(report)


def _check_sharded_oracle(srv: GraphService, engine, vq, *, args, k: int, dev,
                          tombstones=(), label: str) -> None:
    d_e, i_e, _ = engine(vq)
    d_o, i_o, _ = search_graph_sharded(srv.index, vq, num_shards=1, k=k, ef=args.ef,
                                       expand=args.expand, use_ref=True, device=dev,
                                       tombstones=tombstones)
    if not np.array_equal(i_e, i_o.cpu().numpy()):
        raise SystemExit(f"{label}: ids diverge from the oracle")
    if not np.array_equal(d_e, d_o.cpu().numpy()):
        raise SystemExit(f"{label}: distances diverge from the oracle")


def _serve_sharded(run: ServeRun, srv: GraphService, engine, build_note: str) -> dict:
    """The sharded graph route's serving loop on rank 0; returns the report
    (its line printed)."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    corpus, n, shards = srv.corpus, svc.corpus_per_device, args.graph_shards
    if args.verify_graph_oracle:
        vq = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=77)
        _check_sharded_oracle(srv, engine, vq, args=args, k=svc.k, dev=dev,
                              label=f"graph serving over {shards} shards")
        print(f"verify: shards={shards} engine bit-identical to the single-shard "
              f"frozen-threshold oracle ({svc.query_batch} queries)", flush=True)
    g_stats = []

    def g_step(batch_np):
        d, i, st = engine(batch_np)
        g_stats.append(st)
        return d, i

    compile_ms = run.warmup(engine, synthetic_queries(svc.query_batch, svc.dim, corpus,
                                                      seed=999))
    sched = run.scheduler(g_step)
    payloads = run.payloads(corpus, srv.corpus_t, lambda q: q)
    reqs, gts, dt, lat_ms = run.drive(sched, payloads)
    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)
    waves = sum(st.waves for st in g_stats)
    mean = (lambda xs: float(np.mean(xs)) if xs else 0.0)
    fetched = mean([st.fetched_bytes_per_query for st in g_stats])
    skip = mean([st.s2_skip_rate for st in g_stats])
    for st in g_stats:
        record_graph_sharded(reg, st, queries=svc.query_batch)
    lat_note = run.latency_note(lat_ms)
    if args.verify_degraded_oracle:
        dead = current_chaos().dead_shards(shards)
        if not dead:
            print("verify-degraded: no dead shards at the end of the run; nothing "
                  "to check", flush=True)
        else:
            vq = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=78)
            _check_sharded_oracle(srv, engine, vq, args=args, k=svc.k, dev=dev,
                                  tombstones=dead_shard_tombstones(n, shards, dead),
                                  label="degraded serving")
            print(f"verify-degraded: engine with dead shards {sorted(dead)} "
                  f"bit-identical to the surviving-corpus oracle "
                  f"({svc.query_batch} queries)", flush=True)
    # What each shard's memory ships a wave, and what the exchange carries.
    shard_fpw = [sum(st.shard_fetched_bytes_per_query[s] * svc.query_batch
                     for st in g_stats) / max(waves, 1.0) for s in range(shards)]
    exch_pw = mean([st.exchange_bytes_per_wave for st in g_stats])
    exch_pq = mean([st.exchange_bytes_per_query for st in g_stats])
    deg_note, deg_report = run.degraded_split(served)
    shard_note = " ".join(f"shard{s}_fetched_B_per_wave={b:.0f}"
                          for s, b in enumerate(shard_fpw))
    print(f"method={args.method} index=graph shards={shards} backend={backend_label(args)} "
          f"corpus={n} requests={len(served)}/{sched.stats['submitted']} rows={total_q} "
          f"ef={args.ef} expand={args.expand} QPS={total_q/dt:.0f} "
          f"recall@{svc.k}={rec:.3f} compile_ms={compile_ms:.0f}{build_note} "
          f"waves={waves:.0f} fetched_B_per_q={fetched:.0f} {shard_note} "
          f"exchange_B_per_wave={exch_pw:.0f} exchange_B_per_q={exch_pq:.0f} "
          f"s2_skip_rate={skip:.3f} device={dev}{run.shed_note(sched)}{deg_note}"
          f"{lat_note}", flush=True)
    return {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
            "waves": float(waves), "fetched_bytes_per_query": fetched,
            "exchange_bytes_per_wave": exch_pw, "exchange_bytes_per_query": exch_pq,
            "s2_skip_rate": skip, "queries": total_q, "batches": sched.stats["batches"],
            "requests_submitted": sched.stats["submitted"],
            "requests_served": sched.stats["served"], "requests_shed": shed,
            "shards": shards, "backend": backend_label(args),
            "ids_sha256": run.ids_digest(served), "device": str(dev), **deg_report}


def serve_continuous(run: ServeRun, srv: GraphService, build_note: str) -> dict:
    """``--index graph --continuous``: the continuous engine under the
    continuous scheduler, with its warm-up and (``--verify-graph-oracle``)
    the interleaving check: 8 queries walking concurrently must equal each
    one served alone by ``search_graph_fused`` and by the plain walk, or
    with ``--graph-shards N`` (the host-simulated sharded walk) by
    ``search_graph_sharded(num_shards=N, use_ref=True)``.  With
    ``--verify-degraded-oracle``, after a ``shard_death`` drill, 8 queries
    admitted to a fresh engine must equal the surviving-corpus oracle."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    corpus, n = srv.corpus, svc.corpus_per_device
    max_live = args.max_live or svc.query_batch
    slo = parse_slo(args.slo)
    shards = args.graph_shards

    def new_engine(policy):
        return ContinuousGraphEngine(srv.index, k=svc.k, ef=args.ef,
                                     expand=args.expand, num_shards=shards, slo=policy)

    def run_solo(vq):
        """``vq`` walked concurrently through a fresh SLO-off engine (the
        oracles walk at fixed expand); the retired queries in row order."""
        veng = new_engine(None)
        hmap = {veng.admit(vq[i]): i for i in range(len(vq))}
        out = {}
        while veng.live_count():
            for rq in veng.step():
                out[hmap[rq.handle]] = rq
        rqs = [out[i] for i in range(len(vq))]
        return np.stack([r.dists for r in rqs]), np.stack([r.ids for r in rqs]), rqs

    def sharded_oracle(vq, label, **kw):
        dv, iv, rqs = run_solo(vq)
        solo = [search_graph_sharded(srv.index, vq[i: i + 1], k=svc.k, ef=args.ef,
                                     expand=args.expand, use_ref=True, device=dev, **kw)
                for i in range(len(vq))]
        if not (np.array_equal(iv, np.concatenate([o[1].cpu().numpy() for o in solo]))
                and np.array_equal(dv, np.concatenate([o[0].cpu().numpy() for o in solo]))):
            raise SystemExit(f"{label} diverges from its solo oracle")
        return rqs, solo

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

    nv = min(svc.query_batch, 8)
    if args.verify_graph_oracle and shards > 1:
        vq = synthetic_queries(nv, svc.dim, corpus, seed=77)
        rqs, solo = sharded_oracle(vq, "continuous sharded serving", num_shards=shards)
        if not all(r.stats == o[2] for r, o in zip(rqs, solo)):
            raise SystemExit("continuous sharded serving: ledgers diverge from the "
                             "solo walks'")
        print(f"verify: continuous engine (shards={shards}) bit-identical to the solo "
              f"sharded oracle ({nv} interleaved queries)", flush=True)
    elif args.verify_graph_oracle:
        vq = synthetic_queries(nv, svc.dim, corpus, seed=77)
        dv, iv, rqs = run_solo(vq)
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
        (record_graph_sharded if shards > 1 else record_graph_scan)(reg, st, queries=1)
    if args.verify_degraded_oracle:
        dead = current_chaos().dead_shards(shards)
        if not dead:
            print("verify-degraded: no dead shards at the end of the run; nothing "
                  "to check", flush=True)
        else:
            vq = synthetic_queries(nv, svc.dim, corpus, seed=78)
            rqs, _ = sharded_oracle(vq, "continuous degraded serving", num_shards=1,
                                    tombstones=dead_shard_tombstones(n, shards, dead))
            if not all(r.degraded for r in rqs):
                raise SystemExit("post-death admissions not flagged degraded")
            print(f"verify-degraded: continuous admissions with dead shards "
                  f"{sorted(dead)} bit-identical to the surviving-corpus oracle "
                  f"({nv} queries)", flush=True)
    deg_note, deg_report = run.degraded_split(served)
    s = sched.stats
    occupancy = s["live_rows"] / max(s["waves"], 1)
    scans = sched.scan_stats
    mean_depth = float(np.mean([st.waves for st in scans])) if scans else 0.0
    fetched = float(np.mean([st.fetched_bytes_per_query for st in scans])) if scans else 0.0
    lat_note = run.latency_note(lat_ms)
    print(f"method={args.method} index=graph mode=continuous shards={shards} corpus={n} "
          f"requests={len(served)}/{s['submitted']} rows={total_q} ef={args.ef} "
          f"expand={args.expand} max_live={max_live} slo={args.slo} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} compile_ms={compile_ms:.0f}"
          f"{build_note} waves={s['waves']} occupancy={occupancy:.1f} "
          f"mean_depth={mean_depth:.1f} admission(admitted={s['admitted']} "
          f"retired={s['retired']} shed={s['admission_shed']}) "
          f"retire(frontier={s['retire_frontier']} budget={s['retire_budget']} "
          f"stall={s['retire_stall']}) fetched_B_per_q={fetched:.0f} device={dev}"
          f"{run.shed_note(sched)}{deg_note}{lat_note}", flush=True)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "waves": float(s["waves"]), "occupancy": float(occupancy),
              "mean_depth": mean_depth, "fetched_bytes_per_query": fetched,
              "queries": total_q, "admitted": s["admitted"], "retired": s["retired"],
              "admission_shed": s["admission_shed"], "retries": s["retries"],
              "requests_submitted": s["submitted"], "requests_served": s["served"],
              "requests_shed": shed, "shards": shards, "device": str(dev), **deg_report}
    return run.emit(report)


class _WalHolder:
    """Append-before-apply for recalibration swaps: the new table reaches
    the log before the serving estimator, so replay reproduces the
    estimator's history too."""

    def __init__(self, state: dict):
        self._st = state

    @property
    def estimator(self):
        return self._st["idx"].estimator

    def set_estimator(self, e) -> None:
        if self._st["log"] is not None:
            self._st["log"].append_set_table(e.table)
        self._st["idx"].set_estimator(e)


def serve_churn(run: ServeRun) -> dict:
    """``--index graph --mutate-rate R``: the streaming mutable index.

    The graph is a ``MutableGraph``: upserts continue the graph build's
    insertion inside pre-reserved capacity (array for array a rebuild of
    the grown corpus), deletes tombstone.  ``round(R)`` mutations (3:1
    upserts to deletes, upserts from ``drifted_vectors(seed=11)``) run
    before each request, every one logged to ``--wal`` before it is
    applied; an existing log is replayed onto a fresh base at boot, and a
    ``torn_upsert`` crash recovers the same way.  The drift watchdog
    checks before each request and swaps a recalibrated table in behind its
    parity proof (suppressed under ``stale_transform``).  Recall is
    measured against the live corpus at submit time.  With
    ``--verify-graph-oracle`` the final index must return the ids (and,
    to ``rtol=5e-5, atol=1e-5``, the distances) of a from-scratch
    ``build_graph`` over the final corpus under the same tombstones.  The
    report carries each request's split: ``mutate_ms`` (log writes and
    upserts, the slab writes included), ``view_ms`` (the index view),
    ``drift_ms`` and ``search_ms``, and the boot and recovery times."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    n = svc.corpus_per_device
    bq = KERNEL_TILE[0]
    g_m, g_efc = args.m, max(2 * args.ef, 64)
    n_mut = int(round(args.requests * args.mutate_rate))
    cap = n + 2 * n_mut + 64
    wal_path = args.wal or (os.path.join(args.index_ckpt, "mutations.wal")
                            if args.index_ckpt else None)
    corpus = synthetic_vectors(n, svc.dim, seed=0)
    corpus_t = as_tensor(corpus, dev)
    est = graph_estimator(svc, args.method, corpus_t)
    # Upserts come from the drifted distribution (faster spectrum decay in
    # the fitted basis), where a stale epsilon table over-prunes: the
    # watchdog has a real signal.
    pool = drifted_vectors(est.transform, max(n_mut, 1), seed=11)
    rng_m = np.random.default_rng(13)
    st: dict = {}
    boot_s: list[float] = []

    def boot() -> None:
        """(Re)build the serving state: a fresh base and the log's replay;
        at start-up and after a torn-append crash (the torn record was
        never applied, so truncating it is exactly right)."""
        t0 = time.perf_counter()
        st["log"] = MutationLog(wal_path) if wal_path else None
        st["idx"] = MutableGraph(corpus_t, m=g_m, ef_construction=g_efc, capacity=cap,
                                 estimator=est, quant="int8", device=dev)
        st["wd"] = DriftWatchdog(corpus, reservoir=min(1024, n), p_s=svc.p_s,
                                 num_pairs=1024)
        st["ups"] = []
        log = st["log"]
        if log is not None and (log.seq or log.recovered_torn):
            recs = log.replay()
            for rec in recs:
                if rec["op"] == "upsert":
                    st["wd"].observe(rec["vec"])
                    st["ups"].append(np.asarray(rec["vec"], np.float32))
            counts = replay_into(st["idx"], recs)
            reg.counter("serve.wal.replayed").add(len(recs))
            if log.recovered_torn:
                reg.counter("serve.wal.recovered_torn").add(1)
                st["torn"] = st.get("torn", 0) + 1
            print(f"wal: replayed {counts} from {wal_path}"
                  + (" (torn tail truncated)" if log.recovered_torn else ""), flush=True)
        dead = {g for b, c in st["idx"].tombstones for g in range(b, b + c)}
        st["live"] = [g for g in range(st["idx"].count) if g not in dead]
        boot_s.append(time.perf_counter() - t0)

    boot()
    holder = _WalHolder(st)

    def mutate_once() -> None:
        idx, log = st["idx"], st["log"]
        if st["live"] and rng_m.random() < 0.25:
            gid = st["live"][int(rng_m.integers(len(st["live"])))]
            if log is not None:
                log.append_delete(gid)
            idx.delete(gid)
            st["live"].remove(gid)
            return
        vec = pool[min(idx.ledger.upserts, len(pool) - 1)]
        if idx.count >= idx.capacity:
            # Refused mutations never reach the log: it holds applied
            # operations only, so replay cannot diverge at capacity.
            idx.ledger.applied += 1
            idx.ledger.rejected += 1
            return
        if log is not None:
            log.append_upsert(idx.count, vec)
        gid = idx.upsert(vec)
        st["wd"].observe(vec)
        st["ups"].append(np.asarray(vec, np.float32))
        st["live"].append(gid)

    def crash_recover(e: Exception) -> None:
        print(f"chaos: {e}", flush=True)
        if st["log"] is not None:
            st["log"].close()
        print("chaos: simulated crash — recovering (fresh base + wal replay)", flush=True)
        boot()

    def apply_mutations(count: int) -> None:
        for _ in range(count):
            try:
                mutate_once()
            except ChaosError as e:
                crash_recover(e)
                mutate_once()  # the fault is one-shot; the retry commits

    def drift_tick() -> None:
        try:
            rep = st["wd"].maybe_recalibrate(holder)
        except ChaosError as e:
            crash_recover(e)
            return
        if rep["swapped"]:
            print(f"drift: stat={rep['stat']:.3f} > {rep['threshold']:.3f}; epsilon "
                  f"table recalibrated and swapped in (parity proof passed)", flush=True)
        elif rep.get("suppressed"):
            print(f"drift: stat={rep['stat']:.3f} fired but the swap was suppressed "
                  f"(stale_transform drill)", flush=True)
        elif rep["fired"]:
            print(f"drift: fired (stat={rep['stat']:.3f}) but the parity proof "
                  f"failed; the stale table stays", flush=True)

    def m_step(batch_np):
        with current_tracer().span("engine.step", route="graph-churn", batch=len(batch_np)):
            d, i, _ = st["idx"].search(batch_np, k=svc.k, ef=args.ef, expand=args.expand,
                                       block_q=bq)
        return d.cpu().numpy(), i.cpu().numpy()

    compile_ms = run.warmup(m_step, synthetic_queries(svc.query_batch, svc.dim, corpus,
                                                      seed=999))
    sched = run.scheduler(m_step)
    lat = reg.histogram("serve.request.latency_ms")
    reqs, gts, lat_ms = [], [], []
    split = {"mutate_ms": [], "drift_ms": [], "view_ms": [], "search_ms": []}
    rng_q = np.random.default_rng(9)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    t0 = time.perf_counter()
    with current_tracer().span("serve.drive", churn=True):
        for r in range(args.requests):
            t_a = time.perf_counter()
            apply_mutations(int(round(args.mutate_rate)))
            t_b = time.perf_counter()
            drift_tick()
            t_c = time.perf_counter()
            st["idx"].index  # the view the request searches
            t_d = time.perf_counter()
            nq = int(rng_q.integers(svc.query_batch // 2, 2 * svc.query_batch))
            q = synthetic_queries(nq, svc.dim, corpus, seed=100 + r)
            # Ground truth against the LIVE corpus at submit time.
            live = np.asarray(sorted(st["live"]), np.int64)
            rows = (np.concatenate([corpus, np.stack(st["ups"])])
                    if st["ups"] else corpus)[live]
            _, gt = exact_knn(q, rows, svc.k, device=dev)
            t_e = time.perf_counter()
            reqs.append(sched.submit(q, deadline_s=deadline_s))
            gts.append(live[gt.cpu().numpy()])
            done = sched.drain(force=True)
            t_done = time.perf_counter()
            for req in done:
                ms = (t_done - req.enqueued_at) * 1e3
                lat.observe(ms)
                lat_ms.append(ms)
            split["mutate_ms"].append((t_b - t_a) * 1e3)
            split["drift_ms"].append((t_c - t_b) * 1e3)
            split["view_ms"].append((t_d - t_c) * 1e3)
            split["search_ms"].append((t_done - t_e) * 1e3)
    dt = time.perf_counter() - t0

    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)
    lat_note = run.latency_note(lat_ms)
    idx, wd = st["idx"], st["wd"]
    idx.ledger.check()
    n_tomb = idx.count - idx.live_count
    record_mutations(reg, idx.ledger, tombstones=n_tomb)
    record_drift(reg, wd)
    wal_records = st["log"].records_written if st["log"] else 0
    if st["log"] is not None:
        reg.counter("serve.wal.appended").add(wal_records)

    verified = False
    if args.verify_graph_oracle:
        # The churn acceptance check: the mutated index returns the ids of
        # a from-scratch build_graph over the final corpus under the same
        # tombstones (and the same, possibly recalibrated, estimator).
        t_v = time.perf_counter()
        full = np.concatenate([corpus, np.stack(st["ups"])]) if st["ups"] else corpus
        ridx = build_graph(as_tensor(full, dev), estimator=idx.estimator, m=g_m,
                           ef_construction=g_efc, quant="int8", device=dev)
        rebuild_s = time.perf_counter() - t_v
        vq = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=77)
        t = idx.tombstones
        dv, iv, _ = idx.search(vq, k=svc.k, ef=args.ef, expand=args.expand, block_q=bq)
        do, io_, _ = search_graph_fused(ridx, vq, k=svc.k, ef=args.ef, expand=args.expand,
                                        block_q=bq, tombstones=t, exclude=t, device=dev)
        if not torch.equal(iv, io_):
            raise SystemExit("post-churn: mutated index ids diverge from the "
                             "from-scratch rebuild oracle")
        if not torch.allclose(dv, do, rtol=5e-5, atol=1e-5):
            raise SystemExit("post-churn: mutated index distances diverge from the "
                             "from-scratch rebuild oracle")
        live_idx = idx.index
        differ = [f for f in CHURN_ARRAYS
                  if not torch.equal(getattr(live_idx, f), getattr(ridx, f))]
        if differ or live_idx.entry != ridx.entry:
            raise SystemExit(f"post-churn: mutated index arrays differ from the "
                             f"rebuild's: {differ or ['entry']}")
        verified = True
        print(f"verify-churn: mutated index ({idx.ledger.upserts} upserts, "
              f"{idx.ledger.deletes} deletes, {idx.ledger.requantizes} requantizes) "
              f"returns the from-scratch rebuild's ids ({svc.query_batch} queries), "
              f"its arrays the rebuild's bit for bit ({', '.join(CHURN_ARRAYS)}, "
              f"entry; rebuild {rebuild_s:.1f} s)", flush=True)

    mean = (lambda xs: float(np.mean(xs)) if xs else 0.0)
    print(f"method={args.method} index=graph churn corpus={n} live={idx.live_count} "
          f"requests={len(served)}/{sched.stats['submitted']} rows={total_q} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} compile_ms={compile_ms:.0f} "
          f"mutate(applied={idx.ledger.applied} upserts={idx.ledger.upserts} "
          f"deletes={idx.ledger.deletes} rejected={idx.ledger.rejected} "
          f"requantize={idx.ledger.requantizes} tombstones={n_tomb}) "
          f"wal(records={wal_records}) drift(checks={wd.checks} fired={wd.fired} "
          f"recal={wd.recalibrations} suppressed={wd.suppressed} "
          f"stat={wd.last_stat:.3f}) per_request_ms(mutate={mean(split['mutate_ms']):.1f} "
          f"drift={mean(split['drift_ms']):.1f} view={mean(split['view_ms']):.3f} "
          f"search={mean(split['search_ms']):.1f}) boot_s="
          f"{'/'.join(f'{b:.1f}' for b in boot_s)} device={dev}"
          f"{run.shed_note(sched)}{lat_note}", flush=True)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_submitted": sched.stats["submitted"],
              "requests_served": sched.stats["served"], "requests_shed": shed,
              "mutations_applied": idx.ledger.applied, "upserts": idx.ledger.upserts,
              "deletes": idx.ledger.deletes, "rejected": idx.ledger.rejected,
              "requantizes": idx.ledger.requantizes, "tombstones": n_tomb,
              "drift_checks": wd.checks, "drift_fired": wd.fired,
              "drift_recalibrations": wd.recalibrations,
              "drift_suppressed": wd.suppressed, "wal_records": wal_records,
              "wal_recovered_torn": st.get("torn", 0),
              "boots": len(boot_s), "boot_s": boot_s[0],
              "recovery_s": boot_s[1] if len(boot_s) > 1 else 0.0,
              "verified": verified, "device": str(dev),
              **{f"mean_{k}": mean(v) for k, v in split.items()}, "split": split}
    if st["log"] is not None:
        st["log"].close()
    return run.emit(report)


def serve_flat(run: ServeRun) -> dict:
    """The flat route: batched requests through the fused wave scan, in
    this process or (``--ranks R``) over R rank processes, this one rank 0
    (``annservice.RankedFlatStep``: each rank holds ``--corpus / R`` rows)."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    est = None
    est_cfg = {"corpus": svc.corpus_per_device, "dim": svc.dim, "method": args.method,
               "p_s": svc.p_s, "delta_d": svc.delta_d}
    if args.index_ckpt:
        maybe_corrupt_snapshot(args.index_ckpt)
        try:
            est = load_estimator(args.index_ckpt, expect_config=est_cfg, device=dev)
        except IOError as e:
            print(f"index-ckpt: {e}; recalibrating", flush=True)
        if est is not None:
            reg.counter("serve.ckpt.restored").add(1)
            print(f"index-ckpt: restored estimator from {args.index_ckpt}", flush=True)
    srv = prepare_service(svc, args.method, dev, est=est)
    if args.index_ckpt and est is None:
        save_estimator(args.index_ckpt, srv.est, config=est_cfg)
        reg.counter("serve.ckpt.saved").add(1)
        print(f"index-ckpt: saved estimator to {args.index_ckpt}", flush=True)
    quant = None if args.quant == "none" else args.quant
    fused = quant == "int8" and args.fused == "on"
    route_note, operands = " fused=megakernel", (srv.codes, srv.bscales)
    if quant == "int8" and not fused:
        # The reference's unfused int8 route: per-dimension codes of the
        # padded rotated corpus (padded dims get scale 0), a refine budget
        # autotuned from the stage-1 band unless given.
        c_rot = srv.rows.float()
        qc = quantize_corpus(c_rot)
        operands = (qc.codes, qc.scales)
        budget = args.refine_per_wave
        if budget == 0:
            budget, diag = autotune_refine_budget(
                qc.scales, c_rot[:4096].cpu().numpy(), k=svc.k, wave=svc.wave)
            route_note = (f" fused=off refine_per_wave={budget}(auto,"
                          f"band={diag['band_width']:.3g},"
                          f"in_band={diag['in_band_frac']:.4f})")
        else:
            route_note = f" fused=off refine_per_wave={budget}(fixed)"
        svc = dataclasses.replace(svc, refine_per_wave=budget)
    elif quant is None:
        route_note, operands = " quant=none", ()
    if args.ranks == 1:
        step = (build_search_step(svc, with_stats=True, shards=args.shards) if fused
                else build_search_step(svc, quant=quant, fused=False))
        return run.emit(_serve_flat_loop(
            run, srv, lambda q: step(srv.rows, *operands, q, srv.eps, srv.scale, srv.eps_lo),
            fused=fused, route_note=route_note, est=est))
    mdt = mesh_device_type(args.dist_backend)
    timings: dict = {}
    with LeadRank(flat_rank_worker, args.ranks, backend=args.dist_backend,
                  device=args.device, args=(svc, args.shards, mdt)) as lead:
        mesh = make_mesh((args.ranks,), ("rank",), mdt)
        ranked = RankedFlatStep(svc, mesh, srv.rows, srv.codes, srv.bscales, srv.eps,
                                srv.scale, srv.eps_lo, shards=args.shards, timings=timings)
        launches0 = ivf_scan_kernel_call.launches
        report = _serve_flat_loop(
            run, srv, ranked, fused=True, est=est, timings=timings,
            route_note=f" fused=megakernel ranks={args.ranks} backend={backend_label(args)}")
        ranked.close()
        rank0 = ivf_scan_kernel_call.launches - launches0
    report["rank_launches"] = [rank0] + [lead.results[r]["launches"]
                                         for r in sorted(lead.results)]
    return run.emit(report)


def _serve_flat_loop(run: ServeRun, srv: Service, step, *, fused: bool, route_note: str,
                     est, timings: dict | None = None) -> dict:
    """Serve the flat route's requests through ``step(queries) -> (dists,
    ids[, scan])``; prints the report line and returns the report.
    ``timings`` (the ranked step's) adds the merge's ms a batch."""
    args, svc, dev, reg = run.args, run.svc, run.dev, run.reg
    corpus, n, d_pad = srv.corpus, svc.corpus_per_device, srv.d_pad
    scan_totals = np.zeros((6,), np.float64)

    def fixed_step(batch_np):
        with current_tracer().span("engine.step", route="flat", batch=len(batch_np)):
            q = torch.as_tensor(batch_np, device=dev).to(srv.rows.dtype)
            out = step(q)
            if fused:
                scan_totals[:] += out[2].cpu().numpy()
            return out[0].cpu().numpy(), out[1].cpu().numpy()

    def prep(q):
        # Queries travel as the row dtype (rounded), held in float32 numpy.
        return srv.prep(q).float().cpu().numpy()

    # The warm-up step's counters are discarded.
    compile_ms = run.warmup(fixed_step, prep(synthetic_queries(
        svc.query_batch, svc.dim, corpus, seed=999)))
    scan_totals[:] = 0.0
    if timings is not None:
        timings.clear()
    sched = run.scheduler(fixed_step)
    payloads = run.payloads(corpus, srv.corpus_t, prep)
    reqs, gts, dt, lat_ms = run.drive(sched, payloads)
    served, shed = run.accounting(sched, reqs, gts)
    rec = run.recall(served)
    total_q = sum(len(g) for _, g in served)
    lat_note = run.latency_note(lat_ms)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_submitted": sched.stats["submitted"],
              "requests_served": sched.stats["served"], "requests_shed": shed,
              "shards": args.shards if fused else 1, "ranks": args.ranks,
              "backend": backend_label(args) if args.ranks > 1 else None,
              "ckpt": ("off" if not args.index_ckpt else "restored" if est is not None
                       else "saved"),
              "ids_sha256": run.ids_digest(served), "device": str(dev)}
    if timings is not None:
        report["merge_ms_per_batch"] = timings.get("merge_ms", 0.0) / max(
            sched.stats["batches"], 1)
        route_note += f" merge_ms_per_batch={report['merge_ms_per_batch']:.3f}"
    fetch_note = ""
    if fused:
        # Stage-2 fetch report: every scanned wave tile ships its int8
        # block; fp rows move in (128, Δd) slabs fetched only while stage 2
        # still has active candidates.  A wave spans wave // 128 tiles.
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
        report.update(fetched_bytes_per_query=float(fetched_q), s2_skip_rate=float(skip))
        fetch_note = (f" s2_fetched_B_per_wave={fetched/waves:.0f}"
                      f" s2_skipped_B_per_wave={skipped/waves:.0f}"
                      f" s2_skip_rate={skip:.3f} fetched_B_per_q={fetched_q:.0f}")
    print(f"method={args.method} quant={args.quant} devices=1 "
          f"shards={report['shards']} corpus={n} "
          f"requests={len(served)}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} "
          f"pad_frac={sched.stats['padded_rows']/max(sched.stats['rows'], 1):.2f} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f}{route_note}{fetch_note}"
          f" device={dev}{run.shed_note(sched)}{lat_note}", flush=True)
    return report


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
    if (chaos is not None and any(s.kind == "shard_death" for s in chaos.specs)
            and (args.index != "graph" or args.graph_shards == 1)):
        raise SystemExit("--chaos shard_death needs a sharded route (--index graph "
                         "--graph-shards N > 1)")
    if chaos is not None:
        print("chaos: armed " + "; ".join(s.kind for s in chaos.specs), flush=True)
    if args.deadline_ms:
        reg.gauge("serve.deadline.budget_ms").set(args.deadline_ms)
    run = ServeRun(args, svc, dev, reg, tracer)
    set_tracer(tracer)
    set_chaos(chaos)
    try:
        if args.index == "graph" and args.mutate_rate > 0:
            return serve_churn(run)
        if args.index == "graph":
            return serve_graph(run, graph)
        return serve_flat(run)
    finally:
        set_tracer(None)
        set_chaos(None)


if __name__ == "__main__":
    main()
