"""DADE vector-search serving on one card (the flat and graph routes of
``repro.launch.serve``: ``--index flat|graph --quant int8 --fused on``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cuda] \
        [--index flat] [--requests 10] [--corpus 1048576] [--batch 1024] [--k 100] \
        [--shards G]
    PYTHONPATH=src python -m repro_torch.launch.serve --index graph \
        [--corpus 32768] [--k 10] [--ef 48] [--expand 2] [--m 16]

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
through the beam scan, one ``graph_scan`` launch per frontier wave; its
line adds waves and fetched bytes per query.  Both routes serve closed
loop.  Other routes (unquantized, unfused, sharded or continuous graph
serving) are not ported: their flag values are refused.
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
from repro_torch.index.graph import GraphIndex, build_graph
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import (
    FUSED_BLOCK_C, SHARDS, build_graph_engine, build_search_step,
)
from repro_torch.quant.accounting import ID_BYTES, fetched_tile_bytes
from repro_torch.quant.accounting import stage2_fetch_report
from repro_torch.quant.scalar import fit_block_scales, quantize_block
from repro_torch.runtime.scheduler import BatchScheduler

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The graph route's corpus and k when not given: the host-side NSW build
# makes 2^20 rows an hours-long build.
GRAPH_NODES = 32768
GRAPH_K = 10


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
    args = ap.parse_args(argv)
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


def serve_graph(args, svc: ServiceConfig, dev, prepared: GraphService | None) -> dict:
    """The ``--index graph`` route: serve ``args.requests`` requests through
    the beam-scan engine; prints the report line and returns it as a dict."""
    t0 = time.perf_counter()
    srv = prepared or prepare_graph(svc, args.method, m=args.m, ef=args.ef, device=dev)
    build_note = "" if prepared else f" build_s={time.perf_counter() - t0:.1f}"
    if (srv.index.corpus_rot.shape != (svc.corpus_per_device, svc.dim)
            or srv.index.degree != args.m):
        raise ValueError("the prepared graph does not match --corpus/--dim/--m")
    corpus, n = srv.corpus, svc.corpus_per_device
    engine = build_graph_engine(srv.index, k=svc.k, ef=args.ef,
                                expand=args.expand, device=dev)
    g_stats = []

    def g_step(batch_np):
        d, i, st = engine(batch_np)
        g_stats.append(st)
        return d, i

    # The warm-up batch (first kernel build and launch) runs outside the
    # clock, through the engine directly, so its ledgers are not counted.
    t0 = time.perf_counter()
    engine(synthetic_queries(svc.query_batch, svc.dim, corpus, seed=999))
    compile_ms = (time.perf_counter() - t0) * 1e3

    rng = np.random.default_rng(9)
    payloads = []
    for r in range(args.requests):
        nq = int(rng.integers(svc.query_batch // 2, 2 * svc.query_batch))
        q = synthetic_queries(nq, svc.dim, corpus, seed=100 + r)
        _, gt = exact_knn(q, srv.corpus_t, svc.k, device=dev)
        payloads.append((q, gt.cpu().numpy()))

    sched = BatchScheduler(g_step, batch_size=svc.query_batch)
    t0 = time.perf_counter()
    reqs = [sched.submit(q) for q, _ in payloads]
    sched.drain()
    dt = time.perf_counter() - t0
    rec = _recall(reqs, payloads, svc.k)
    total_q = sum(len(req.queries) for req in reqs)
    waves = sum(st.waves for st in g_stats)
    fetched = float(np.mean([st.fetched_bytes_per_query for st in g_stats]))
    skip = float(np.mean([st.s2_skip_rate for st in g_stats]))
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q,
              "requests_served": sched.stats["served"],
              "batches": sched.stats["batches"], "waves": float(waves),
              "fetched_bytes_per_query": fetched, "s2_skip_rate": skip,
              "device": str(dev)}
    print(f"method={args.method} index=graph quant={args.quant} devices=1 corpus={n} "
          f"requests={sched.stats['served']}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} ef={args.ef} expand={args.expand} "
          f"m={args.m} QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f}{build_note} waves={waves:.0f} "
          f"fetched_B_per_q={fetched:.0f} s2_skip_rate={skip:.3f} device={dev}",
          flush=True)
    return report


def _recall(reqs, payloads, k: int) -> float:
    return float(np.mean([
        np.mean([len(set(req.result[1][i]) & set(gt[i])) / k
                 for i in range(len(gt))])
        for req, (_, gt) in zip(reqs, payloads)]))


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
    if args.index == "graph":
        return serve_graph(args, svc, dev, graph)
    srv = prepare_service(svc, args.method, dev)
    corpus, n, d_pad = srv.corpus, svc.corpus_per_device, srv.d_pad
    step = build_search_step(svc, with_stats=True, shards=args.shards)
    scan_totals = np.zeros((6,), np.float64)

    def fixed_step(batch_np):
        q = torch.as_tensor(batch_np, device=dev).to(srv.rows.dtype)
        d, i, st = step(srv.rows, srv.codes, srv.bscales, q, srv.eps, srv.scale,
                        srv.eps_lo)
        scan_totals[:] += st.cpu().numpy()
        return d.cpu().numpy(), i.cpu().numpy()

    def prep(q):
        # Queries travel as the row dtype (rounded), held in float32 numpy.
        return srv.prep(q).float().cpu().numpy()

    # The warm-up step (first kernel build and launch) runs outside the
    # clock; its counters are discarded.
    t0 = time.perf_counter()
    fixed_step(prep(synthetic_queries(svc.query_batch, svc.dim, corpus, seed=999)))
    compile_ms = (time.perf_counter() - t0) * 1e3
    scan_totals[:] = 0.0

    # Every request's queries and exact ground truth are made before the
    # clock starts — ground truth is evaluation, not serving work.
    rng = np.random.default_rng(9)
    payloads = []
    for r in range(args.requests):
        nq = int(rng.integers(svc.query_batch // 2, 2 * svc.query_batch))
        q = synthetic_queries(nq, svc.dim, corpus, seed=100 + r)
        _, gt = exact_knn(q, srv.corpus_t, svc.k, device=dev)
        payloads.append((prep(q), gt.cpu().numpy()))

    sched = BatchScheduler(fixed_step, batch_size=svc.query_batch)
    t0 = time.perf_counter()
    reqs = [sched.submit(q) for q, _ in payloads]
    sched.drain()
    dt = time.perf_counter() - t0
    rec = _recall(reqs, payloads, svc.k)
    total_q = sum(len(req.queries) for req in reqs)
    served = sched.stats["served"]

    # Stage-2 fetch report: every scanned wave tile ships its int8 block;
    # fp rows move in (128, Δd) slabs fetched only while stage 2 still has
    # active candidates.  A wave spans wave // 128 candidate tiles.
    s1_tiles, s2_slabs = scan_totals[5], scan_totals[4]
    fetched, skipped, skip, _ = stage2_fetch_report(
        s1_tiles, s2_slabs, block_c=FUSED_BLOCK_C, d_pad=d_pad,
        block_d=svc.delta_d, fp_bytes=srv.rows.element_size())
    waves = max(s1_tiles / (svc.wave // FUSED_BLOCK_C), 1.0)
    # Fetched bytes of whole batches (pad rows included) per query served.
    fetched_q = (fetched_tile_bytes(s1_tiles, block_c=FUSED_BLOCK_C, dims=d_pad,
                                    bytes_per_dim=1, id_bytes=ID_BYTES)
                 + fetched) / max(sched.stats["rows"], 1)
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_served": served, "shards": args.shards,
              "fetched_bytes_per_query": float(fetched_q),
              "s2_skip_rate": float(skip), "device": str(dev)}
    print(f"method={args.method} quant={args.quant} devices=1 shards={args.shards} "
          f"corpus={n} "
          f"requests={served}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} "
          f"pad_frac={sched.stats['padded_rows']/max(sched.stats['rows'], 1):.2f} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f} fused=megakernel"
          f" s2_fetched_B_per_wave={fetched/waves:.0f}"
          f" s2_skipped_B_per_wave={skipped/waves:.0f}"
          f" s2_skip_rate={skip:.3f} fetched_B_per_q={fetched_q:.0f}"
          f" device={dev}", flush=True)
    return report


if __name__ == "__main__":
    main()
