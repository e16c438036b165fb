"""DADE vector-search serving on one card (the flat route of
``repro.launch.serve``: ``--index flat --quant int8 --fused on``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cuda] \
        [--requests 10] [--corpus 1048576] [--batch 1024] [--k 100]

Defaults are the ``dade_ivf`` serving configuration (2^20 x 256 corpus,
batch 1024, k=100, wave 8192, Δd=64, bf16 rows, int8 codes, DADE at
p_s=0.02).  Builds the estimator on a corpus sample, rotates and encodes
the corpus on the card, serves batched requests through the fused
wave-scan kernel and prints one report line: QPS, recall@k against exact
ground truth, the warm-up step's time (``compile_ms``; it includes the
first kernel build) and the stage-2 fetch figures.  Other routes (graph,
unquantized, unfused) are not ported: their flag values are refused.
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
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import FUSED_BLOCK_C, build_search_step
from repro_torch.quant.accounting import stage2_fetch_report
from repro_torch.quant.scalar import fit_block_scales, quantize_block
from repro_torch.runtime.scheduler import BatchScheduler

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--corpus", type=int, default=CONFIG.corpus_per_device)
    ap.add_argument("--dim", type=int, default=CONFIG.dim)
    ap.add_argument("--k", type=int, default=CONFIG.k)
    ap.add_argument("--batch", type=int, default=CONFIG.query_batch)
    ap.add_argument("--wave", type=int, default=CONFIG.wave)
    ap.add_argument("--delta-d", type=int, default=CONFIG.delta_d)
    ap.add_argument("--dtype", default=CONFIG.dtype, choices=sorted(_DTYPES))
    ap.add_argument("--method", default="dade",
                    choices=["dade", "adsampling", "fdscanning"])
    ap.add_argument("--p-s", type=float, default=CONFIG.p_s)
    ap.add_argument("--index", default="flat", choices=["flat"])
    ap.add_argument("--quant", default="int8", choices=["int8"])
    ap.add_argument("--fused", default="on", choices=["on"])
    return ap.parse_args(argv)


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


def main(argv=None) -> dict:
    """Serve and print the report line; returns the report as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    svc = ServiceConfig(
        corpus_per_device=args.corpus, dim=args.dim, query_batch=args.batch,
        k=args.k, delta_d=args.delta_d, wave=args.wave, p_s=args.p_s,
        dtype=args.dtype)
    srv = prepare_service(svc, args.method, dev)
    corpus, n, d_pad = srv.corpus, svc.corpus_per_device, srv.d_pad
    step = build_search_step(svc, with_stats=True)
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
    rec = float(np.mean([
        np.mean([len(set(req.result[1][i]) & set(gt[i])) / svc.k
                 for i in range(len(gt))])
        for req, (_, gt) in zip(reqs, payloads)]))
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
    report = {"qps": total_q / dt, "recall": rec, "compile_ms": compile_ms,
              "queries": total_q, "requests_served": served,
              "s2_skip_rate": float(skip), "device": str(dev)}
    print(f"method={args.method} quant={args.quant} devices=1 corpus={n} "
          f"requests={served}/{sched.stats['submitted']} rows={total_q} "
          f"batches={sched.stats['batches']} "
          f"pad_frac={sched.stats['padded_rows']/max(sched.stats['rows'], 1):.2f} "
          f"QPS={total_q/dt:.0f} recall@{svc.k}={rec:.3f} "
          f"compile_ms={compile_ms:.0f} fused=megakernel"
          f" s2_fetched_B_per_wave={fetched/waves:.0f}"
          f" s2_skipped_B_per_wave={skipped/waves:.0f}"
          f" s2_skip_rate={skip:.3f} device={dev}", flush=True)
    return report


if __name__ == "__main__":
    main()
