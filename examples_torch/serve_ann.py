"""End-to-end example (the paper's kind is serving), on the PyTorch/CUDA
port: a batched DADE vector search service over a rank-sharded
*int8-quantized* corpus, with index persistence and request batching.

    PYTHONPATH=src python examples_torch/serve_ann.py --ranks 8 --requests 5
    PYTHONPATH=src python examples_torch/serve_ann.py --device cpu --ranks 2 --corpus 4096

Uses the same mesh step ``launch.serve --ranks`` serves
(``annservice.build_search_step(mesh=...)`` through ``RankedFlatStep``):
this process is rank 0 of ``--ranks`` processes joined over gloo (ranks on
one card share it; every collective goes through the host), each rank
holding ``--corpus / --ranks`` rows and walking them as one segment of the
fused wave-scan kernel (int8 per-block prefilter, then the demand-paged
fp32 re-screen: the hand-written ``ivf_scan`` CUDA kernel on the card, its
plain PyTorch version on CPU tensors); the ranks' top-k windows merge over
the mesh.  ``--ranks`` / ``--corpus`` (the whole corpus) take the place of
the reference's ``--devices`` / ``--corpus-per-device``; the fused route
is the only one, so the reference's ``--fused`` has no counterpart.  It
runs on the card unless ``--device cpu`` is given.  The recall check at
the bottom is the contract.
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core import build_estimator, exact_knn
from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import RankedFlatStep, flat_rank_worker
from repro_torch.launch.mesh import LeadRank, make_mesh
from repro_torch.quant import fit_block_scales, quantize_block

ROW_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--corpus", type=int, default=8 * 16384,
                    help="corpus rows in all (each rank holds corpus / ranks)")
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    dev = args.device
    if args.corpus % args.ranks:
        sys.exit(f"--ranks {args.ranks} must divide --corpus {args.corpus}")
    svc = ServiceConfig(
        corpus_per_device=args.corpus // args.ranks, dim=args.dim,
        query_batch=args.batch, k=args.k, delta_d=32, wave=4096,
        quant="int8")

    n = args.corpus
    print(f"[ingest] corpus {n}x{svc.dim} over {args.ranks} ranks")
    corpus = synthetic_vectors(n, svc.dim, seed=0)
    corpus_t = torch.as_tensor(corpus, device=dev)
    est = build_estimator("dade", corpus_t[:50000], torch.Generator().manual_seed(0),
                          p_s=svc.p_s, delta_d=svc.delta_d, device=dev)
    eps, scale, d_pad, eps_lo = block_table(est.table, svc.dim, svc.delta_d)
    c_rot = torch.nn.functional.pad(est.rotate(corpus_t), (0, d_pad - svc.dim))

    # Kernel route: per-BLOCK int8 codes feed the int8 prefilter; survivors
    # re-screen exactly in-kernel.
    qscales = fit_block_scales(c_rot, svc.delta_d)
    codes = quantize_block(c_rot, qscales, svc.delta_d)
    print("[ingest] int8 per-block codes (fused kernel route)")

    # persist the index (transform + codes' scales + table) like a real
    # service: the int8 mirror is part of the servable state.
    ckpt_dir = tempfile.mkdtemp(prefix="dade_index-")
    try:
        ckpt = CheckpointManager(ckpt_dir, async_save=False, keep=1)
        ckpt.save(0, {"basis": est.transform.basis, "eps": eps, "scale": scale,
                      "eps_lo": eps_lo, "qscales": qscales})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    rows = c_rot.to(ROW_DTYPES[svc.dtype])
    with LeadRank(flat_rank_worker, args.ranks, backend="gloo", device=dev,
                  args=(svc, args.ranks, "cpu")) as lead:
        mesh = make_mesh((args.ranks,), ("rank",), "cpu")
        step = RankedFlatStep(svc, mesh, rows, codes, qscales, eps, scale, eps_lo,
                              shards=args.ranks)

        def rotated(q):
            q_rot = est.rotate(torch.as_tensor(q, device=lead.device))
            return torch.nn.functional.pad(q_rot, (0, d_pad - svc.dim)).to(rows.dtype)

        print("[serve] warmup...")
        q0 = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=99)
        step(rotated(q0))

        total_q, t_total = 0, 0.0
        last = None
        for r in range(args.requests):
            q = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=100 + r)
            q_rot = rotated(q)
            t0 = time.perf_counter()
            dists, ids, _ = step(q_rot)
            if dists.device.type == "cuda":
                torch.cuda.synchronize(dists.device)
            dt = time.perf_counter() - t0
            total_q += svc.query_batch
            t_total += dt
            last = (q, ids)
            print(f"[serve] request {r}: {svc.query_batch} queries in "
                  f"{dt*1e3:.1f} ms ({svc.query_batch/dt:.0f} QPS)")
        step.close()

    q, ids = last
    _, gt = exact_knn(q, corpus, svc.k, device=dev)
    ids, gt = ids.cpu().numpy(), gt.cpu().numpy()
    recall = np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / svc.k
                      for i in range(len(q))])
    print(f"[serve] total {total_q/t_total:.0f} QPS, recall@{svc.k} = {recall:.3f}")
    if recall < 0.95:
        sys.exit("recall regression")


if __name__ == "__main__":
    main()
