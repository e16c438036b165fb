#!/usr/bin/env python3
"""Recall@10 of ``chip_smoke.py`` phase 7's graph search at a given node
count: the NSW graph of the ``synthetic_vectors(seed=0)`` corpus at 256
dims (m 16, ef_construction 96, f32 rows, Δd 64, DADE at p_s 0.02, as
``launch.serve.prepare_graph`` builds it) and ``search_graph_fused`` for
1024 ``synthetic_queries(seed=1)`` at k 10, ef 48, expand 2, against the
exact top-10.  Which node counts keep phase 7's gate (recall@10 >= 0.80).

    PYTHONPATH=src python scripts/graph_recall.py 8192 16384 [--device cpu]

On CPU tensors the walk runs its plain version, which returns the
kernel's ids bit for bit, so the recall is the card's; the build and
search seconds printed are the host's, not the card's.
"""
import argparse
import time

from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core.topk import exact_knn
from repro_torch.data.pipeline import synthetic_queries
from repro_torch.index.graph import search_graph_fused
from repro_torch.launch.serve import prepare_graph


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("nodes", type=int, nargs="+")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for nodes in args.nodes:
        svc = ServiceConfig(corpus_per_device=nodes, dim=256, query_batch=1024, k=10,
                            delta_d=64, p_s=0.02, dtype="float32")
        t0 = time.perf_counter()
        srv = prepare_graph(svc, "dade", m=16, ef=48, device=args.device)
        build_s = time.perf_counter() - t0
        queries = synthetic_queries(1024, svc.dim, srv.corpus, seed=1)
        _, gt = exact_knn(queries, srv.corpus_t, 10, device=args.device)
        t0 = time.perf_counter()
        _, ids, _ = search_graph_fused(srv.index, queries, k=10, ef=48, expand=2,
                                       device=args.device)
        search_s = time.perf_counter() - t0
        ids, gt = ids.cpu().numpy(), gt.cpu().numpy()
        rec = sum(len(set(ids[i]) & set(gt[i])) for i in range(len(ids))) / ids.size
        print(f"nodes={nodes} recall@10={rec:.4f} (build {build_s:.1f}s, search "
              f"{search_s:.1f}s on {args.device})", flush=True)


if __name__ == "__main__":
    main()
