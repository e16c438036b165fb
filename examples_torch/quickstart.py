"""Quickstart: the quantized two-stage DCO + the fused IVF kernel, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Builds a DADE estimator, stores the corpus as int8 codes next to the fp32
rows (``quant="int8"``), and answers the same queries two ways:

  1. the fp32 DADE wave scan (the paper's adaptive-dimension screen), and
  2. the fused IVF wave-scan kernel (int8 prefilter -> demand-paged fp32
     re-screen, one launch of the hand-written ``ivf_scan`` CUDA kernel per
     search on the card; its plain PyTorch version on CPU tensors).

It runs on the card unless ``--device cpu`` is given.  The asserts at the
bottom are the contract: quant+fused must match exact ground truth at high
recall while fetching fewer corpus bytes than the fp32 screen consumed.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import build_estimator, exact_knn, knn_search_waves
from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
from repro_torch.index.ivf import build_ivf, search_ivf_fused


def recall(ids, gt) -> float:
    ids, gt = np.asarray(ids.cpu()), np.asarray(gt.cpu())
    return float(np.mean([
        len(set(ids[i].tolist()) & set(gt[i].tolist())) / gt.shape[1]
        for i in range(len(gt))
    ]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = ap.parse_args(argv).device

    corpus = synthetic_vectors(6000, 96, seed=0, decay=0.06)
    queries = synthetic_queries(32, 96, corpus)
    _, gt = exact_knn(queries, corpus, 10, device=dev)

    # Fit the data-aware transform + calibrate the hypothesis test (paper §3)
    est = build_estimator("dade", corpus, torch.Generator().manual_seed(0),
                          p_s=0.1, delta_d=32, device=dev)

    # 1. fp32 DADE flat wave scan: adaptive dims, 4 B per dim consumed.
    c_rot = est.rotate(torch.as_tensor(corpus, device=dev))
    q_rot = est.rotate(torch.as_tensor(queries, device=dev))
    res = knn_search_waves(q_rot, c_rot, est.table, k=10, wave=4096)
    r_fp = recall(res.ids, gt)
    fp_bytes = 4.0 * float(res.avg_dims) * corpus.shape[0]
    print(f"fp32 DADE     recall@10={r_fp:.3f} "
          f"avg dims={float(res.avg_dims):.1f}/{corpus.shape[1]} "
          f"~{fp_bytes/1e3:.0f} kB/query")

    # 2. int8 + fused search: quant build stores codes + the CSR flat
    # layout; one kernel launch streams the probed buckets, prefilters on
    # the int8 product and demand-pages fp32 slabs for survivors.
    idx = build_ivf(corpus, estimator=est, n_clusters=24, quant="int8",
                    scan_block_d=32, device=dev)
    dists, ids, st = search_ivf_fused(idx, torch.as_tensor(queries, device=dev), k=10,
                                      n_probe=8, block_q=8)
    r_fused = recall(ids, gt)
    print(f"fused int8    recall@10={r_fused:.3f} "
          f"fetched={st.fetched_bytes_per_query/1e3:.0f} kB/query "
          f"(s2 skip rate {st.s2_skip_rate:.0%}, "
          f"int8 dims/row {st.avg_int8_dims:.1f}, "
          f"fp32 dims/row {st.avg_fp_dims:.2f})")

    assert r_fused >= 0.95, f"fused recall regressed: {r_fused:.3f}"
    assert st.fetched_bytes_per_query < fp_bytes, (
        f"fused path must fetch fewer bytes than the fp32 screen consumed: "
        f"{st.fetched_bytes_per_query:.0f} vs {fp_bytes:.0f}")
    print("OK")


if __name__ == "__main__":
    main()
