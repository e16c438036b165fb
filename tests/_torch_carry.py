"""Helpers for the port's parity tests: carry reference-built state into
``repro_torch`` through numpy (``repro_torch.interop``)."""

import numpy as np

from repro_torch import interop


def carry_estimator(est, device="cpu"):
    t, tb = est.transform, est.table
    return interop.estimator_from_arrays(
        est.method,
        dict(basis=np.asarray(t.basis), variances=np.asarray(t.variances),
             cum_variances=np.asarray(t.cum_variances)),
        dict(dims=np.asarray(tb.dims), eps=np.asarray(tb.eps),
             scale=np.asarray(tb.scale), eps_lo=np.asarray(tb.eps_lo)),
        quant=est.quant is not None, device=device)


def carry_ivf(idx, device="cpu"):
    return interop.ivf_from_arrays(
        carry_estimator(idx.estimator, device),
        centroids=np.asarray(idx.centroids),
        bucket_sizes=np.asarray(idx.bucket_sizes), starts=np.asarray(idx.starts),
        flat_rot=np.asarray(idx.flat_rot), flat_codes=np.asarray(idx.flat_codes),
        flat_ids=np.asarray(idx.flat_ids), bscales=np.asarray(idx.bscales),
        qbuckets=np.asarray(idx.qbuckets), qscales=np.asarray(idx.qscales),
        max_bucket=idx.max_bucket, scan_block_d=idx.scan_block_d, device=device)


def recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / gt.shape[1]
                          for i in range(len(ids))]))


def carry_graph(g, device="cpu"):
    return interop.graph_from_arrays(
        carry_estimator(g.estimator, device), corpus_rot=np.asarray(g.corpus_rot),
        neighbors=np.asarray(g.neighbors), entry=np.asarray(g.entry),
        corpus_q=np.asarray(g.corpus_q), qscales=np.asarray(g.qscales),
        adj_rot=np.asarray(g.adj_rot), adj_codes=np.asarray(g.adj_codes),
        adj_ids=np.asarray(g.adj_ids), gscales=np.asarray(g.gscales),
        adj_block=g.adj_block, scan_block_d=g.scan_block_d, device=device)
