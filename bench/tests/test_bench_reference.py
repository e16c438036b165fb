"""The reference's exact top-k against a numpy brute force, and the control
reading worse than the exact search."""

import numpy as np
import torch

from bench import data, judge, reference

SPEC = {"rows": 5000, "dim": 64, "data_seed": 0, "n_modes": 16, "decay": 0.05}


def _brute(x, q, k):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.sqrt(np.take_along_axis(d, ids, 1)), ids


def test_bench_exact_topk_is_brute_force(monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 1024)  # several blocks, a ragged last
    x = data.corpus(SPEC, 17, "cpu")
    q = torch.from_numpy(data.query_pool(x, 40, 17))
    d, ids = reference.exact_topk(x, q, 25)
    bd, bids = _brute(x.numpy(), q.numpy(), 25)
    assert np.array_equal(ids.numpy(), bids)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_bench_distances_mark_ids_outside():
    x = data.corpus(SPEC, 17, "cpu")
    q = x[:2] + 1.0
    ids = torch.tensor([[0, 1, -1], [4999, 5000, 3]])
    d = reference.distances(x, q, ids)
    assert torch.isinf(d[0, 2]) and torch.isinf(d[1, 1])
    assert float(d[0, 0]) == float(torch.sqrt(((x[0].double() - q[0].double()) ** 2).sum()))


def test_bench_control_reads_worse_than_exact():
    x = data.corpus(SPEC, 17, "cpu")
    qn = data.query_pool(x, 64, 17)
    q = torch.from_numpy(qn)
    ex_d, ex_i = reference.exact_topk(x, q, 10)
    ctl = reference.Int8Search(x, block_d=32, k=10, fit_rows=2000)
    d, ids = ctl(qn)
    assert d.shape == (64, 10) and ids.dtype == np.int32
    assert judge.form_faults(ids, d, 5000) == 0
    own = reference.distances(x, q, torch.from_numpy(ids.astype(np.int64)))
    g = judge.gaps(d, own.numpy(), ex_d.numpy())
    assert g["dist_err"] > 1e-3 and judge.recall(ids, ex_i.numpy()) < 1.0
