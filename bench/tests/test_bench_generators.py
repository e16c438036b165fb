"""The seeded generators repeat exactly, and every seed offers the same work
in another order."""

import numpy as np
import torch

from bench import data, loadgen, manifest

SPEC = {"rows": 3000, "dim": 48, "data_seed": 0, "n_modes": 16, "decay": 0.05}
SEED = 3_000_000_019  # more than 32 signed bits hold


def test_bench_corpus_repeats():
    a = data.corpus(SPEC, SEED, "cpu")
    b = data.corpus(SPEC, SEED, "cpu")
    c = data.corpus(SPEC, SEED + 1, "cpu")
    assert a.shape == (3000, 48) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bench_corpus_draws_in_fixed_chunks(monkeypatch):
    monkeypatch.setattr(data, "CHUNK", 1000)
    a = data.corpus(SPEC, SEED, "cpu")
    b = data.corpus(dict(SPEC, rows=1000), SEED, "cpu")
    # a longer corpus begins with the shorter one: rows come chunk by chunk
    assert torch.equal(a[:1000], b)


def test_bench_corpus_has_the_recipes_spectrum():
    x = data.corpus(dict(SPEC, rows=20000), SEED, "cpu")
    _, _, rot = data.mixture(48, data_seed=0, n_modes=16, decay=0.05)
    var = (x @ rot.T).var(0)  # back in the unrotated basis
    assert var[0] > 20 * var[-1]


def test_bench_query_pool_repeats():
    x = data.corpus(SPEC, SEED, "cpu")
    a = data.query_pool(x, 500, SEED)
    b = data.query_pool(x, 500, SEED)
    c = data.query_pool(x, 500, SEED + 1)
    assert a.shape == (500, 48) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # each query lies near a corpus row: jitter of 0.1 sigma
    d = torch.cdist(torch.from_numpy(a), x).min(1).values
    assert float(d.max()) < float(torch.cdist(x[:50], x[50:]).min())


def _traffic(name):
    return manifest.cell(name).traffic


def test_bench_closed_sizes_repeat_and_share_a_multiset():
    t = _traffic("deep1m.batch")
    a = loadgen.Mix(t, SEED).closed_sizes()
    b = loadgen.Mix(t, SEED).closed_sizes()
    c = loadgen.Mix(t, 5).closed_sizes()
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))
    assert a.min() >= 512 and a.max() < 2048


def test_bench_open_schedule_repeats_and_shares_its_counts():
    t = _traffic("deep1m.online")
    due_a, size_a = loadgen.Mix(t, SEED).open_schedule(3.0)
    due_b, size_b = loadgen.Mix(t, SEED).open_schedule(3.0)
    due_c, size_c = loadgen.Mix(t, 7).open_schedule(3.0)
    assert np.array_equal(due_a, due_b) and np.array_equal(size_a, size_b)
    assert len(due_a) == len(due_c) and not np.array_equal(due_a, due_c)
    assert np.array_equal(np.sort(size_a), np.sort(size_c))
    assert np.all(np.diff(due_a) >= 0) and due_a[-1] < 3.0
    assert size_a.min() >= 1 and size_a.max() <= 64
    rate = t["arrivals"]["phases"][0][1]
    assert abs(len(due_a) / 3.0 - rate) < 5 * np.sqrt(rate * 3.0) / 3.0


def test_bench_open_schedule_bursts():
    t = dict(_traffic("deep1m.online"),
             arrivals={"kind": "open", "phases": [[0.5, 2000.0], [0.5, 100.0]]})
    due, _ = loadgen.Mix(t, SEED).open_schedule(2.0)
    on = np.sum((due % 1.0) < 0.5)
    off = len(due) - on
    assert on > 5 * off


def test_bench_pool_hands_out_rows_in_turn():
    q = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    p = loadgen.Pool(q)
    off, a = p.take(4)
    off2, b = p.take(8)
    assert off == 0 and off2 == 4
    assert np.array_equal(a, q[:4])
    assert np.array_equal(b, q[[4, 5, 6, 7, 8, 9, 0, 1]])
