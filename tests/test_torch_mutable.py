"""Port parity for the streaming mutable index (``repro_torch.index.mutable``,
``checkpoint`` and the metrics schema), one counterpart of each test of
``tests/test_mutable.py``, each holding the port against the reference's
own object on the same inputs (the reference's estimators carried over
with ``tests/_torch_carry.py``).

Tolerances: graph arrays, ids, masks, ledgers and reservoirs are equal;
distances agree to fp32 rounding (``rtol=5e-5, atol=1e-5``, the
reference's own oracle tolerance) because the two packages' screens sum in
different orders.  Both packages rotate a corpus row alike only when the
arithmetic is exact, so the cross-package array comparisons of the graph
run under a signed-permutation basis (each rotated element is one exact
product); the port's own rebuild comparisons run under the real PCA
basis, where the port's row-wise rotation (``apply_rows``) makes an
upserted row equal the same row rotated with the whole corpus.  The drift
watchdog's pairs are drawn with ``jax.random`` as the reference draws
them and handed to the port explicitly."""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.index.mutable as j_mut  # noqa: E402
from _torch_carry import carry_estimator  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.wal import MutationLog as JLog  # noqa: E402
from repro.core.estimators import build_estimator  # noqa: E402
from repro.core.transforms import OrthogonalTransform as JTransform  # noqa: E402
from repro.data.pipeline import drifted_vectors  # noqa: E402
from repro.index.graph import search_graph_fused as j_search  # noqa: E402
from repro.index.ivf import search_ivf as j_search_ivf  # noqa: E402
from repro.runtime.chaos import use_chaos as j_use_chaos  # noqa: E402
from repro.runtime.chaos import parse_chaos as j_parse_chaos  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.wal import MutationLog, replay_into  # noqa: E402
from repro_torch.core.estimators import kernel_spec  # noqa: E402
from repro_torch.index.flat import build_flat, search_flat  # noqa: E402
from repro_torch.index.graph import build_graph, search_graph_fused  # noqa: E402
from repro_torch.index.ivf import IVFIndex, search_ivf  # noqa: E402
from repro_torch.index.mutable import (  # noqa: E402
    DriftWatchdog, MutableFlat, MutableGraph, MutableIVF, ids_to_ranges)
from repro_torch.runtime.chaos import (  # noqa: E402
    ChaosError, parse_chaos, use_chaos)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
GRAPH_FIELDS = ("neighbors", "corpus_rot", "qscales", "corpus_q", "gscales",
                "adj_ids", "adj_codes", "adj_rot")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-5, atol=1e-5)


def _ledger_eq(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _permuted(est, seed=5):
    """``est`` with a signed-permutation basis: every rotated element is
    one exact product, so both packages rotate bit for bit alike."""
    dim = est.transform.basis.shape[0]
    rng = np.random.default_rng(seed)
    basis = (np.eye(dim)[rng.permutation(dim)]
             * np.where(rng.random(dim) < 0.5, -1.0, 1.0)).astype(np.float32)
    t = est.transform
    return dataclasses.replace(est, transform=JTransform(
        basis=jnp.asarray(basis), variances=t.variances, cum_variances=t.cum_variances))


def test_ids_to_ranges_merges_runs():
    for ids in ([], [3], [5, 3, 4, 9, 11, 12], [7, 1, 2, 0, 30, 31, 29]):
        assert ids_to_ranges(ids) == j_mut.ids_to_ranges(ids)
    assert ids_to_ranges([5, 3, 4, 9, 11, 12]) == ((3, 3), (9, 1), (11, 2))


# ---- graph: array-level rebuild equivalence --------------------------------


def _churn_rows(aniso_corpus):
    corpus = np.asarray(aniso_corpus)[:160]
    extra = np.asarray(aniso_corpus)[160:190].copy()
    extra[7] = 3.0 * extra[7]  # outside the fitted int8 envelope
    return corpus, extra


@pytest.fixture(scope="module")
def churned_graph(aniso_corpus):
    """The reference's churn fixture in both packages: a quantized
    MutableGraph after 30 upserts (one forcing a requantize), under the
    reference's DADE estimator (port: against its own rebuild) and under
    its signed-permutation twin (port against the reference's object)."""
    corpus, extra = _churn_rows(aniso_corpus)
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0),
                          delta_d=16)
    pest = carry_estimator(est)
    mg = MutableGraph(corpus, m=8, ef_construction=24, estimator=pest,
                      quant="int8", capacity=220, **CPU)
    jest = _permuted(est)
    jmg = j_mut.MutableGraph(corpus, m=8, ef_construction=24, estimator=jest,
                             quant="int8", capacity=220)
    pmg = MutableGraph(corpus, m=8, ef_construction=24, estimator=carry_estimator(jest),
                       quant="int8", capacity=220, **CPU)
    for row in extra:
        assert mg.upsert(row) >= 0
        assert pmg.upsert(row) == jmg.upsert(row) >= 0
    ref = build_graph(np.concatenate([corpus, extra]), estimator=pest, m=8,
                      ef_construction=24, quant="int8", **CPU)
    return dict(mg=mg, ref=ref, jmg=jmg, pmg=pmg, corpus=corpus, extra=extra, est=est)


def test_graph_upserts_bit_identical_to_rebuild(churned_graph):
    """Exact: the port's mutated arrays equal its rebuild of the final
    corpus, and (permuted basis) the reference's mutated arrays."""
    g = churned_graph
    mg, ref, jmg, pmg = g["mg"], g["ref"], g["jmg"], g["pmg"]
    assert mg.ledger.requantizes >= 1  # the clip row clipped
    mg.ledger.check()
    idx = mg.index
    assert idx.entry == ref.entry
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(idx, f), getattr(ref, f)), f
    assert _ledger_eq(pmg.ledger, jmg.ledger)
    ji, pi = jmg.index, pmg.index
    assert pi.entry == int(ji.entry)
    assert (pi.adj_block, pi.scan_block_d) == (ji.adj_block, ji.scan_block_d)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(pi, f)), np.asarray(getattr(ji, f)),
                                      err_msg=f)


def test_graph_deletes_search_identical_to_rebuild(churned_graph, queries):
    """Deletes: the port's ids equal the reference's rebuild walk under the
    same tombstones (``search_graph_fused(tombstones=t, exclude=t,
    use_ref=True)``), exactly; distances to fp32 rounding; no deleted row
    served.  Also the port's PCA-rotated graph against the port's own
    rebuild, exactly."""
    g = churned_graph
    doomed = [0, 1, 2, 37, 161, 185]
    kw = dict(k=5, ef=16, expand=2, block_q=8)
    q = np.asarray(queries)[:8, : g["corpus"].shape[1]]
    for mg in (g["mg"], g["pmg"]):
        for gid in doomed:
            assert mg.delete(gid)
        assert not mg.delete(37)  # double delete refused
        assert not mg.delete(10**6)  # unknown id refused
        assert mg.ledger.rejected == 2
        mg.ledger.check()
        assert mg.live_count == mg.count - len(doomed)
        assert mg.tombstones == ids_to_ranges(doomed)
    for gid in doomed + [37, 10**6]:
        g["jmg"].delete(gid)
    t = g["mg"].tombstones
    d_mut, i_mut, _ = g["mg"].search(q, **kw)
    d_reb, i_reb, _ = search_graph_fused(g["ref"], q, tombstones=t, exclude=t, **kw, **CPU)
    assert torch.equal(i_mut, i_reb) and torch.equal(d_mut, d_reb)
    # The reference's walk oracle under the same tombstones, on the
    # reference's mutated graph (the permuted twin, whose arrays equal the
    # port's): the port's mutable walk returns its ids.
    d_p, i_p, _ = g["pmg"].search(q, **kw)
    d_j, i_j, _ = j_search(g["jmg"].index, jnp.asarray(q), tombstones=t, exclude=t,
                           use_ref=True, **kw)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    _close(d_p, d_j)
    assert not np.isin(i_p.numpy(), doomed).any()
    assert not np.isin(i_mut.numpy(), doomed).any()


def test_graph_snapshot_roundtrip(churned_graph):
    """``snapshot_arrays`` / ``from_snapshot``: the restored graph equals
    the original, and the port's snapshot arrays equal the reference's
    (permuted twins), so either package restores the other's."""
    mg, jmg, pmg = churned_graph["mg"], churned_graph["jmg"], churned_graph["pmg"]
    arrays, extra = mg.snapshot_arrays()
    mg2 = MutableGraph.from_snapshot(arrays, extra, mg.estimator, quant="int8", **CPU)
    assert (mg2.count, mg2.live_count) == (mg.count, mg.live_count)
    assert mg2.ledger == mg.ledger
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(mg2.index, f), getattr(mg.index, f)), f
    assert mg2.index.entry == mg.index.entry
    pa, pe = pmg.snapshot_arrays()
    ja, je = jmg.snapshot_arrays()
    assert pe == je
    for name in ja:
        np.testing.assert_array_equal(pa[name], np.asarray(ja[name]), err_msg=name)
    jmg2 = j_mut.MutableGraph.from_snapshot(pa, pe, jmg.estimator, quant="int8")
    np.testing.assert_array_equal(np.asarray(jmg2.index.neighbors), pmg.index.neighbors.numpy())


def test_graph_capacity_refusal(aniso_corpus):
    corpus = np.asarray(aniso_corpus)[:40]
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0), delta_d=16)
    mg = MutableGraph(corpus, m=4, ef_construction=8, estimator=carry_estimator(est),
                      capacity=41, **CPU)
    jmg = j_mut.MutableGraph(corpus, m=4, ef_construction=8, estimator=est, capacity=41)
    assert mg.upsert(corpus[0]) == jmg.upsert(corpus[0]) == 40
    assert mg.upsert(corpus[1]) == jmg.upsert(corpus[1]) == -1  # full: refused
    assert _ledger_eq(mg.ledger, jmg.ledger) and mg.ledger.rejected == 1
    mg.ledger.check()
    assert not mg.index.has_quant  # an unquantized build: no int8 arrays


# ---- flat / IVF: search-level rebuild equivalence --------------------------


def test_flat_mutations_match_fresh_build(aniso_corpus, queries):
    """Port: mutated == its fresh build of the live corpus, exactly; port
    against the reference's ``MutableFlat``: ids equal, distances to fp32
    rounding."""
    corpus = np.asarray(aniso_corpus)[:200]
    extra = np.asarray(aniso_corpus)[200:230]
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0), delta_d=16)
    pest = carry_estimator(est)
    mf = MutableFlat(corpus, estimator=pest, capacity=260, **CPU)
    jmf = j_mut.MutableFlat(corpus, estimator=est, capacity=260)
    for row in extra:
        assert mf.upsert(row) == jmf.upsert(row) >= 0
    for gid in (0, 5, 201, 17):
        assert mf.delete(gid) and jmf.delete(gid)
    mf.ledger.check()
    assert _ledger_eq(mf.ledger, jmf.ledger)
    _, live = mf.view()
    np.testing.assert_array_equal(live, jmf.view()[1])
    final = np.concatenate([corpus, extra])[live]
    fresh = build_flat(final, estimator=pest, **CPU)
    q = np.asarray(queries)[:8, : corpus.shape[1]]
    res_m, res_f = mf.search(q, k=5), search_flat(fresh, q, k=5)
    np.testing.assert_array_equal(res_m.ids.numpy(), live[res_f.ids.numpy()])
    assert torch.equal(res_m.dists, res_f.dists)
    res_j = jmf.search(jnp.asarray(q), k=5)
    np.testing.assert_array_equal(res_m.ids.numpy(), np.asarray(res_j.ids))
    _close(res_m.dists, res_j.dists)
    assert not np.isin(res_m.ids.numpy(), [0, 5, 201, 17]).any()


def test_flat_requantize_on_clip(aniso_corpus):
    corpus = np.asarray(aniso_corpus)[:120]
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0), delta_d=16)
    mf = MutableFlat(corpus, estimator=carry_estimator(est), quant="int8", capacity=150,
                     **CPU)
    jmf = j_mut.MutableFlat(corpus, estimator=est, quant="int8", capacity=150)
    assert mf.upsert(corpus[3]) == jmf.upsert(corpus[3]) >= 0  # inside: no refit
    assert mf.ledger.requantizes == jmf.ledger.requantizes == 0
    assert mf.upsert(4.0 * corpus[3]) == jmf.upsert(4.0 * corpus[3]) >= 0  # clips
    assert mf.ledger.requantizes == jmf.ledger.requantizes == 1
    from repro_torch.quant.scalar import fit_scales, quantize
    rot = torch.as_tensor(mf._rot[: mf.count])
    np.testing.assert_array_equal(mf._qscales, fit_scales(rot).numpy())
    np.testing.assert_array_equal(mf._codes[: mf.count],
                                  quantize(rot, torch.as_tensor(mf._qscales)).numpy())


def _carry_padded_ivf(idx):
    """The reference's padded-gather IVF arrays as the port's index."""
    t = (lambda a: None if a is None else torch.as_tensor(np.array(a)))
    return IVFIndex(estimator=carry_estimator(idx.estimator), centroids=t(idx.centroids),
                    bucket_sizes=t(idx.bucket_sizes), buckets=t(idx.buckets),
                    bucket_ids=t(idx.bucket_ids), qbuckets=t(idx.qbuckets),
                    qscales=t(idx.qscales), max_bucket=idx.max_bucket)


def test_ivf_mutated_matches_compact_rebuild(aniso_corpus, queries):
    """The port's ``MutableIVF`` grown from the reference's base: its view
    and its compact rebuild return the same ids (distances to 1e-6, the
    reference's tolerance), and both equal the reference's own view's and
    compact's ids (distances to fp32 rounding)."""
    corpus = np.asarray(aniso_corpus)[:256]
    extra = np.asarray(aniso_corpus)[256:296]
    jmi = j_mut.MutableIVF(jnp.asarray(corpus), n_clusters=8, growth=128, delta_d=16,
                           key=jax.random.PRNGKey(0))
    from repro.index.ivf import build_ivf as j_build_ivf
    base = j_build_ivf(jnp.asarray(corpus), n_clusters=8, delta_d=16,
                       key=jax.random.PRNGKey(0))
    mi = MutableIVF.from_index(_carry_padded_ivf(base), corpus, growth=128)
    for row in extra:
        assert mi.upsert(row) == jmi.upsert(row) >= 0
    for gid in (3, 60, 257, 280):
        assert mi.delete(gid) and jmi.delete(gid)
    assert not mi.delete(3)  # double delete refused
    jmi.delete(3)
    mi.ledger.check()
    assert _ledger_eq(mi.ledger, jmi.ledger)
    assert mi.live_count == 256 + 40 - 4
    q = np.asarray(queries)[:8, : corpus.shape[1]]
    d_m, i_m, _ = search_ivf(mi.view(), q, k=5, n_probe=8, **CPU)
    d_c, i_c, _ = search_ivf(mi.compact(), q, k=5, n_probe=8, **CPU)
    assert torch.equal(i_m, i_c)
    np.testing.assert_allclose(d_m.numpy(), d_c.numpy(), rtol=1e-6, atol=1e-6)
    d_j, i_j, _ = j_search_ivf(jmi.view(), jnp.asarray(q), k=5, n_probe=8)
    np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_j))
    _close(d_m, d_j)
    assert not np.isin(i_m.numpy(), [3, 60, 257, 280]).any()


def test_ivf_hole_reuse_and_reject_on_full(aniso_corpus):
    corpus = np.asarray(aniso_corpus)[:100]
    from repro.index.ivf import build_ivf as j_build_ivf
    base = j_build_ivf(jnp.asarray(corpus), n_clusters=1, delta_d=16,
                       key=jax.random.PRNGKey(0))
    mi = MutableIVF.from_index(_carry_padded_ivf(base), corpus, growth=128)
    jmi = j_mut.MutableIVF(jnp.asarray(corpus), n_clusters=1, growth=128, delta_d=16,
                           key=jax.random.PRNGKey(0))
    # A delete punches a hole the next upsert reuses (the high-water mark
    # does not move).
    assert mi.delete(10) and jmi.delete(10)
    fill_before = int(mi._fill[0])
    gid = mi.upsert(corpus[10])
    assert gid == jmi.upsert(corpus[10]) == 100 and int(mi._fill[0]) == fill_before
    # Filling the one cluster's slab: the overflowing upsert is refused.
    while mi.upsert(corpus[gid % 100]) >= 0:
        assert jmi.upsert(corpus[gid % 100]) == gid + 1
        gid += 1
    assert jmi.upsert(corpus[gid % 100]) == -1
    assert mi.ledger.rejected == 1
    assert mi.upsert(corpus[0]) == -1
    assert mi.ledger.rejected == 2
    mi.ledger.check()
    np.testing.assert_array_equal(mi._bucket_ids, np.asarray(jmi._bucket_ids))


def test_ivf_own_build_serves_padded_and_mutates(aniso_corpus, queries):
    """The port's own ``MutableIVF`` (its build): an upsert lands in the
    bucket of its nearest centroid, and the view serves it."""
    corpus = np.asarray(aniso_corpus)[:300]
    mi = MutableIVF(corpus, n_clusters=4, delta_d=16, quant="int8", **CPU)
    gid = mi.upsert(corpus[7] + 1e-3)
    d, i, _ = mi.search(corpus[7:8] + 1e-3, k=2, n_probe=4)
    assert gid == 300 and int(i[0, 0]) == 300 and float(d[0, 0]) < 1e-3
    mi.ledger.check()


# ---- WAL: crash-safe mutation log ------------------------------------------


def _small_graph_base(aniso_corpus):
    corpus = np.asarray(aniso_corpus)[:60]
    est = carry_estimator(build_estimator("dade", jnp.asarray(corpus),
                                          jax.random.PRNGKey(0), delta_d=16))
    return corpus, lambda: MutableGraph(corpus, m=6, ef_construction=16,
                                        estimator=est, capacity=90, **CPU)


def _logged_churn(mg, log, corpus, n_up=6, deletes=(2, 11)):
    """A churn sequence written ahead: each record reaches the log before
    its mutation applies (the serve loop's order)."""
    for i in range(n_up):
        vec = corpus[i] + 0.01 * (i + 1)
        gid = mg.count
        log.append_upsert(gid, vec)
        assert mg.upsert(vec) == gid
    for gid in deletes:
        log.append_delete(gid)
        assert mg.delete(gid)


def _assert_same_graph(a, b):
    assert (a.count, a.live_count) == (b.count, b.live_count)
    assert a.tombstones == b.tombstones
    assert torch.equal(a.index.neighbors, b.index.neighbors)
    assert torch.equal(a.index.corpus_rot, b.index.corpus_rot)
    assert a.index.entry == b.index.entry


def test_wal_roundtrip_replays_bit_identical(aniso_corpus, tmp_path):
    corpus, base = _small_graph_base(aniso_corpus)
    live, log = base(), MutationLog(str(tmp_path / "m.wal"))
    _logged_churn(live, log, corpus)
    log.append_set_table(live.estimator.table)  # recalibration swaps log too
    log.close()
    log2 = MutationLog(str(tmp_path / "m.wal"))
    assert not log2.recovered_torn
    records = log2.replay()
    assert [r["op"] for r in records] == ["upsert"] * 6 + ["delete"] * 2 + ["set_table"]
    # The reference reads the port's log to the same records.
    jrecords = JLog(str(tmp_path / "m.wal")).replay()
    assert [r["seq"] for r in jrecords] == [r["seq"] for r in records]
    for a, b in zip(records, jrecords):
        if "vec" in a:
            np.testing.assert_array_equal(a["vec"], b["vec"])
    recovered = base()
    assert replay_into(recovered, records) == {"upsert": 6, "delete": 2, "set_table": 1}
    _assert_same_graph(recovered, live)
    assert torch.equal(recovered.estimator.table.eps, live.estimator.table.eps)
    assert log2.append_delete(0) == 10  # the cursor continues past the history
    log2.close()


def test_wal_torn_tail_truncated_on_open(aniso_corpus, tmp_path):
    corpus, base = _small_graph_base(aniso_corpus)
    live, log = base(), MutationLog(str(tmp_path / "m.wal"))
    _logged_churn(live, log, corpus, n_up=4, deletes=())
    log.close()
    size = os.path.getsize(tmp_path / "m.wal")
    with open(tmp_path / "m.wal", "ab") as f:  # a torn fifth record
        f.write(struct.pack(">I", 100) + b"partial")
    log2 = MutationLog(str(tmp_path / "m.wal"))
    assert log2.recovered_torn
    assert os.path.getsize(tmp_path / "m.wal") == size  # the tail truncated
    assert len(log2.replay()) == 4
    log2.close()


def test_wal_digest_mismatch_is_corruption_not_crash(aniso_corpus, tmp_path):
    corpus, base = _small_graph_base(aniso_corpus)
    live, log = base(), MutationLog(str(tmp_path / "m.wal"))
    _logged_churn(live, log, corpus, n_up=3, deletes=())
    log.close()
    with open(tmp_path / "m.wal", "r+b") as f:  # a byte INSIDE record 1
        f.seek(8)
        b = f.read(1)
        f.seek(8)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="digest mismatch"):
        MutationLog(str(tmp_path / "m.wal"))
    with pytest.raises(IOError, match="digest mismatch"):
        JLog(str(tmp_path / "m.wal"))


def test_wal_torn_upsert_chaos_crash_recovery(aniso_corpus, tmp_path):
    corpus, base = _small_graph_base(aniso_corpus)
    live, log = base(), MutationLog(str(tmp_path / "m.wal"))
    _logged_churn(live, log, corpus, n_up=5, deletes=(2,))
    with use_chaos(parse_chaos("torn_upsert")):
        with pytest.raises(ChaosError, match="torn upsert"):
            log.append_upsert(live.count, corpus[0])
    log.close()
    # The reference's opener recovers the port's torn log the same way.
    jlog = JLog(str(tmp_path / "m.wal"))
    assert jlog.recovered_torn and len(jlog.replay()) == 6
    jlog.close()
    log2 = MutationLog(str(tmp_path / "m.wal"))
    assert not log2.recovered_torn  # already truncated by the first opener
    records = log2.replay()
    assert len(records) == 6
    recovered = base()
    replay_into(recovered, records)
    _assert_same_graph(recovered, live)
    assert log2.append_upsert(recovered.count, corpus[1]) == 7
    log2.close()


def test_wal_replay_divergence_detected(aniso_corpus, tmp_path):
    corpus, base = _small_graph_base(aniso_corpus)
    live, log = base(), MutationLog(str(tmp_path / "m.wal"))
    _logged_churn(live, log, corpus, n_up=2, deletes=())
    log.close()
    records = MutationLog(str(tmp_path / "m.wal")).replay()
    wrong_base = MutableGraph(corpus[:59], m=6, ef_construction=16,
                              estimator=live.estimator, capacity=90, **CPU)
    with pytest.raises(ValueError, match="wal replay diverged"):
        replay_into(wrong_base, records)


# ---- drift watchdog --------------------------------------------------------


def _jpairs(key, n, num_pairs):
    """The pair indices ``calibration.violation_rates`` / ``calibrate``
    draw from ``key`` (before their i == j fix, which both packages
    apply)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (num_pairs,), 0, n)),
            np.asarray(jax.random.randint(k2, (num_pairs,), 0, n)))


def _ref_pairs(wd, checks):
    """(check pairs, recalibration pairs) of the reference watchdog's
    ``checks``-th check."""
    key0 = jax.random.PRNGKey(3)
    n = wd._buf.shape[0]
    check = _jpairs(jax.random.fold_in(key0, checks), n, wd.num_pairs)
    recal = _jpairs(jax.random.fold_in(jax.random.fold_in(key0, 0x7EC4), checks), n,
                    max(wd.num_pairs, 2048))
    return check, recal


@pytest.fixture(scope="module")
def drift_setup(aniso_corpus):
    sub = np.asarray(aniso_corpus)[:400]
    est = build_estimator("dade", jnp.asarray(sub), jax.random.PRNGKey(0),
                          delta_d=16, p_s=0.05)
    drift = np.asarray(drifted_vectors(est.transform, 400, extra_decay=0.15, seed=11))
    return sub, est, drift


def _observed(sub, drift):
    """The reference's and the port's watchdog after the same drifted
    stream: their reservoirs are equal (the same numpy stream)."""
    kw = dict(reservoir=256, p_s=0.05, num_pairs=1024, seed=3)
    wd, jwd = DriftWatchdog(sub, **kw), j_mut.DriftWatchdog(sub, **kw)
    for row in drift:
        wd.observe(row)
        jwd.observe(row)
    np.testing.assert_array_equal(wd._buf, jwd._buf)
    return wd, jwd


def _same_report(rep, jrep):
    for key in ("fired", "swapped", "suppressed", "parity_ok"):
        assert rep.get(key) == jrep.get(key), key
    # One pair's verdict at the threshold may differ by fp32 rounding.
    assert abs(rep["stat"] - jrep["stat"]) <= 2.0 / 1024
    assert rep["threshold"] == pytest.approx(jrep["threshold"])


def test_watchdog_quiet_on_fresh_table(drift_setup):
    sub, est, _ = drift_setup
    kw = dict(reservoir=256, p_s=0.05, num_pairs=1024, seed=3)
    wd, jwd = DriftWatchdog(sub, **kw), j_mut.DriftWatchdog(sub, **kw)
    np.testing.assert_array_equal(wd._buf, jwd._buf)
    jrep = jwd.check(est)
    rep = wd.check(carry_estimator(est), pairs=_ref_pairs(wd, 1)[0])
    _same_report(rep, jrep)
    assert not rep["fired"] and rep["stat"] <= rep["threshold"]
    # The port's own pair stream draws the same verdict.
    assert not wd.check(carry_estimator(est))["fired"]


def test_watchdog_fires_and_recalibrates_with_parity(drift_setup):
    sub, est, drift = drift_setup
    pest = carry_estimator(est)
    holder, jholder = MutableFlat(sub, estimator=pest, **CPU), j_mut.MutableFlat(
        sub, estimator=est)
    wd, jwd = _observed(sub, drift)
    check, recal = _ref_pairs(wd, 1)
    jrep = jwd.maybe_recalibrate(jholder)
    rep = wd.maybe_recalibrate(holder, pairs=check, recal_pairs=recal)
    _same_report(rep, jrep)
    assert rep["fired"] and rep["parity_ok"] and rep["swapped"]
    assert holder.estimator is not pest  # the table swapped in
    assert holder.estimator.transform is pest.transform  # the rotation frozen
    _close(holder.estimator.table.eps, jholder.estimator.table.eps)
    assert wd.check(holder.estimator, pairs=_ref_pairs(wd, 2)[0])["stat"] <= rep["threshold"]
    assert (wd.fired, wd.recalibrations, wd.suppressed) == (1, 1, 0)
    assert wd.as_metrics()["calib.drift.recalibrations"] == 1.0
    # The port's own streams reach the same verdict.
    wd2, _ = _observed(sub, drift)
    holder2 = MutableFlat(sub, estimator=pest, **CPU)
    assert wd2.maybe_recalibrate(holder2)["swapped"]


def test_watchdog_stale_transform_chaos_suppresses_swap(drift_setup):
    sub, est, drift = drift_setup
    pest = carry_estimator(est)
    holder = MutableFlat(sub, estimator=pest, **CPU)
    jholder = j_mut.MutableFlat(sub, estimator=est)
    wd, jwd = _observed(sub, drift)
    chaos, jchaos = parse_chaos("stale_transform"), j_parse_chaos("stale_transform")
    with use_chaos(chaos), j_use_chaos(jchaos):
        chaos.on_engine_step()  # arm (state faults hold once steps > after)
        jchaos.on_engine_step()
        jrep = jwd.maybe_recalibrate(jholder)
        rep = wd.maybe_recalibrate(holder, pairs=_ref_pairs(wd, 1)[0])
    _same_report(rep, jrep)
    assert rep["fired"] and rep["suppressed"] and not rep["swapped"]
    assert holder.estimator is pest  # still serving the stale table
    assert wd.suppressed == 1 and wd.recalibrations == 0


def test_set_estimator_rejects_changed_transform(aniso_corpus):
    sub = np.asarray(aniso_corpus)[:80]
    est = carry_estimator(build_estimator("dade", jnp.asarray(sub), jax.random.PRNGKey(0),
                                          delta_d=16))
    other = carry_estimator(build_estimator("dade", jnp.asarray(sub[40:]),
                                            jax.random.PRNGKey(1), delta_d=16))
    holder = MutableFlat(sub, estimator=est, **CPU)
    with pytest.raises(ValueError, match="transform"):
        holder.set_estimator(other)
    holder.set_estimator(dataclasses.replace(est, table=other.table))  # a table swap
    assert holder.estimator.table is other.table


# ---- checkpoint retention / torn step dirs ---------------------------------


def test_manager_gc_prunes_save_named_and_skips_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (1, 2, 3):
        mgr.save_named(step, {"a": np.arange(4) + step}, extra={"step_tag": step})
    assert mgr.all_steps() == [2, 3]  # keep=2 pruned step 1
    assert not os.path.exists(tmp_path / "step_000000001")
    os.makedirs(tmp_path / "step_000000004")  # torn: no committed tree.json
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    assert JManager(str(tmp_path), keep=2, async_save=False).all_steps() == [2, 3]
    mgr.save_named(5, {"a": torch.arange(4)})
    assert not os.path.exists(tmp_path / "step_000000004")  # swept
    assert mgr.all_steps() == [3, 5]
    arrays, extra = mgr.restore_named(3)
    np.testing.assert_array_equal(arrays["a"], np.arange(4) + 3)
    assert extra["step_tag"] == 3
    jarrays, jextra = JManager(str(tmp_path), keep=2, async_save=False).restore_named(5)
    np.testing.assert_array_equal(jarrays["a"], np.arange(4))


# ---- metrics schema checker (mutation invariants) --------------------------


def _schema_check(tmp_path, metrics, report=None):
    doc = {
        "schema_version": 1,
        "provenance": {"git_sha": "t", "jax_version": "unavailable",
                       "device_kind": "cpu", "date": "d"},
        "config": {},
        "report": report or {"queries": 8.0},
        "metrics": metrics,
    }
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(doc))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "check_metrics_schema.py"),
         str(path)], capture_output=True, text=True)


def _mutate_metrics(ledger, tombstones=2.0):
    """The port's ``record_mutations`` output for ``ledger``."""
    from repro_torch.obs import MetricsRegistry, record_mutations
    reg = MetricsRegistry()
    reg.counter("serve.queries").add(8.0)
    reg.counter("serve.requests").add(1.0)
    record_mutations(reg, ledger, tombstones=tombstones)
    return reg.snapshot()


def _ledger(applied=5, upserts=3, deletes=2, rejected=0):
    from repro_torch.index.mutable import MutationLedger
    return MutationLedger(applied=applied, upserts=upserts, deletes=deletes,
                          rejected=rejected, requantizes=1)


def test_schema_check_accepts_closed_mutation_ledger(tmp_path):
    metrics = _mutate_metrics(_ledger())
    from repro.index.mutable import MutationLedger as JLedger
    from repro.obs import MetricsRegistry as JRegistry
    from repro.obs import record_mutations as j_record
    jreg = JRegistry()
    jreg.counter("serve.queries").add(8.0)
    jreg.counter("serve.requests").add(1.0)
    j_record(jreg, JLedger(5, 3, 2, 0, 1), tombstones=2.0)
    assert metrics == jreg.snapshot()
    r = _schema_check(tmp_path, metrics)
    assert r.returncode == 0, r.stdout + r.stderr


def test_schema_check_rejects_open_ledger_and_orphans(tmp_path):
    r = _schema_check(tmp_path, _mutate_metrics(_ledger(applied=4)))
    assert r.returncode == 1
    assert "mutate.applied=4.0" in r.stdout
    orphan = _mutate_metrics(_ledger())
    del orphan["mutate.applied"]
    r = _schema_check(tmp_path, orphan)
    assert r.returncode == 1
    assert "without mutate.applied" in r.stdout


def test_schema_check_rejects_engine_serving_deleted_rows(tmp_path):
    m = _mutate_metrics(_ledger())
    m["graph.sharded.degraded.tombstoned_nodes"] = {"type": "gauge", "value": 1.0}
    r = _schema_check(tmp_path, m)
    assert r.returncode == 1
    assert "engine serving deleted rows" in r.stdout


# ---- estimator-spec interactions -------------------------------------------


def test_watchdog_recalibrates_adsampling_with_parity(aniso_corpus):
    """Drift fires the watchdog on an ADSampling table too; the swapped-in
    table stays expressible in the fused kernels (terminal exact retire)."""
    sub = np.asarray(aniso_corpus)[:400]
    est = build_estimator("adsampling", jnp.asarray(sub), jax.random.PRNGKey(0),
                          delta_d=16)
    pest = carry_estimator(est)
    drift = np.asarray(drifted_vectors(est.transform, 400, extra_decay=0.15, seed=11))
    holder, jholder = MutableFlat(sub, estimator=pest, **CPU), j_mut.MutableFlat(
        sub, estimator=est)
    wd, jwd = _observed(sub, drift)
    check, recal = _ref_pairs(wd, 1)
    jrep = jwd.maybe_recalibrate(jholder)
    rep = wd.maybe_recalibrate(holder, pairs=check, recal_pairs=recal)
    _same_report(rep, jrep)
    assert rep["fired"] and rep["parity_ok"] and rep["swapped"]
    new_est = holder.estimator
    assert new_est is not pest and new_est.transform is pest.transform
    spec = kernel_spec(new_est, sub.shape[1], 16)
    assert float(spec.eps[-1]) == 0.0 and float(spec.scale[-1]) == 1.0
    assert wd.check(new_est, pairs=_ref_pairs(wd, 2)[0])["stat"] <= rep["threshold"]


def test_watchdog_inert_on_fdscanning(aniso_corpus):
    sub = np.asarray(aniso_corpus)[:400]
    est = build_estimator("fdscanning", jnp.asarray(sub), jax.random.PRNGKey(0))
    pest = carry_estimator(est)
    drift = np.asarray(drifted_vectors(est.transform, 400, extra_decay=0.15, seed=11))
    holder = MutableFlat(sub, estimator=pest, **CPU)
    wd, jwd = _observed(sub, drift)
    jrep = jwd.maybe_recalibrate(j_mut.MutableFlat(sub, estimator=est))
    rep = wd.maybe_recalibrate(holder)
    assert not rep["fired"] and not rep["swapped"] and not jrep["fired"]
    assert holder.estimator is pest
    assert (wd.fired, wd.recalibrations) == (0, 0)


@pytest.mark.parametrize("method", ["adsampling", "fdscanning"])
def test_mutable_graph_deletes_and_seeding_conform(aniso_corpus, queries, method):
    """Tombstones x threshold seeding x estimator: the seeded walk over a
    churned graph equals the unseeded walk, the port's rebuild under the
    same tombstones, and the reference's rebuild oracle (ids exact,
    distances to fp32 rounding); no deleted row is served."""
    corpus = np.asarray(aniso_corpus)[:160]
    est = build_estimator(method, jnp.asarray(corpus), jax.random.PRNGKey(0),
                          delta_d=16, num_pairs=1024)
    pest = carry_estimator(est)
    mg = MutableGraph(corpus, m=8, ef_construction=24, estimator=pest, quant="int8",
                      capacity=200, **CPU)
    doomed = [1, 5, 40]
    for gid in doomed:
        assert mg.delete(gid)
    q = np.asarray(queries)[:8]
    kw = dict(k=5, ef=16, expand=2, block_q=8)
    d_seed, i_seed, _ = mg.search(q, seed_r=True, **kw)
    _, i_cold, _ = mg.search(q, seed_r=False, **kw)
    assert torch.equal(i_seed, i_cold)
    t = mg.tombstones
    ref = build_graph(corpus, estimator=pest, m=8, ef_construction=24, quant="int8", **CPU)
    d_reb, i_reb, _ = search_graph_fused(ref, q, tombstones=t, exclude=t, seed_r=True,
                                         **kw, **CPU)
    assert torch.equal(i_seed, i_reb) and torch.equal(d_seed, d_reb)
    jmg = j_mut.MutableGraph(corpus, m=8, ef_construction=24, estimator=est,
                             quant="int8", capacity=200)
    for gid in doomed:
        jmg.delete(gid)
    d_j, i_j, _ = j_search(jmg.index, jnp.asarray(q), tombstones=t, exclude=t,
                           seed_r=True, use_ref=True, **kw)
    np.testing.assert_array_equal(i_seed.numpy(), np.asarray(i_j))
    _close(d_seed, d_j)
    assert not np.isin(i_seed.numpy(), doomed).any()
