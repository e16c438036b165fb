"""Port parity for the corpus-sharded graph walk (host-simulated): the
port's ``search_graph_sharded`` (CPU tensors, i.e. the one-wave kernel's
plain version per shard) against ``repro.index.graph.search_graph_sharded
(use_ref=True)`` on the same carried index, healthy and degraded, the
window merge against the reference's, the sharded continuous engine against
its solo oracle, and the walk's spans and metrics against its ledger.

Ids and every ``GraphShardedStats`` field (the per-shard fetch tuples and
the exchange bytes included) must be equal; distances agree to fp32
rounding (the port's stage 2 sums in dimension order, the reference's in
its matmul's: relative 5e-5, the reference's own engine-parity tolerance).
Across shard counts the port must agree with itself bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.index.graph as j_graph  # noqa: E402
from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402
from _torch_carry import carry_graph  # noqa: E402
from repro_torch.index.graph import (  # noqa: E402
    GraphShardedStats, dead_shard_tombstones, merge_shard_windows,
    search_graph_sharded, shard_graph_nodes)
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402
from repro_torch.launch.annservice import ContinuousGraphEngine  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry, Tracer, record_graph_sharded, span_totals, use_tracer)
from repro_torch.quant.accounting import frontier_exchange_bytes  # noqa: E402
from repro_torch.runtime.chaos import current_chaos, parse_chaos, use_chaos  # noqa: E402
from repro.quant.accounting import frontier_exchange_bytes as j_exchange  # noqa: E402

KW = dict(k=10, ef=32)


@pytest.fixture(scope="module")
def port_graph(graph_idx):
    return carry_graph(graph_idx[1])


def _same(port, ref):
    (d, i, st), (dj, ij, stj) = port, ref
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=5e-5, atol=1e-5)
    assert isinstance(st, GraphShardedStats)
    assert st._asdict() == stj._asdict()


@pytest.mark.parametrize("shards,extra", [
    (1, {}), (4, {}), (2, dict(degraded=True, seed_r=True)),
], ids=["s1", "s4", "s2_degraded_seeded_exclude"])
def test_sharded_walk_matches_reference(graph_idx, port_graph, queries, shards, extra):
    """The port's sharded walk returns the reference's ids and its whole
    ledger at S = 1, 2, 4; the S = 2 case is degraded: it tombstones shard 1
    of 2 (the builder's medoid lies in it, so the entry falls back), seeds
    the threshold from the surviving neighbours and drops an excluded
    range."""
    sub, g = graph_idx
    q = np.asarray(queries)[:8]
    kw = dict(KW, seed_r=extra.get("seed_r", False))
    if extra.get("degraded"):
        kw.update(tombstones=dead_shard_tombstones(sub.shape[0], 2, [1]),
                  exclude=((40, 8),))
    ref = j_graph.search_graph_sharded(g, jnp.asarray(q), num_shards=shards,
                                       use_ref=True, **kw)
    before = graph_scan_kernel_call.launches
    out = search_graph_sharded(port_graph, q, num_shards=shards, device="cpu", **kw)
    assert graph_scan_kernel_call.launches == before  # CPU tensors: no launch
    _same(out, ref)
    st = out[2]
    assert st.num_shards == shards and st.waves > 1
    assert (st.exchange_bytes_per_wave > 0) == (shards > 1)
    if extra.get("degraded"):
        assert st.dead_shards == (1,) and st.tombstoned_nodes == sub.shape[0] // 2
        assert st.shard_s1_tiles_fetched[1] == 0.0
        ids = out[1].numpy()
        assert not ((ids >= 40) & (ids < 48)).any()


@pytest.mark.parametrize("extra", [{}, dict(route_mult=1.2), dict(decoupled=False)],
                         ids=["defaults", "route_mult", "coupled"])
def test_shard_count_invariance(port_graph, queries, extra):
    """Every shard count returns the single-shard plain oracle's ids and
    distances bit for bit, walks as many waves, and splits the oracle's
    fetches between its shards without adding any."""
    q = np.asarray(queries)[:16]
    d1, i1, s1 = search_graph_sharded(port_graph, q, num_shards=1, use_ref=True,
                                      device="cpu", **KW, **extra)
    for shards in (3, 4):
        d, i, s = search_graph_sharded(port_graph, q, num_shards=shards, device="cpu",
                                       **KW, **extra)
        assert torch.equal(i, i1) and torch.equal(d, d1), shards
        assert s.waves == s1.waves and s.rows_per_query == s1.rows_per_query
        assert sum(s.shard_s1_tiles_fetched) == sum(s1.shard_s1_tiles_fetched)
        assert sum(s.shard_s2_slabs_fetched) == sum(s1.shard_s2_slabs_fetched)
        assert s.fetched_bytes_per_query == pytest.approx(s1.fetched_bytes_per_query)
    assert s1.exchange_bytes_per_wave == 0.0


def test_exchange_bytes_formula_matches_reference():
    for kw in (dict(num_shards=1, queries=8, ef=32, vis_words=128, q_tiles=1, steps=4),
               dict(num_shards=4, queries=1024, ef=48, vis_words=128 * 1024,
                    q_tiles=128, steps=16)):
        assert frontier_exchange_bytes(**kw) == j_exchange(**kw)


def _check_merge(g_sq, g_ids, ef):
    sq, ids = merge_shard_windows(torch.as_tensor(g_sq), torch.as_tensor(g_ids), ef=ef)
    sq_j, ids_j = j_graph.merge_shard_windows(jnp.asarray(g_sq), jnp.asarray(g_ids), ef=ef)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(sq_j))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))


def test_merge_shard_windows_ties_and_duplicates():
    """Equal distances go to the lower shard, the first of a duplicated id
    wins, dropped entries are inf / -1, as the reference merges them."""
    inf = np.inf
    g_sq = np.array([[[1.0, 2.0, 2.0, inf]], [[2.0, 2.0, 3.0, inf]], [[0.5, 2.0, inf, inf]]],
                    np.float32)
    g_ids = np.array([[[5, 7, 9, -1]], [[7, 4, 9, -1]], [[3, 7, -1, -1]]], np.int32)
    _check_merge(g_sq, g_ids, 4)
    sq, ids = merge_shard_windows(torch.as_tensor(g_sq), torch.as_tensor(g_ids), ef=4)
    assert ids.tolist() == [[3, 5, 7, 9]] and sq.tolist() == [[0.5, 1.0, 2.0, 2.0]]
    with pytest.raises(ValueError, match="ef=4 columns, merge asked for ef=3"):
        merge_shard_windows(torch.as_tensor(g_sq), torch.as_tensor(g_ids), ef=3)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(-1, 9)), min_size=36, max_size=36))
def test_merge_shard_windows_matches_reference_property(cells):
    """Windows of 3 shards x 2 queries x 6 columns drawn from few distances
    (ties) and few ids (duplicates), -1 ids carrying inf: the same merge."""
    vals = np.array([0.25, 1.0, 1.0 + 2 ** -20, 2.0, 7.5, np.inf], np.float32)
    sq = np.array([vals[v] for v, _ in cells], np.float32).reshape(3, 2, 6)
    ids = np.array([i for _, i in cells], np.int32).reshape(3, 2, 6)
    sq = np.where(ids < 0, np.inf, sq).astype(np.float32)
    # Each shard's window ascending, as a kernel returns it.
    order = np.argsort(sq, axis=2, kind="stable")
    _check_merge(np.take_along_axis(sq, order, 2), np.take_along_axis(ids, order, 2), 6)


def test_shard_config_guards_name_the_value(port_graph, queries):
    n = port_graph.corpus_rot.shape[0]
    with pytest.raises(ValueError, match=rf"n={n} % num_shards=7"):
        search_graph_sharded(port_graph, np.asarray(queries)[:2], num_shards=7, device="cpu")
    with pytest.raises(ValueError, match="num_shards=0"):
        shard_graph_nodes(n, 0)
    with pytest.raises(ValueError, match="dead shard 4 out of range for num_shards=4"):
        dead_shard_tombstones(n, 4, [4])


def test_sharded_spans_sum_to_ledger(port_graph, queries):
    """The per-wave spans and instants are the reference's, their bytes sum
    to the ledger shard by shard, and tracing changes no result."""
    q = np.asarray(queries)
    kw = dict(num_shards=2, k=5, ef=16, device="cpu", use_ref=True)
    d0, i0, st0 = search_graph_sharded(port_graph, q, **kw)
    tr = Tracer()
    with use_tracer(tr):
        d1, i1, st1 = search_graph_sharded(port_graph, q, **kw)
    assert torch.equal(i0, i1) and torch.equal(d0, d1) and st0 == st1
    qn = len(q)
    tot = span_totals(tr, arg_keys=("bytes",))
    per_shard = {0: 0.0, 1: 0.0}
    for e in tr.events:
        if e["name"] in ("graph.stage1_dma", "graph.stage2"):
            per_shard[e["args"]["shard"]] += e["args"]["bytes"]
    for s in range(2):
        assert per_shard[s] == pytest.approx(st1.shard_fetched_bytes_per_query[s] * qn)
    assert tot["graph.exchange"]["bytes"] == pytest.approx(st1.exchange_bytes_per_query * qn)
    assert tot["graph.wave"]["count"] == st1.waves + 1  # + the terminal probe
    for name in ("graph.launch", "graph.merge", "graph.route", "graph.host_commit"):
        assert tot[name]["count"] >= st1.waves, name
    reg = MetricsRegistry()
    record_graph_sharded(reg, st1, queries=qn)
    snap = reg.snapshot()
    shard_sum = sum(snap[f"graph.sharded.shard{s}.fetched_bytes"]["value"] for s in range(2))
    assert shard_sum == pytest.approx(snap["dco.fetched.bytes"]["value"])


def _run_schedule(engine, rows, schedule):
    pending, hmap, out, arrivals = list(range(len(rows))), {}, {}, list(schedule)
    while pending or engine.live_count():
        for _ in range(min(arrivals.pop(0) if arrivals else len(pending), len(pending))):
            i = pending.pop(0)
            hmap[engine.admit(rows[i])] = i
        if engine.live_count():
            for rq in engine.step():
                out[hmap[rq.handle]] = rq
    return out


def test_continuous_sharded_equals_solo_oracle(port_graph, queries):
    """The host-simulated sharded continuous walk returns, query by query,
    its solo ``search_graph_sharded(num_shards=2, use_ref=True)``: ids,
    distances and the whole ledger (the per-shard tuples and the exchange
    bytes of the solo walk's own frontier widths)."""
    q = np.asarray(queries)[:6]
    out = _run_schedule(ContinuousGraphEngine(port_graph, num_shards=2, **KW), q,
                        [2, 1, 1, 2])
    assert sorted(out) == list(range(6))
    for i, rq in out.items():
        d, ids, st_ = search_graph_sharded(port_graph, q[i][None], num_shards=2,
                                           use_ref=True, device="cpu", **KW)
        assert np.array_equal(rq.ids, ids.numpy()[0]), i
        assert np.array_equal(rq.dists, d.numpy()[0]), i
        assert isinstance(rq.stats, GraphShardedStats) and rq.stats == st_, i
        assert not rq.degraded


def test_continuous_midwalk_shard_death(port_graph, queries):
    """Queries admitted after a mid-walk shard death equal the
    surviving-corpus oracle; every walk that saw the death is flagged."""
    q = np.asarray(queries)
    with use_chaos(parse_chaos("shard_death:shard=1:after=2")):
        eng = ContinuousGraphEngine(port_graph, num_shards=2, **KW)
        hmap = {eng.admit(q[i]): i for i in range(3)}
        out, post, waves = {}, False, 0
        while eng.live_count() or not post:
            current_chaos().on_engine_step()
            if current_chaos().dead_shards(2) and not post:
                for j in range(3, 6):
                    hmap[eng.admit(q[j])] = j
                post = True
            for rq in eng.step():
                out[hmap[rq.handle]] = rq
            waves += 1
            assert waves < 200
        assert current_chaos().dead_shards(2) == frozenset({1})
    tombs = dead_shard_tombstones(port_graph.corpus_rot.shape[0], 2, [1])
    for j in range(3, 6):
        d, ids, st_ = search_graph_sharded(port_graph, q[j][None], num_shards=1,
                                           use_ref=True, device="cpu", tombstones=tombs, **KW)
        assert out[j].degraded
        assert np.array_equal(out[j].ids, ids.numpy()[0]), j
        assert np.array_equal(out[j].dists, d.numpy()[0]), j
        assert out[j].stats.dead_shards == (1,)
    assert all(out[i].degraded for i in range(3))
