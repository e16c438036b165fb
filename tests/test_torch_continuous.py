"""Interleaving invariance of the port's continuous engines (mirrors
``tests/test_continuous.py``): for any arrival schedule and retirement
order, every query served by ``ContinuousGraphEngine`` /
``ContinuousIVFEngine`` returns the ids, distances and ledger of the same
query served alone by the port's batch search (``search_graph_fused`` /
``search_ivf_fused`` on a one-row batch), ``==`` — and the ids and ledgers
of the reference's engines on the same schedules, ``==``, with the
documented near-tie rule between the two packages (ROADMAP queue 3 item
2): the port sums distances in dimension order and the reference in its
matmul's, so distances agree to fp32 rounding, and a candidate at d ≈ r²
can pass the screen in one and not the other.  Where that moves a
``passed`` count, the same difference stands between the two packages'
solo searches of that query: continuous batching adds none.
Then the continuous scheduler's closed ledgers under sheds and drills, the
SLO dials, and the frontier selection against the reference's.

Both sides run their plain versions: the reference with ``use_ref=True``,
the port on CPU tensors."""

import numpy as np
import pytest

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

torch = pytest.importorskip("torch")

import repro.launch.annservice as j_ann  # noqa: E402
import repro.runtime.chaos as j_chaos  # noqa: E402
import repro.runtime.scheduler as j_sched  # noqa: E402
import repro_torch.launch.annservice as t_ann  # noqa: E402
import repro_torch.runtime.chaos as t_chaos  # noqa: E402
import repro_torch.runtime.scheduler as t_sched  # noqa: E402
from _torch_carry import carry_graph, carry_ivf  # noqa: E402
from repro.data.pipeline import synthetic_queries  # noqa: E402
from repro.index.graph import _select_wave as j_select_wave  # noqa: E402
from repro.index.graph import search_graph_fused as j_search_graph  # noqa: E402
from repro.index.ivf import search_ivf_fused as j_search_ivf  # noqa: E402
from repro.kernels.ops import pad_live_rows as j_pad_live_rows  # noqa: E402
from repro.kernels.ops import pow2_bucket as j_pow2_bucket  # noqa: E402
from repro.kernels.ops import unpack_vis as j_unpack_vis  # noqa: E402
from repro_torch.index.graph import _select_wave, search_graph_fused  # noqa: E402
from repro_torch.index.ivf import search_ivf_fused  # noqa: E402
from repro_torch.kernels import graph_scan, ops  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

K, EF, BQ = 5, 16, 8
DIST_TOL = dict(rtol=5e-5, atol=1e-5)  # the port against the reference only


def assert_stats_equal(got, want, *, label=""):
    """Ledger equality field by field: the stats columns are integer-valued
    f32 counters, so chunked or interleaved accounting reproduces the solo
    search's exactly."""
    assert got._fields == want._fields, label
    for field, g, w in zip(got._fields, got, want):
        assert g == w, f"{label} stats.{field}: {g} != {w}"


def run_schedule(engine, rows, schedule):
    """Feed ``rows`` into ``engine`` per the arrival ``schedule`` (number of
    admissions before each wave; leftovers admitted at the end), step until
    drained, and return {row_index: RetiredQuery}."""
    pending = list(range(len(rows)))
    hmap, out = {}, {}
    arrivals = list(schedule)
    while pending or engine.live_count():
        n_admit = arrivals.pop(0) if arrivals else len(pending)
        for _ in range(min(n_admit, len(pending))):
            i = pending.pop(0)
            hmap[engine.admit(rows[i])] = i
        if engine.live_count() == 0:
            continue
        for rq in engine.step():
            out[hmap[rq.handle]] = rq
    assert len(out) == len(rows)
    return out


@pytest.fixture(scope="module")
def cont_queries(aniso_corpus):
    return np.asarray(synthetic_queries(10, 64, aniso_corpus, seed=7), np.float32)


@pytest.fixture(scope="module")
def pgraph(graph_idx):
    return carry_graph(graph_idx[1])


@pytest.fixture(scope="module")
def pivf(fused_idx):
    return carry_ivf(fused_idx)


@pytest.fixture(scope="module")
def graph_solo(pgraph, cont_queries):
    """Each query served alone by the port's batch search."""
    out = []
    for row in cont_queries:
        d, i, s = search_graph_fused(pgraph, row[None], k=K, ef=EF, block_q=BQ, device="cpu")
        out.append((d.numpy()[0], i.numpy()[0], s))
    return out


def assert_reference_ledger(got, want, solo_got, solo_want, *, label=""):
    """Port against reference: every ledger field equal but a passed count
    moved by near-ties, which must equal the one between the two packages'
    solo searches of the query."""
    for field, g, w in zip(got._fields, got, want):
        if field == "passed_per_query" and g != w:
            assert (g - w) == solo_got() - solo_want(), f"{label}: {g} != {w}"
        else:
            assert g == w, f"{label} stats.{field}: {g} != {w}"


def check_graph(pgraph, gidx, rows, solo, schedule, *, reference=True):
    out = run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, block_q=BQ),
                       rows, schedule)
    for i, rq in out.items():
        d, ids, s = solo[i]
        assert np.array_equal(rq.ids, ids), f"query {i} ids diverge from the solo search"
        assert np.array_equal(rq.dists, d), f"query {i} dists diverge from the solo search"
        assert rq.reason == "frontier" and not rq.degraded
        assert rq.waves == s.waves
        assert_stats_equal(rq.stats, s, label=f"query {i}")
    if reference:
        ref = run_schedule(j_ann.ContinuousGraphEngine(gidx, k=K, ef=EF, block_q=BQ,
                                                       use_ref=True), rows, schedule)
        for i, rq in out.items():
            assert np.array_equal(rq.ids, ref[i].ids), f"query {i} ids diverge from reference"
            np.testing.assert_allclose(rq.dists, ref[i].dists, **DIST_TOL)
            assert (rq.reason, rq.waves) == (ref[i].reason, ref[i].waves)
            assert_reference_ledger(
                rq.stats, ref[i].stats, lambda: solo[i][2].passed_per_query,
                lambda: j_search_graph(gidx, rows[i][None], k=K, ef=EF, block_q=BQ,
                                       use_ref=True)[2].passed_per_query,
                label=f"reference query {i}")
    return out


SCHEDULES = {
    "interleaved": [2, 1, 0, 3, 1, 2, 1],  # staggered: every query joins mid-walk
    "burst_trickle": [6, 0, 0, 1, 1, 1, 1],  # burst to the bucket, then backfills
    "seeded": np.random.default_rng(0).integers(0, 4, size=8).tolist(),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_graph_schedule_equals_solo_and_reference(graph_idx, pgraph, cont_queries,
                                                  graph_solo, name):
    """Interleaved, burst/trickle and seeded random arrivals: each query
    retires with its solo search's results and ledger, and with the
    reference engine's on the same schedule."""
    check_graph(pgraph, graph_idx[1], cont_queries, graph_solo, SCHEDULES[name])


@pytest.mark.parametrize("seed", [1, 2])
def test_graph_random_schedules_seeded(graph_idx, pgraph, cont_queries, graph_solo, seed):
    sched = np.random.default_rng(seed).integers(0, 4, size=8).tolist()
    check_graph(pgraph, graph_idx[1], cont_queries, graph_solo, sched, reference=False)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=4), min_size=1, max_size=10))
def test_graph_interleaving_invariance_property(graph_idx, pgraph, cont_queries,
                                                graph_solo, schedule):
    check_graph(pgraph, graph_idx[1], cont_queries[:6], graph_solo, schedule,
                reference=False)


def test_graph_retirement_order_independent(graph_idx, pgraph, cont_queries, graph_solo):
    """Retirement and the compaction it triggers do not perturb surviving
    walks: one query at a time, or the whole set at once."""
    check_graph(pgraph, graph_idx[1], cont_queries, graph_solo, [1] * 10, reference=False)
    check_graph(pgraph, graph_idx[1], cont_queries, graph_solo, [10], reference=False)


def test_backfill_is_freshly_seeded_within_pow2_buckets(pgraph, cont_queries, graph_solo,
                                                        monkeypatch):
    """A backfilled slot starts from its own wave-0 state, never a retired
    walk's window (its results equal its solo search, and a rerun of the
    same churny schedule repeats every result); every launch's tile count
    and step count lie on the pow2 bucket grid."""
    shapes = []
    real = graph_scan.graph_scan_kernel_call

    def recording(*args, **kw):
        shapes.append((args[1].shape[0] // kw["block_q"], args[0].shape[1]))
        return real(*args, **kw)

    monkeypatch.setattr(graph_scan, "graph_scan_kernel_call", recording)
    rows, schedule = cont_queries[:6], [2, 0, 1, 1, 0, 2]
    first = check_graph(pgraph, None, rows, graph_solo, schedule, reference=False)
    n_first = len(shapes)
    second = run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, block_q=BQ),
                          rows, schedule)
    assert shapes[n_first:] == shapes[:n_first]
    assert {tiles for tiles, _ in shapes} <= {1, 2, 4, 8}
    assert {steps for _, steps in shapes} <= {1, 2, 4}
    for i in range(len(rows)):
        assert np.array_equal(first[i].ids, second[i].ids)
        assert first[i].waves == second[i].waves
        assert_stats_equal(first[i].stats, second[i].stats, label=f"rerun {i}")


def test_graph_engine_refuses_unported_and_bad_configs(pgraph):
    with pytest.raises(NotImplementedError, match="item 7"):
        t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, num_shards=2)
    with pytest.raises(ValueError, match="k=20 ef=16"):
        t_ann.ContinuousGraphEngine(pgraph, k=20, ef=EF)


@pytest.mark.parametrize("seed,ef", [(0, 16), (1, 48)])
def test_engine_selection_equals_reference_select_wave(seed, ef):
    """The engine's selection on stacked solo tiles (row 0 of each tile, a
    per-slot ``expand``) picks what the reference's ``_select_wave`` picks
    for each slot alone (``qn=1`` of an 8-row tile)."""
    rng = np.random.default_rng(seed)
    n, words = 6, ops.graph_vis_words(64)
    top_sq = np.full((n * BQ, ef), np.inf, np.float32)
    top_ids = np.full((n * BQ, ef), -1, np.int32)
    for t in range(n):
        fill = int(rng.integers(1, ef + 1))
        top_sq[t * BQ, :fill] = np.sort(rng.random(fill).astype(np.float32))
        top_ids[t * BQ, :fill] = rng.choice(64, fill, replace=False)
    vis = (rng.integers(0, 2**32, (n, words), dtype=np.uint64)
           & rng.integers(0, 2**32, (n, words), dtype=np.uint64)).astype(np.uint32).view(np.int32)
    route = np.where(rng.random(n * BQ) < 0.5, np.float32(0.6), np.float32(np.inf))
    expand = rng.integers(1, 4, n)
    table = _select_wave(torch.as_tensor(top_sq[::BQ]), torch.as_tensor(top_ids[::BQ]),
                         torch.as_tensor(vis), torch.as_tensor(route[::BQ]), block_q=1,
                         qn=n, expand=expand, ef=ef)
    for t in range(n):
        want = j_select_wave(top_sq[t * BQ:(t + 1) * BQ], top_ids[t * BQ:(t + 1) * BQ],
                             j_unpack_vis(vis[t:t + 1], 64), route[t * BQ:(t + 1) * BQ],
                             q_tiles=1, block_q=BQ, qn=1, expand=int(expand[t]), ef=ef)[0]
        got = [v for v in table[t].tolist() if v >= 0]
        assert got == want, t


def test_pow2_helpers_equal_reference():
    for n in (1, 2, 3, 5, 8, 9, 1000):
        assert ops.pow2_bucket(n) == j_pow2_bucket(n)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for fill in (0.0, np.inf, -1):
        want = j_pad_live_rows(x, 3, 4, fill=fill)
        np.testing.assert_array_equal(ops.pad_live_rows(x, 3, 4, fill=fill), want)
        np.testing.assert_array_equal(
            ops.pad_live_rows(torch.as_tensor(x), 3, 4, fill=fill).numpy(), want)
    for bad in ((x, 2, 4), (x, 3, 2), (x, 3, 6)):
        with pytest.raises(ValueError):
            ops.pad_live_rows(*bad, fill=0.0)
        with pytest.raises(ValueError):
            j_pad_live_rows(*bad, fill=0.0)
    with pytest.raises(ValueError):
        ops.pow2_bucket(0)


# ---------------------------------------------------------------------------
# IVF route


def check_ivf(fused_idx, pivf, rows, schedule, *, probe_chunk, n_probe=6, reference=True):
    out = run_schedule(t_ann.ContinuousIVFEngine(pivf, k=K, n_probe=n_probe, block_q=BQ,
                                                 probe_chunk=probe_chunk), rows, schedule)
    solo = {}
    for i, rq in out.items():
        d, ids, s = solo[i] = search_ivf_fused(pivf, rows[i][None], k=K, n_probe=n_probe,
                                               block_q=BQ)
        assert np.array_equal(rq.ids, ids.numpy()[0]), f"query {i} ids diverge"
        assert np.array_equal(rq.dists, d.numpy()[0]), f"query {i} dists diverge"
        assert_stats_equal(rq.stats, s, label=f"query {i}")
    if reference:
        ref = run_schedule(j_ann.ContinuousIVFEngine(
            fused_idx, k=K, n_probe=n_probe, block_q=BQ, probe_chunk=probe_chunk,
            use_ref=True), rows, schedule)
        for i, rq in out.items():
            assert np.array_equal(rq.ids, ref[i].ids)
            np.testing.assert_allclose(rq.dists, ref[i].dists, **DIST_TOL)
            assert rq.waves == ref[i].waves
            assert_reference_ledger(
                rq.stats, ref[i].stats, lambda: solo[i][2].passed_per_query,
                lambda: j_search_ivf(fused_idx, rows[i][None], k=K, n_probe=n_probe,
                                     block_q=BQ, use_ref=True)[2].passed_per_query,
                label=f"reference query {i}")


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_ivf_schedule_equals_solo_and_reference(fused_idx, pivf, cont_queries, name):
    check_ivf(fused_idx, pivf, cont_queries, SCHEDULES[name], probe_chunk=2)


@pytest.mark.parametrize("chunk", [1, 3, 6])
def test_ivf_probe_chunk_invariance(fused_idx, pivf, cont_queries, chunk):
    """The chunked walk carries r and the window across launches, so any
    chunk size books the single launch's results and ledger."""
    check_ivf(fused_idx, pivf, cont_queries[:5], [2, 1, 2], probe_chunk=chunk,
              reference=False)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=3), min_size=1, max_size=8),
       st.integers(min_value=1, max_value=4))
def test_ivf_interleaving_invariance_property(fused_idx, pivf, cont_queries, schedule,
                                              chunk):
    check_ivf(fused_idx, pivf, cont_queries[:5], schedule, probe_chunk=chunk,
              reference=False)


def test_ivf_engine_refuses_unaligned_tiles(pivf):
    with pytest.raises(ValueError, match="128 % block_c"):
        t_ann.ContinuousIVFEngine(pivf, k=K, block_c=96)
    with pytest.raises(ValueError, match="probe_chunk"):
        t_ann.ContinuousIVFEngine(pivf, k=K, probe_chunk=0)


# ---------------------------------------------------------------------------
# The continuous scheduler: closed ledgers under sheds and drills


def _ledger_asserts(sched):
    s = sched.stats
    assert s["submitted"] == s["served"] + s["shed_queue"] + s["shed_deadline"] \
        + s["shed_error"], s
    assert s["admitted"] == s["retired"] + s["admission_shed"], s
    assert s["retire_frontier"] + s["retire_budget"] + s["retire_stall"] == s["retired"], s


def make_sched(pgraph, **kw):
    return t_sched.ContinuousScheduler(
        t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, block_q=BQ), **kw)


def test_scheduler_ledger_closes_clean(pgraph, cont_queries, graph_solo):
    reg = MetricsRegistry()
    sched = make_sched(pgraph, max_live=4, registry=reg)
    reqs = [sched.submit(cont_queries[i:i + 2]) for i in range(0, 10, 2)]
    served = sched.drain()
    assert len(served) == 5 and all(r.status == "served" for r in reqs)
    _ledger_asserts(sched)
    assert sched.stats["admitted"] == sched.stats["retired"] == 10
    snap = reg.snapshot()
    assert snap["serve.admission.admitted"]["value"] == 10
    assert snap["serve.admission.retired"]["value"] == 10
    assert snap["serve.wave.depth"]["count"] == 10
    for j, req in enumerate(reqs):
        for r in range(2):
            assert np.array_equal(req.result[1][r], graph_solo[2 * j + r][1])


def test_scheduler_ledger_closes_under_midwalk_sheds(pgraph, cont_queries):
    """A step error with retries exhausted sheds every live request mid-walk:
    their admissions close the ledger as admission sheds."""
    with t_chaos.use_chaos(t_chaos.parse_chaos("step_error:after=2:count=1")):
        sched = make_sched(pgraph, max_live=4, max_retries=0)
        for i in range(0, 10, 2):
            sched.submit(cont_queries[i:i + 2])
        sched.drain()
    _ledger_asserts(sched)
    s = sched.stats
    assert s["shed_error"] > 0 and s["admission_shed"] > 0
    assert s["served"] + s["shed_error"] == 5


def test_scheduler_ledger_closes_under_deadline_sheds(pgraph, cont_queries):
    sched = make_sched(pgraph, max_live=2)
    sched.submit(cont_queries[:2])
    sched.submit(cont_queries[2:4], deadline_s=-1.0)  # expired: shed at admission
    sched.drain()
    _ledger_asserts(sched)
    s = sched.stats
    assert s["shed_deadline"] == 1 and s["served"] == 1
    assert s["admitted"] == s["retired"] == 2


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=3), min_size=1, max_size=4),
       st.integers(min_value=1, max_value=4), st.integers(min_value=0, max_value=6))
def test_scheduler_ledger_property(pgraph, cont_queries, sizes, max_live, err_after):
    with t_chaos.use_chaos(t_chaos.parse_chaos(f"step_error:after={err_after}:count=1")):
        sched = make_sched(pgraph, max_live=max_live, max_retries=0)
        at = 0
        for sz in sizes:
            sched.submit(cont_queries[at:at + sz])
            at = (at + sz) % (len(cont_queries) - 3)
        sched.drain()
    _ledger_asserts(sched)


def test_scheduler_retry_absorbs_step_error_as_reference(graph_idx, pgraph, cont_queries,
                                                         monkeypatch):
    """A step error inside the retry budget is absorbed (the wave re-enters
    with its state unchanged), counted, and the results equal the solo
    searches; the reference's scheduler counts the same."""
    monkeypatch.setattr("time.sleep", lambda s: None)
    stats, ids = [], []
    for chaos, sched_mod, engine in (
            (t_chaos, t_sched, t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF)),
            (j_chaos, j_sched, j_ann.ContinuousGraphEngine(graph_idx[1], k=K, ef=EF,
                                                           use_ref=True))):
        with chaos.use_chaos(chaos.parse_chaos("step_error:after=1:count=1")):
            sched = sched_mod.ContinuousScheduler(engine, max_live=4, max_retries=2,
                                                  retry_backoff_s=0.0)
            reqs = [sched.submit(cont_queries[i:i + 2]) for i in range(0, 6, 2)]
            sched.drain()
        assert all(r.status == "served" for r in reqs)
        _ledger_asserts(sched)
        stats.append(dict(sched.stats))
        ids.append([r.result[1] for r in reqs])
    for a, b in zip(*ids):
        np.testing.assert_array_equal(a, b)
    assert stats[0] == stats[1] and stats[0]["retries"] == 1


# ---------------------------------------------------------------------------
# SLO dials


def test_slo_helpers_equal_reference():
    for a in np.linspace(0.0, 1.0, 11):
        for lo, hi in ((1.0, 6.0), (2.0, 2.0)):
            assert t_ann.slo_effort(float(a), lo, hi) == j_ann.slo_effort(float(a), lo, hi)
            assert t_ann.SLOPolicy(lo, hi).dial(float(a)) == j_ann.SLOPolicy(lo, hi).dial(float(a))
    lo, hi, prev = 1.0, 6.0, None
    for sig in np.linspace(0.0, 1.0, 21):
        e = t_ann.slo_effort(float(sig), lo, hi)
        assert lo <= e <= hi and (prev is None or e >= prev)
        prev = e
    with pytest.raises(ValueError):
        t_ann.slo_effort(0.5, 4.0, 2.0)
    with pytest.raises(ValueError):
        t_ann.SLOPolicy(1.0, 2.0, stall_waves=0)


def test_slo_signal_and_parse_edge_cases():
    for a, b in ((np.inf, 3.0), (np.inf, np.inf), (0.0, 0.0), (4.0, 2.0), (4.0, 4.0),
                 (4.0, 8.0)):
        assert t_ann.slo_signal(a, b) == j_ann.slo_signal(a, b)
    assert t_ann.slo_signal(4.0, 8.0) == 0.0 and t_ann.slo_signal(np.inf, 3.0) == 1.0
    for spec in ("off", "", "none", None, "1:4", "2:8:3", " 1.5:2 "):
        got, want = t_ann.parse_slo(spec), j_ann.parse_slo(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.lo, got.hi, got.stall_waves) == (want.lo, want.hi, want.stall_waves)
    for bad in ("4:1", "1:2:3:4", "x"):
        for mod in (t_ann, j_ann):
            with pytest.raises(ValueError):
                mod.parse_slo(bad)


def test_slo_pinned_dial_is_bit_identical(pgraph, cont_queries):
    """lo == hi == expand pins the dial: the walk equals slo=None's."""
    sched = [2, 1, 0, 2, 1]
    a = run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, expand=2,
                                                 slo=t_ann.SLOPolicy(2.0, 2.0)),
                     cont_queries[:6], sched)
    b = run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF, expand=2, slo=None),
                     cont_queries[:6], sched)
    for i in range(6):
        assert np.array_equal(a[i].ids, b[i].ids) and np.array_equal(a[i].dists, b[i].dists)
        assert_stats_equal(a[i].stats, b[i].stats, label=f"slo-pinned {i}")


def test_slo_stall_retires_with_reason_as_reference(graph_idx, pgraph, cont_queries):
    """stall_waves=1 retires a walk the first time its threshold fails to
    tighten; the port retires the queries the reference retires, when and
    why it does."""
    pol = dict(lo=1.0, hi=2.0, stall_waves=1)
    a = run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF,
                                                 slo=t_ann.SLOPolicy(**pol)),
                     cont_queries[:4], [4])
    b = run_schedule(j_ann.ContinuousGraphEngine(graph_idx[1], k=K, ef=EF, use_ref=True,
                                                 slo=j_ann.SLOPolicy(**pol)),
                     cont_queries[:4], [4])
    assert "stall" in {rq.reason for rq in a.values()}
    for i in range(4):
        assert (a[i].reason, a[i].waves) == (b[i].reason, b[i].waves)
        assert np.array_equal(a[i].ids, b[i].ids)


def test_ivf_slo_dials_probes(fused_idx, pivf, cont_queries):
    """On the IVF route the dial caps the probes: a pinned-low dial does no
    more launches than it allows, and the port dials as the reference."""
    kw = dict(k=K, n_probe=8, block_q=BQ, probe_chunk=1)
    a = run_schedule(t_ann.ContinuousIVFEngine(pivf, slo=t_ann.SLOPolicy(2.0, 2.0), **kw),
                     cont_queries[:3], [3])
    b = run_schedule(j_ann.ContinuousIVFEngine(fused_idx, slo=j_ann.SLOPolicy(2.0, 2.0),
                                               use_ref=True, **kw), cont_queries[:3], [3])
    for i, rq in a.items():
        assert rq.ids.shape == (K,) and np.all(np.diff(rq.dists) >= 0)
        assert rq.waves <= 3 and rq.waves == b[i].waves
        assert np.array_equal(rq.ids, b[i].ids)
        assert_stats_equal(rq.stats, b[i].stats, label=f"slo ivf {i}")


# ---------------------------------------------------------------------------
# Chaos on the graph routes


def test_shard_stall_fires_as_often_as_the_reference(graph_idx, pgraph, cont_queries,
                                                     monkeypatch):
    """The batch walk runs its waves in one launch, so the per-wave stall
    hook fires after it, as often as the reference's loop calls it; the
    continuous engine calls it every wave."""
    monkeypatch.setattr("time.sleep", lambda s: None)
    q = cont_queries[:4]
    spec = "shard_stall:ms=1:count=1000"
    with t_chaos.use_chaos(t_chaos.parse_chaos(spec)) as c_t:
        c_t.on_engine_step()  # arm: the drill clock ticks per dispatched batch
        search_graph_fused(pgraph, q, k=K, ef=EF, device="cpu")
        search_graph_fused(pgraph, q, k=K, ef=EF, max_waves=3, device="cpu")
        run_schedule(t_ann.ContinuousGraphEngine(pgraph, k=K, ef=EF), q[:2], [2])
    with j_chaos.use_chaos(j_chaos.parse_chaos(spec)) as c_j:
        c_j.on_engine_step()
        j_search_graph(graph_idx[1], q, k=K, ef=EF, use_ref=True)
        j_search_graph(graph_idx[1], q, k=K, ef=EF, max_waves=3, use_ref=True)
        run_schedule(j_ann.ContinuousGraphEngine(graph_idx[1], k=K, ef=EF, use_ref=True),
                     q[:2], [2])
    assert len(c_t.events) == len(c_j.events) > 0
    assert [e["wave"] for e in c_t.events] == [e["wave"] for e in c_j.events]
