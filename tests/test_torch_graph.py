"""Port parity for the graph route: the port's numpy NSW build and
adjacency-flat layout (``repro_torch.index.graph.graph_from_rotated``)
against the reference's ``build_graph``, and the batched beam walk
(``search_graph_fused`` on CPU tensors, i.e. through the plain version of
the kernel) against ``repro.index.graph.search_graph_fused(use_ref=True)``
on the same carried index.

Ids and every ``GraphScanStats`` field (waves, byte ledgers, skip rate)
must be equal; distances agree to fp32 rounding (the port's stage 2 sums
in dimension order, the reference's in the matmul's; relative 5e-5 on the
distances, the reference's own engine-parity tolerance)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.index.graph as j_graph  # noqa: E402
import repro_torch.index.graph as t_graph  # noqa: E402
from _torch_carry import carry_estimator, carry_graph, recall  # noqa: E402
from repro.core import build_estimator, exact_knn  # noqa: E402
from repro.data.pipeline import synthetic_queries, synthetic_vectors  # noqa: E402
from repro.index.graph import build_graph  # noqa: E402
from repro.index.graph import search_graph_fused as j_search  # noqa: E402
from repro.kernels.ops import block_table  # noqa: E402
from repro.kernels.ref import graph_scan_ref as j_graph_scan_ref  # noqa: E402
from repro.quant.scalar import quantize_queries_block  # noqa: E402
from repro_torch.index.graph import (  # noqa: E402
    graph_from_rotated, search_graph_beam_host, search_graph_fused)
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402


def test_graph_build_matches_reference(graph_idx):
    """The port's graph build on the reference's own rotated corpus gives the
    reference's graph and layout, element for element."""
    sub, g = graph_idx
    est = carry_estimator(g.estimator)
    port = graph_from_rotated(np.asarray(g.corpus_rot), est, m=12,
                              ef_construction=48, device="cpu")
    assert port.entry == int(g.entry)
    assert (port.adj_block, port.scan_block_d) == (g.adj_block, g.scan_block_d)
    np.testing.assert_array_equal(port.neighbors.numpy(), np.asarray(g.neighbors))
    np.testing.assert_array_equal(port.adj_ids.numpy(), np.asarray(g.adj_ids))
    np.testing.assert_array_equal(port.adj_codes.numpy(), np.asarray(g.adj_codes))
    np.testing.assert_array_equal(port.gscales.numpy(), np.asarray(g.gscales))
    np.testing.assert_array_equal(port.adj_rot.numpy(), np.asarray(g.adj_rot))
    np.testing.assert_array_equal(port.corpus_q.numpy(), np.asarray(g.corpus_q))
    np.testing.assert_array_equal(port.qscales.numpy(), np.asarray(g.qscales))


def _assert_same_walk(port, ref):
    (d, i, st), (dj, ij, stj) = port, ref
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=5e-5, atol=1e-5)
    assert st._asdict() == stj._asdict()


@pytest.fixture(scope="module")
def bf16_graph(aniso_corpus):
    """The serving configuration of the reference's engine-parity test:
    bf16 adjacency rows, 800 nodes."""
    sub = np.asarray(aniso_corpus)[:800]
    return sub, build_graph(sub, m=12, ef_construction=32, delta_d=16,
                            quant="int8", adj_dtype="bfloat16")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(seed_r=True),
    dict(decoupled=False, ef=32),
    dict(route_mult=1.2, ef=32),
], ids=["defaults", "seed_r", "coupled", "route_mult"])
def test_walk_matches_reference(graph_idx, queries, kw):
    sub, g = graph_idx
    port = carry_graph(g)
    q = np.asarray(queries)
    ref = j_search(g, jnp.asarray(q), k=10, use_ref=True, **kw)
    before = graph_scan_kernel_call.launches
    out = search_graph_fused(port, q, k=10, device="cpu", **kw)
    assert graph_scan_kernel_call.launches == before  # CPU tensors: plain path
    _assert_same_walk(out, ref)
    assert out[2].waves > 1 and out[2].s1_tiles_fetched > 0
    _, gt = exact_knn(jnp.asarray(q), jnp.asarray(sub), 10)
    assert recall(out[1].numpy(), gt) >= 0.85


def _recording(fn, log):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((args, kwargs, out))
        return out
    return wrapped


def test_coupled_walk_near_tie_at_threshold(graph_idx, queries, monkeypatch):
    """Where the two walks differ, it is a near-tie at the threshold.  On
    the first 16 queries the coupled walk (r² from the ef-th entry) returns
    the reference's ids and every ledger field but one passed row: in one
    step a candidate's squared distance equals the window's ef-th to fp32
    rounding, and the two implementations, which sum the distances in
    another order, land it on opposite sides of ``d <= r²``.  It passes the
    screen in one and not the other, and enters neither window."""
    sub, g = graph_idx
    port = carry_graph(g)
    q = np.asarray(queries)[:16]
    waves_j, waves_t = [], []
    monkeypatch.setattr(j_graph, "graph_scan_kernel",
                        _recording(j_graph.graph_scan_kernel, waves_j))
    monkeypatch.setattr(t_graph, "graph_scan_ref",
                        _recording(t_graph.graph_scan_ref, waves_t))
    kw = dict(k=10, ef=32, decoupled=False)
    dj, ij, stj = j_search(g, jnp.asarray(q), use_ref=True, **kw)
    d, i, st = search_graph_beam_host(port, q, device="cpu", **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=5e-5, atol=1e-5)
    diff = {f for f in st._fields if getattr(st, f) != getattr(stj, f)}
    assert diff == {"passed_per_query"}
    assert abs(st.passed_per_query - stj.passed_per_query) * len(q) == 1

    # The one wave and query row whose passed count differs...
    (w, row), = [(w, r) for w, (a, b) in enumerate(zip(waves_j, waves_t))
                 for r in np.nonzero(np.asarray(a[2][2])[:, 3] != b[2][2][:, 3].numpy())[0]]
    (j_args, _, _), (t_args, t_kw, _) = waves_j[w], waves_t[w]
    *_, trace_t = t_graph.graph_scan_ref(*t_args, **t_kw, return_trace=True)
    eps, scale, d_pad, _ = block_table(g.estimator.table, q.shape[1], g.scan_block_d)
    qcodes, qscales = quantize_queries_block(j_args[1], g.scan_block_d)
    *_, trace_j = j_graph_scan_ref(
        j_args[2], qcodes, j_args[1], qscales, j_args[3], j_args[4], j_args[5],
        j_args[10], g.adj_codes, g.adj_rot, g.adj_ids, g.gscales, eps, scale,
        ef=32, thresh_col=31, block_q=8, block_c=g.adj_block,
        block_d=g.scan_block_d, return_trace=True)
    # ...holds one candidate that passed in one walk only, at d ~ r².
    ties = []
    for rj, rt in zip(trace_j, trace_t):
        if rj["tile"] != row // 8 or rj["exact_sq"] is None:
            continue
        r = row % 8
        pj, pt = np.asarray(rj["passed"])[r], rt["passed"].numpy()[r]
        for c in np.nonzero(pj != pt)[0]:
            ties.append((float(np.asarray(rj["exact_sq"])[r, c]), float(np.asarray(rj["rsq"])[r]),
                         float(rt["exact_sq"][r, c]), float(rt["rsq"][r])))
    assert len(ties) == 1
    d_j, r_j, d_t, r_t = ties[0]
    assert (d_j <= r_j) != (d_t <= r_t)
    assert abs(d_j - r_j) <= 1e-6 * r_j and abs(d_t - r_t) <= 1e-6 * r_t


def test_bf16_walk_matches_reference_and_host_engine(bf16_graph, queries):
    sub, g = bf16_graph
    port = carry_graph(g)
    assert port.adj_rot.dtype == torch.bfloat16
    q = np.asarray(queries)
    ref = j_search(g, jnp.asarray(q), k=10, ef=24, expand=2, use_ref=True)
    out = search_graph_fused(port, q, k=10, ef=24, expand=2, device="cpu")
    _assert_same_walk(out, ref)
    host = search_graph_beam_host(port, q, k=10, ef=24, expand=2, device="cpu")
    assert torch.equal(host[0], out[0]) and torch.equal(host[1], out[1])
    assert host[2] == out[2]
    # The fetched ledger counts the bf16 slab stream at 2 B per dim.
    st = out[2]
    d_pad = port.adj_rot.shape[1]
    expect = (st.s1_tiles_fetched * port.adj_block * (d_pad + 4)
              + st.s2_slabs_fetched * port.adj_block * port.scan_block_d * 2) / len(q)
    assert st.fetched_bytes_per_query == pytest.approx(expect)


def test_search_refuses_other_device(graph_idx, queries):
    port = carry_graph(graph_idx[1])
    with pytest.raises(ValueError, match="lives on cpu"):
        search_graph_fused(port, np.asarray(queries), device="meta")
    with pytest.raises(ValueError, match="k=50 ef=48"):
        search_graph_fused(port, np.asarray(queries), k=50, device="cpu")


def test_fig8_fetched_bytes_reproduced():
    """The reference's fig8 smoke cell ``graph_fused@rm1`` (4000 x 96 corpus,
    m = 32, bf16 adjacency, ef 32, expand 2): the port's walk on the
    carried graph books the reference's fetched bytes per query exactly,
    within the smoke baseline's band of 134,008."""
    corpus = synthetic_vectors(4000, 96, seed=0, decay=0.06)
    q = synthetic_queries(16, 96, corpus, seed=1)
    est = build_estimator("dade", corpus, jax.random.PRNGKey(7), delta_d=32, p_s=0.1)
    g = build_graph(corpus, estimator=est, m=32, ef_construction=64,
                    quant="int8", adj_dtype="bfloat16")
    kw = dict(k=10, ef=32, expand=2, block_q=8, route_mult=1.0)
    ref = j_search(g, jnp.asarray(q), use_ref=True, **kw)
    out = search_graph_fused(carry_graph(g), q, device="cpu", **kw)
    _assert_same_walk(out, ref)
    assert out[2].fetched_bytes_per_query == pytest.approx(134008, rel=0.08)
