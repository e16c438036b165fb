"""The host-side modules the earlier slices left out, held against the
reference on the same numpy inputs: the numpy DCO engines
(``core.dco_host``, ``quant.screen``'s host engines: equal outputs, the
same code), ``index.ivf.search_ivf`` over the padded-gather layout (fp32,
``use_quant``, ``seed_r``), the greedy ``index.graph.search_graph``,
``calibration.violation_rates`` on the reference's own pairs,
``transforms.orthogonality_error``, ``pipeline.drifted_vectors``,
``annservice.autotune_refine_budget`` and the unfused ``build_search_step``
routes against the reference's one-device step.

Tolerances: ids and masks equal; host-engine outputs equal (numpy on both
sides); distances of the torch engines to fp32 rounding (``rtol=5e-5,
atol=1e-5``); violation rates within one pair's verdict (1/num_pairs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_estimator, carry_graph  # noqa: E402
from repro.core import build_estimator  # noqa: E402
from repro.core import calibration as j_calib  # noqa: E402
from repro.core import dco_host as j_host  # noqa: E402
from repro.core import transforms as j_tf  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.quant import screen as j_screen  # noqa: E402
from repro.quant.scalar import quantize_corpus as j_quantize_corpus  # noqa: E402
from repro_torch.core import calibration, dco_host, transforms  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.index.graph import search_graph  # noqa: E402
from repro_torch.index.ivf import IVFIndex, search_ivf  # noqa: E402
from repro_torch.quant import screen  # noqa: E402

CLOSE = dict(rtol=5e-5, atol=1e-5)


@pytest.fixture(scope="module")
def rotated(aniso_corpus, queries):
    est = build_estimator("dade", jnp.asarray(aniso_corpus), jax.random.PRNGKey(0),
                          delta_d=16)
    c = np.asarray(est.rotate(jnp.asarray(aniso_corpus)))[:1500]
    q = np.asarray(est.rotate(jnp.asarray(queries)))
    t = est.table
    return est, c, q, (np.asarray(t.dims), np.asarray(t.eps), np.asarray(t.scale))


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("r_sq", [0.5, 4.0, np.inf])
def test_dco_screen_host_matches_reference(rotated, r_sq):
    _, c, q, (dims, eps, scale) = rotated
    got = dco_host.dco_screen_host(q[0], c[:700], dims, eps, scale, r_sq)
    want = j_host.dco_screen_host(q[0], c[:700], dims, eps, scale, r_sq)
    _equal(got[:3], want[:3])
    assert got.flops == want.flops


def test_knn_search_host_matches_reference(rotated):
    _, c, q, (dims, eps, scale) = rotated
    for qi in range(3):
        got = dco_host.knn_search_host(q[qi], c, 10, dims, eps, scale, wave=512)
        want = j_host.knn_search_host(q[qi], c, 10, dims, eps, scale, wave=512)
        _equal(got[:2], want[:2])
        assert got[2] == want[2]


@pytest.fixture(scope="module")
def quantized(rotated):
    _, c, _, _ = rotated
    qc = j_quantize_corpus(jnp.asarray(c))
    return np.asarray(qc.codes), np.asarray(qc.scales)


@pytest.mark.parametrize("r_sq", [0.5, 4.0, np.inf])
def test_two_stage_screen_host_matches_reference(rotated, quantized, r_sq):
    _, c, q, (dims, eps, scale) = rotated
    codes, scales = quantized
    got = screen.two_stage_screen_host(q[1], codes[:700], scales, c[:700], dims, eps,
                                       scale, r_sq)
    want = j_screen.two_stage_screen_host(q[1], codes[:700], scales, c[:700], dims, eps,
                                          scale, r_sq)
    _equal(got[:4], want[:4])
    assert got.bytes_scanned == want.bytes_scanned


def test_knn_search_quant_host_matches_reference(rotated, quantized):
    _, c, q, (dims, eps, scale) = rotated
    codes, scales = quantized
    for qi in range(3):
        got = screen.knn_search_quant_host(q[qi], codes, scales, c, 10, dims, eps, scale,
                                           wave=512)
        want = j_screen.knn_search_quant_host(q[qi], codes, scales, c, 10, dims, eps,
                                              scale, wave=512)
        _equal(got[:2], want[:2])
        assert got[2] == want[2]
        # The exact engine's ids: the int8 prefilter prunes nothing inside r.
        np.testing.assert_array_equal(
            got[0], dco_host.knn_search_host(q[qi], c, 10, dims, eps, scale, wave=512)[0])


@pytest.fixture(scope="module")
def ivf_pair(fused_idx):
    """The reference's int8 IVF index and its padded-gather layout carried
    into the port."""
    t = (lambda a: torch.as_tensor(np.array(a)))
    idx = fused_idx
    port = IVFIndex(estimator=carry_estimator(idx.estimator), centroids=t(idx.centroids),
                    bucket_sizes=t(idx.bucket_sizes), buckets=t(idx.buckets),
                    bucket_ids=t(idx.bucket_ids), qbuckets=t(idx.qbuckets),
                    qscales=t(idx.qscales), max_bucket=idx.max_bucket)
    return idx, port


@pytest.mark.parametrize("kw", [dict(), dict(use_quant=True), dict(seed_r=True),
                                dict(use_quant=True, seed_r=True, n_probe=16)],
                         ids=["fp32", "use_quant", "seed_r", "both_probe16"])
def test_search_ivf_matches_reference(ivf_pair, queries, kw):
    from repro.index.ivf import search_ivf as j_search_ivf
    idx, port = ivf_pair
    kw = dict(dict(k=10, n_probe=6), **kw)
    d_j, i_j, a_j = j_search_ivf(idx, jnp.asarray(queries), **kw)
    d_p, i_p, a_p = search_ivf(port, queries, device="cpu", **kw)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), **CLOSE)
    assert float(a_p) == pytest.approx(float(a_j), rel=1e-6)


def test_search_ivf_refuses_quant_without_codes(ivf_pair, queries):
    import dataclasses
    _, port = ivf_pair
    plain = dataclasses.replace(port, qbuckets=None, qscales=None)
    with pytest.raises(ValueError, match="quant"):
        search_ivf(plain, queries, use_quant=True, device="cpu")


def test_port_build_ivf_padded_layout_is_the_flat_layouts(aniso_corpus, queries):
    """The port's own build lays every row into both layouts: the padded
    search and the fused route find the same neighbours of a query."""
    from repro_torch.index.ivf import build_ivf, search_ivf_fused
    idx = build_ivf(np.asarray(aniso_corpus)[:1000], n_clusters=8, delta_d=16,
                    device="cpu")
    sizes = idx.bucket_sizes.long()
    assert int((idx.bucket_ids >= 0).sum()) == 1000 == int(sizes.sum())
    d_p, i_p, _ = search_ivf(idx, queries, k=10, n_probe=8, device="cpu")
    d_f, i_f, _ = search_ivf_fused(idx, queries, k=10, n_probe=8)
    np.testing.assert_array_equal(np.sort(i_p.numpy(), 1), np.sort(i_f.numpy(), 1))
    np.testing.assert_allclose(d_p.numpy(), d_f.numpy(), **CLOSE)


@pytest.mark.parametrize("kw", [dict(), dict(use_quant=True), dict(seed_r=True),
                                dict(decoupled=False, ef=24)],
                         ids=["fp32", "use_quant", "seed_r", "coupled"])
def test_search_graph_greedy_matches_reference(graph_idx, queries, kw):
    from repro.index.graph import search_graph as j_search_graph
    _, g = graph_idx
    kw = dict(dict(k=10, ef=32, with_stats=True), **kw)
    d_j, i_j, x_j = j_search_graph(g, jnp.asarray(queries[:10]), **kw)
    d_p, i_p, x_p = search_graph(carry_graph(g), queries[:10], **kw)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), **CLOSE)
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_j))  # dims, rows, steps


def test_unquantized_graph_build_walks_greedily(aniso_corpus, queries):
    from repro_torch.index.graph import build_graph
    g = build_graph(np.asarray(aniso_corpus)[:300], m=8, ef_construction=24,
                    delta_d=16, quant=None, device="cpu")
    assert not g.has_quant and not g.has_fused and g.adj_rot is None
    d, i, avg = search_graph(g, queries[:4], k=5, ef=16)
    assert tuple(i.shape) == (4, 5) and bool((avg > 0).all())
    with pytest.raises(ValueError, match="quant"):
        search_graph(g, queries[:4], use_quant=True)


def _ref_pairs(seed, n, num_pairs):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.randint(k1, (num_pairs,), 0, n)),
            np.asarray(jax.random.randint(k2, (num_pairs,), 0, n)))


@pytest.mark.parametrize("drift", [0.0, 0.15], ids=["fresh", "drifted"])
def test_violation_rates_match_reference_on_its_pairs(aniso_corpus, drift):
    sub = np.asarray(aniso_corpus)[:400]
    est = build_estimator("dade", jnp.asarray(sub), jax.random.PRNGKey(0), delta_d=16,
                          p_s=0.05)
    data = (sub if drift == 0 else
            np.asarray(j_pipe.drifted_vectors(est.transform, 400, extra_decay=drift)))
    want = np.asarray(j_calib.violation_rates(est.table, est.transform,
                                              jnp.asarray(data), jax.random.PRNGKey(4),
                                              num_pairs=1024))
    pest = carry_estimator(est)
    got = calibration.violation_rates(pest.table, pest.transform, data,
                                      pairs=_ref_pairs(4, 400, 1024)).numpy()
    np.testing.assert_allclose(got, want, atol=1.0 / 1024 + 1e-7)
    assert got[-1] == 0.0
    # Drawn from the port's own generator: the same statistic, other pairs.
    own = calibration.violation_rates(pest.table, pest.transform, data,
                                      torch.Generator().manual_seed(0), num_pairs=1024)
    assert own.shape == got.shape and bool(((own >= 0) & (own <= 1)).all())


def test_orthogonality_error_and_drifted_vectors(aniso_corpus):
    est = build_estimator("dade", jnp.asarray(np.asarray(aniso_corpus)[:500]),
                          jax.random.PRNGKey(0), delta_d=16)
    pest = carry_estimator(est)
    got = transforms.orthogonality_error(pest.transform)
    assert got == pytest.approx(j_tf.orthogonality_error(est.transform), abs=1e-6)
    assert got < 1e-5
    for kw in (dict(), dict(extra_decay=0.15, seed=3)):
        np.testing.assert_array_equal(
            pipeline.drifted_vectors(pest.transform, 64, **kw),
            np.asarray(j_pipe.drifted_vectors(est.transform, 64, **kw)))


def test_autotune_refine_budget_matches_reference(rotated, quantized):
    from repro.launch.annservice import autotune_refine_budget as j_autotune
    from repro_torch.launch.annservice import autotune_refine_budget
    _, c, _, _ = rotated
    _, scales = quantized
    for k, wave in ((10, 1024), (100, 4096)):
        assert autotune_refine_budget(scales, c, k=k, wave=wave) == j_autotune(
            jnp.asarray(scales), c, k=k, wave=wave)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["quant_none", "fused_off"])
def test_unfused_search_step_matches_reference_one_device_step(aniso_corpus, quant):
    """``build_search_step(quant, fused=False)`` against the reference's
    one-device step (a one-device CPU mesh), on the reference's rotated
    corpus and blocked table: ids equal, distances to fp32 rounding."""
    from repro.configs.dade_ivf import ServiceConfig as JService
    from repro.kernels.ops import block_table
    from repro.launch.annservice import build_search_step as j_step
    from repro.launch.mesh import make_mesh_compat
    from repro_torch.configs.dade_ivf import ServiceConfig
    from repro_torch.launch.annservice import build_search_step
    corpus = np.asarray(aniso_corpus)
    q = j_pipe.synthetic_queries(16, 64, corpus, seed=5)
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0), delta_d=16)
    eps, scale, _, eps_lo = block_table(est.table, 64, 16)
    c_rot = np.asarray(est.rotate(jnp.asarray(corpus)))
    q_rot = np.asarray(est.rotate(jnp.asarray(q)))
    kw = dict(corpus_per_device=4000, dim=64, query_batch=16, k=10, delta_d=16,
              wave=1000, dtype="float32", refine_per_wave=24)
    step_j = j_step(JService(**kw), make_mesh_compat((1,), ("data",)), quant=quant,
                    fused=False)
    step_p = build_search_step(ServiceConfig(**kw), quant=quant, fused=False)
    t = (lambda a: torch.as_tensor(np.array(a)))
    if quant:
        qc = j_quantize_corpus(jnp.asarray(c_rot))
        d_j, i_j = step_j(jnp.asarray(c_rot), qc.codes, qc.scales, jnp.asarray(q_rot), eps,
                          scale, eps_lo)
        d_p, i_p = step_p(t(c_rot), t(qc.codes), t(qc.scales), t(q_rot), t(eps), t(scale),
                          t(eps_lo))
    else:
        d_j, i_j = step_j(jnp.asarray(c_rot), jnp.asarray(q_rot), eps, scale, eps_lo)
        d_p, i_p = step_p(t(c_rot), t(q_rot), t(eps), t(scale), t(eps_lo))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), **CLOSE)
