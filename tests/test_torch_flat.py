"""Port parity for the flat index and the plain screens under it:
``repro_torch.index.flat.search_flat`` (fp32, two-phase and
``use_quant``), ``core.topk.knn_search_waves``/``seed_threshold``,
``core.dco.dco_screen``/``dco_screen_batch`` and
``quant.screen.two_stage_screen`` against the JAX package on the
reference-built flat index (``_torch_carry.carry_flat``).

Both sides compute squared distances as ``qn + cn - 2 q·c`` in float32,
summed in another order, so they agree to rtol 1e-5 plus an absolute
1e-6 of the largest squared norms involved (``norm_sq``: the rounding of
that decomposition scales with the norms, not the distance).  Ids are
equal up to near-ties: an id may differ only where its squared distance
is within that tolerance of the query's K-th.  ``avg_dims`` agrees to
1e-5 relative; screen decisions differ on at most 1e-3 of the pairs,
those next to a threshold."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_flat  # noqa: E402
from repro.core.dco import dco_screen as j_dco_screen  # noqa: E402
from repro.core.dco import dco_screen_batch as j_dco_screen_batch  # noqa: E402
from repro.core.topk import knn_search_waves as j_knn_search_waves  # noqa: E402
from repro.core.topk import seed_threshold as j_seed_threshold  # noqa: E402
from repro.index.flat import build_flat as j_build_flat  # noqa: E402
from repro.index.flat import ground_truth as j_ground_truth  # noqa: E402
from repro.index.flat import search_flat as j_search_flat  # noqa: E402
from repro.quant.scalar import QuantizedCorpus as JQuantizedCorpus  # noqa: E402
from repro.quant.screen import bytes_scanned as j_bytes_scanned  # noqa: E402
from repro.quant.screen import two_stage_screen as j_two_stage_screen  # noqa: E402
from repro_torch.core.dco import dco_screen, dco_screen_batch  # noqa: E402
from repro_torch.core.topk import knn_search_waves, seed_threshold  # noqa: E402
from repro_torch.index.flat import build_flat, ground_truth, search_flat  # noqa: E402
from repro_torch.quant.scalar import QuantizedCorpus, quantize_corpus  # noqa: E402
from repro_torch.quant.screen import bytes_scanned, two_stage_screen  # noqa: E402

K = 10
WAVE = 512
RTOL = 1e-5


@pytest.fixture(scope="module")
def flat(aniso_corpus, queries):
    idx = j_build_flat(aniso_corpus, quant="int8", delta_d=16)
    port = carry_flat(idx)
    q_rot = np.array(idx.estimator.rotate(jnp.asarray(queries)))
    rot = np.asarray(idx.corpus_rot)
    norm_sq = float((q_rot ** 2).sum(1).max() + (rot ** 2).sum(1).max())
    return dict(idx=idx, port=port, queries=np.array(queries), q_rot=q_rot,
                atol=1e-6 * norm_sq)


def _assert_same_knn(out, ref, atol):
    """Ids equal up to near-ties at the K-th squared distance; squared
    distances to rtol 1e-5 + ``atol``, avg_dims to rtol 1e-5."""
    p_ids, r_ids = out.ids.numpy(), np.asarray(ref.ids)
    p_sq = out.dists.numpy().astype(np.float64) ** 2
    r_sq = np.asarray(ref.dists).astype(np.float64) ** 2
    np.testing.assert_allclose(p_sq, r_sq, rtol=RTOL, atol=atol)
    for i in range(len(r_ids)):
        kth = r_sq[i, -1]
        for ids, d, other in ((p_ids[i], p_sq[i], r_ids[i]), (r_ids[i], r_sq[i], p_ids[i])):
            for j in np.nonzero(~np.isin(ids, other))[0]:
                assert abs(d[j] - kth) <= RTOL * kth + atol, (
                    f"query {i}: id {ids[j]} is no near-tie")
    np.testing.assert_allclose(float(out.avg_dims), float(ref.avg_dims), rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(two_phase=True), dict(use_quant=True)],
                         ids=["fp32", "two_phase", "use_quant"])
def test_search_flat_matches_reference(flat, kw):
    ref = j_search_flat(flat["idx"], jnp.asarray(flat["queries"]), k=K, wave=WAVE, **kw)
    out = search_flat(flat["port"], torch.as_tensor(flat["queries"]), k=K, wave=WAVE, **kw)
    _assert_same_knn(out, ref, flat["atol"])
    assert out.ids.dtype == torch.int32 and tuple(out.ids.shape) == (len(flat["queries"]), K)


def test_search_flat_quant_identical_to_fp32(flat):
    """No false prune: the two-stage route returns the fp32 route's ids and
    distances and scans fewer fp32 dims."""
    qt = torch.as_tensor(flat["queries"])
    a = search_flat(flat["port"], qt, k=K, wave=WAVE)
    b = search_flat(flat["port"], qt, k=K, wave=WAVE, use_quant=True)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert float(b.avg_dims) < float(a.avg_dims)


def test_search_flat_recall_and_ground_truth(flat):
    ref_d, ref_ids = j_ground_truth(flat["idx"], jnp.asarray(flat["queries"]), K)
    gt_d, gt_ids = ground_truth(flat["port"], flat["queries"], K)
    np.testing.assert_array_equal(gt_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(gt_d.numpy().astype(np.float64) ** 2,
                               np.asarray(ref_d).astype(np.float64) ** 2,
                               rtol=RTOL, atol=flat["atol"])
    out = search_flat(flat["port"], torch.as_tensor(flat["queries"]), k=K, wave=WAVE)
    ids = out.ids.numpy()
    rec = np.mean([len(set(ids[i]) & set(gt_ids[i].tolist())) / K for i in range(len(ids))])
    assert rec >= 0.9


@pytest.mark.parametrize("wave", [512, 1000])
def test_knn_search_waves_matches_reference(flat, wave):
    """Direct engine call; wave 1000 pads the 4000-row corpus by nothing,
    wave 512 by 96 sentinel rows."""
    idx, port = flat["idx"], flat["port"]
    ref = j_knn_search_waves(jnp.asarray(flat["q_rot"]), idx.corpus_rot,
                             idx.estimator.table, k=K, wave=wave)
    out = knn_search_waves(torch.as_tensor(flat["q_rot"]), port.corpus_rot,
                           port.estimator.table, k=K, wave=wave)
    _assert_same_knn(out, ref, flat["atol"])


def test_seed_threshold_matches_reference(flat):
    idx, port = flat["idx"], flat["port"]
    ref = j_seed_threshold(jnp.asarray(flat["q_rot"]), idx.corpus_rot, idx.estimator.table, K)
    out = seed_threshold(torch.as_tensor(flat["q_rot"]), port.corpus_rot,
                         port.estimator.table, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=flat["atol"])


def _band_equal(p_dec, r_dec, p_est, r_est, atol):
    """Decisions equal except on at most 1e-3 of the pairs (a checkpoint
    test next to its threshold can flip on fp32 rounding); estimates of the
    agreeing pairs to rtol 1e-5 + ``atol``."""
    differ = p_dec != r_dec
    assert differ.sum() <= differ.size * 1e-3
    same = ~differ
    np.testing.assert_allclose(p_est[same], r_est[same], rtol=RTOL, atol=atol)


def test_dco_screen_batch_matches_reference(flat):
    idx, port = flat["idx"], flat["port"]
    c = np.asarray(idx.corpus_rot)[:600]
    r_sq = np.quantile(((flat["q_rot"][:, None, :] - c[None]) ** 2).sum(-1), 0.02,
                       axis=1).astype(np.float32)
    ref = j_dco_screen_batch(jnp.asarray(flat["q_rot"]), jnp.asarray(c),
                             idx.estimator.table, jnp.asarray(r_sq))
    out = dco_screen_batch(torch.as_tensor(flat["q_rot"]), torch.as_tensor(c),
                           port.estimator.table, torch.as_tensor(r_sq))
    assert out.passed.dtype == torch.bool and out.dims_used.dtype == torch.int32
    _band_equal(out.passed.numpy(), np.asarray(ref.passed), out.est_sq.numpy(),
                np.asarray(ref.est_sq), flat["atol"])
    _band_equal(out.dims_used.numpy(), np.asarray(ref.dims_used), out.est_sq.numpy(),
                np.asarray(ref.est_sq), flat["atol"])
    assert 0 < int(out.passed.sum()) < out.passed.numel()


def test_dco_screen_single_query_matches_reference(flat):
    idx, port = flat["idx"], flat["port"]
    c = np.asarray(idx.corpus_rot)[:600]
    q = flat["q_rot"][3]
    r_sq = float(np.quantile(((c - q) ** 2).sum(-1), 0.05))
    ref = j_dco_screen(jnp.asarray(q), jnp.asarray(c), idx.estimator.table, r_sq)
    out = dco_screen(torch.as_tensor(q), torch.as_tensor(c), port.estimator.table, r_sq)
    np.testing.assert_array_equal(out.passed.numpy(), np.asarray(ref.passed))
    np.testing.assert_array_equal(out.dims_used.numpy(), np.asarray(ref.dims_used))
    np.testing.assert_allclose(out.est_sq.numpy(), np.asarray(ref.est_sq), rtol=RTOL,
                               atol=flat["atol"])


def test_two_stage_screen_matches_reference(flat):
    idx, port = flat["idx"], flat["port"]
    n = 600
    c = np.asarray(idx.corpus_rot)[:n]
    r_sq = np.quantile(((flat["q_rot"][:, None, :] - c[None]) ** 2).sum(-1), 0.02,
                       axis=1).astype(np.float32)
    ref = j_two_stage_screen(jnp.asarray(flat["q_rot"]), jnp.asarray(c),
                             JQuantizedCorpus(idx.corpus_q[:n], idx.qscales),
                             idx.estimator.table, jnp.asarray(r_sq))
    out = two_stage_screen(torch.as_tensor(flat["q_rot"]), port.corpus_rot[:n],
                           QuantizedCorpus(port.corpus_q[:n], port.qscales),
                           port.estimator.table, torch.as_tensor(r_sq))
    for name in ("passed", "stage1_pruned", "dims_used", "lb_dims"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        _band_equal(a, b, out.est_sq.numpy(), np.asarray(ref.est_sq), flat["atol"])
    assert bool(out.stage1_pruned.any())
    base = dco_screen_batch(torch.as_tensor(flat["q_rot"]), port.corpus_rot[:n],
                            port.estimator.table, torch.as_tensor(r_sq))
    assert torch.equal(out.passed, base.passed)
    np.testing.assert_array_equal(bytes_scanned(out).numpy(), np.asarray(j_bytes_scanned(ref)))


def test_build_flat_on_cpu_quantizes_the_rotated_corpus(aniso_corpus):
    data = np.asarray(aniso_corpus)[:1024]
    idx = build_flat(data, quant="int8", delta_d=16, device="cpu")
    assert idx.has_quant and idx.corpus_q.dtype == torch.int8
    qc = quantize_corpus(idx.corpus_rot)
    assert torch.equal(idx.corpus_q, qc.codes) and torch.equal(idx.qscales, qc.scales)
    plain = build_flat(data, delta_d=16, device="cpu")
    assert not plain.has_quant and plain.estimator.quant is None
    assert torch.equal(plain.estimator.table.eps, idx.estimator.table.eps)
    with pytest.raises(ValueError, match="quant"):
        search_flat(plain, data[:4], k=K, use_quant=True)
