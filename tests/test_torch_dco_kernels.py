"""Port parity for the flat DCO screens: ``repro_torch.kernels.ops
.dco_screen_kernel``, ``.quant_screen_kernel`` and ``l2_scan
.l2_scan_kernel_call`` (on CPU tensors: their plain versions in
``kernels.ref``) against the JAX package's on the same numpy inputs — its
oracles (``use_ref=True``) across the shape, dtype and method sweeps of
``tests/test_kernels_dade.py``, ``tests/test_quant.py`` and the flat cells
of ``tests/test_estimator_conformance.py``, and its Pallas kernels in
interpret mode once each.

Tolerances: estimates and lower bounds rtol = atol = 1e-5, l2 distances
rtol 1e-5 — the port sums each block dimension by dimension, the reference
in its matmul's order, so values agree to fp32 rounding.  Decisions
(``passed``/``pruned``, dims) are equal outside a band of 1e-5·threshold
around the deciding checkpoint's threshold, and the pairs inside it number
at most 1e-3 of all pairs.  The CUDA kernels are held against the same
plain versions on the card, bit for bit (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import KERNEL_METHODS  # noqa: E402
from _torch_carry import carry_estimator  # noqa: E402
from repro.core import build_estimator  # noqa: E402
from repro.core.dco import dco_screen_batch as j_dco_screen_batch  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.l2_scan import l2_scan_kernel_call as j_l2_scan  # noqa: E402
from repro.quant import quantize_corpus as j_quantize_corpus  # noqa: E402
from repro_torch.core.dco import dco_screen_batch  # noqa: E402
from repro_torch.core.estimators import blocked_schedule  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels.dade_dco import dade_dco_kernel_call  # noqa: E402
from repro_torch.kernels.l2_scan import l2_scan_kernel_call  # noqa: E402
from repro_torch.kernels.quant_dco import quant_dco_kernel_call  # noqa: E402
from repro_torch.quant.scalar import DEFAULT_SLACK, QuantizedCorpus  # noqa: E402
from repro_torch.quant.screen import two_stage_screen  # noqa: E402

BAND = 1e-5
_EST = {}


def _fixture(d, n, q, seed=0, decay=0.05):
    """(JAX estimator, port estimator, rotated queries, rotated candidates)
    as numpy, as ``tests/test_kernels_dade.py`` builds them."""
    key = (d, n, q, seed, decay)
    if key not in _EST:
        rng = np.random.default_rng(seed)
        scales = np.exp(-decay * np.arange(d)).astype(np.float32)
        data = (rng.standard_normal((max(n * 2, 1024), d)) * scales).astype(np.float32)
        qs = (rng.standard_normal((q, d)) * scales).astype(np.float32)
        est = build_estimator("dade", data, jax.random.PRNGKey(seed), delta_d=32)
        _EST[key] = (est, carry_estimator(est), np.array(est.rotate(jnp.asarray(qs))),
                     np.array(est.rotate(jnp.asarray(data[:n]))))
    return _EST[key]


def _checkpoints(est_t, q, c, r_sq, block_d, *, codes=None, scales=None,
                 slack=DEFAULT_SLACK):
    """float64 (S, Q, N) estimates and (S, Q, 1) thresholds of every block
    checkpoint: the exact partial distance (or, with ``codes``, the lower
    bound over the dequantized rows) beside (1+eps)²r²."""
    dim = q.shape[1]
    eps, scale, _, d_pad = blocked_schedule(est_t.table, dim, block_d)
    rows = c if codes is None else codes.astype(np.float64) * scales
    qp = np.pad(q.astype(np.float64), ((0, 0), (0, d_pad - dim)))
    cp = np.pad(rows.astype(np.float64), ((0, 0), (0, d_pad - dim)))
    sq = (qp[:, None, :] - cp[None, :, :]) ** 2
    cum = np.cumsum(sq, axis=2)[:, :, block_d - 1::block_d]  # (Q, N, S)
    cum = np.moveaxis(cum, 2, 0)
    if codes is None:
        est = cum * scale[:, None, None]
    else:
        sc = np.pad(scales.astype(np.float64), (0, d_pad - dim))
        ecum = np.sqrt(np.cumsum((sc * 0.5) ** 2)[block_d - 1::block_d])
        root = np.maximum(np.sqrt(cum) - ecum[:, None, None], 0.0)
        est = root * root * (1.0 - slack) * scale[:, None, None]
    thresh = (1.0 + eps.astype(np.float64))[:, None, None] ** 2 * np.asarray(
        r_sq, np.float64)[None, :, None]
    return est, thresh


def _near(est, thresh, r_sq, *, terminal):
    """(Q, N) pairs within the band at some checkpoint (or, with
    ``terminal``, at the final est <= r² test)."""
    with np.errstate(invalid="ignore"):
        fin = np.isfinite(thresh) & np.isfinite(est)
        near = np.any(fin & (np.abs(est - thresh) <= BAND * np.abs(thresh)), axis=0)
        if terminal:
            r = np.asarray(r_sq, np.float64)[:, None]
            near |= np.abs(est[-1] - r) <= BAND * np.abs(r)
    return near


def _assert_screen(out, ref, near):
    """``out``/``ref``: (estimate, decision, dims).  Decisions and dims are
    equal outside the band; estimates of pairs retired at the same
    checkpoint agree to rtol = atol = 1e-5."""
    p_est, p_dec, p_dims = (a.numpy() for a in out)
    r_est, r_dec, r_dims = (np.asarray(a) for a in ref)
    assert p_dec.dtype == bool and p_dims.dtype == np.int32
    differ = (p_dec != r_dec.astype(bool)) | (p_dims != r_dims)
    assert not np.any(differ & ~near), "decision differs outside the band"
    assert differ.sum() <= differ.size * 1e-3
    same = ~differ
    np.testing.assert_allclose(p_est[same], r_est[same], rtol=1e-5, atol=1e-5)


def _dco_both(est, est_t, q, c, r_sq, **kw):
    ref = j_ops.dco_screen_kernel(est, jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(r_sq), use_ref=True, **kw)
    out = t_ops.dco_screen_kernel(est_t, torch.as_tensor(q), torch.as_tensor(c),
                                  torch.as_tensor(r_sq), **kw)
    return out, ref


def _quant_both(est, est_t, q, codes, scales, r_sq, **kw):
    ref = j_ops.quant_screen_kernel(est, jnp.asarray(q), jnp.asarray(codes),
                                    jnp.asarray(scales), jnp.asarray(r_sq),
                                    use_ref=True, **kw)
    out = t_ops.quant_screen_kernel(est_t, torch.as_tensor(q), torch.as_tensor(codes),
                                    torch.as_tensor(scales), torch.as_tensor(r_sq), **kw)
    return out, ref


# ---- fp32 screen ------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128, 200, 384])
@pytest.mark.parametrize("n", [128, 300])
def test_dco_screen_matches_reference_shape_sweep(d, n):
    est, est_t, q, c = _fixture(d, n, 8)
    r_sq = np.full((8,), d * 0.5, np.float32)
    kw = dict(block_q=8, block_c=128, block_d=64)
    out, ref = _dco_both(est, est_t, q, c, r_sq, **kw)
    e, t = _checkpoints(est_t, q, c, r_sq, 64)
    _assert_screen(out, ref, _near(e, t, r_sq, terminal=True))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dco_screen_dtype_sweep(dtype):
    """bf16 inputs are cast to f32 by the wrapper, as in the reference."""
    est, est_t, q, c = _fixture(128, 256, 8, seed=3)
    q = np.asarray(jnp.asarray(q).astype(dtype).astype(jnp.float32))
    c = np.asarray(jnp.asarray(c).astype(dtype).astype(jnp.float32))
    r_sq = np.full((8,), 40.0, np.float32)
    ref = j_ops.dco_screen_kernel(est, jnp.asarray(q).astype(dtype),
                                  jnp.asarray(c).astype(dtype), jnp.asarray(r_sq),
                                  use_ref=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = t_ops.dco_screen_kernel(est_t, torch.as_tensor(q).to(tdt),
                                  torch.as_tensor(c).to(tdt), torch.as_tensor(r_sq))
    e, t = _checkpoints(est_t, q, c, r_sq, 128)
    _assert_screen(out, ref, _near(e, t, r_sq, terminal=True))


@pytest.mark.parametrize("r_value", [0.0, 1e30, np.inf])
def test_dco_screen_extreme_thresholds(r_value):
    """r² = 0 rejects every pair at its first checkpoint, r² = 1e30 and inf
    reject none (a disabled threshold must not reject either); both sides
    agree exactly on the decisions."""
    est, est_t, q, c = _fixture(200, 300, 8)
    r_sq = np.full((8,), r_value, np.float32)
    out, ref = _dco_both(est, est_t, q, c, r_sq, block_q=8, block_c=128, block_d=64)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    if r_value == 0.0:
        assert not out[1].any() and int(out[2].max()) == 64
    else:
        assert out[1].all() and int(out[2].min()) == 256


def test_dco_screen_matches_interpret_kernel():
    """One case against the Pallas kernel itself, run in interpret mode."""
    est, est_t, q, c = _fixture(64, 128, 8)
    r_sq = np.full((8,), 32.0, np.float32)
    kw = dict(block_q=8, block_c=128, block_d=64)
    ref = j_ops.dco_screen_kernel(est, jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(r_sq), interpret=True, **kw)
    out = t_ops.dco_screen_kernel(est_t, torch.as_tensor(q), torch.as_tensor(c),
                                  torch.as_tensor(r_sq), **kw)
    e, t = _checkpoints(est_t, q, c, r_sq, 64)
    _assert_screen(out, ref, _near(e, t, r_sq, terminal=True))
    assert 0 < int(out[1].sum()) < out[1].numel()


def test_dco_screen_vs_core_engine():
    """The kernel path at block_d = 128 equals the plain core screen with a
    table whose checkpoints sit on the same grid (both ports, and the
    reference's core screen)."""
    _, _, q, c = _fixture(128, 256, 4, seed=5)
    est128 = build_estimator(
        "dade", np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1024, 128))),
        jax.random.PRNGKey(1), delta_d=128)
    est_t = carry_estimator(est128)
    r_sq = np.full((4,), 64.0, np.float32)
    e_k, p_k, d_k = t_ops.dco_screen_kernel(est_t, torch.as_tensor(q), torch.as_tensor(c),
                                            torch.as_tensor(r_sq), block_d=128)
    res = dco_screen_batch(torch.as_tensor(q), torch.as_tensor(c), est_t.table,
                           torch.as_tensor(r_sq))
    ref = j_dco_screen_batch(jnp.asarray(q), jnp.asarray(c), est128.table, jnp.asarray(r_sq))
    e, t = _checkpoints(est_t, q, c, r_sq, 128)
    near = _near(e, t, r_sq, terminal=True)
    _assert_screen((e_k, p_k, d_k), (res.est_sq, res.passed, res.dims_used), near)
    _assert_screen((e_k, p_k, d_k), tuple(ref), near)


def test_dco_screen_pruning_monotone():
    """Smaller thresholds can only retire earlier (dims monotone)."""
    est, est_t, q, c = _fixture(128, 256, 4, seed=9)
    qt, ct = torch.as_tensor(q), torch.as_tensor(c)
    _, _, tight = t_ops.dco_screen_kernel(est_t, qt, ct, torch.full((4,), 1.0), block_d=32)
    _, _, loose = t_ops.dco_screen_kernel(est_t, qt, ct, torch.full((4,), 1e6), block_d=32)
    assert bool((tight <= loose).all()) and bool((tight < loose).any())


# ---- flat conformance cells (every method) ---------------------------------

K = 10
BLOCK_D = 16
N_FLAT = 512


@pytest.fixture(params=KERNEL_METHODS, scope="module")
def flat_cell(request, method_estimator_factory, aniso_corpus, queries):
    """Both estimators, rotated queries, a rotated 512-row slab and per-query
    thresholds at the midpoint of each query's K-th/(K+1)-th exact gap, as
    the conformance suite's flat cells."""
    est = method_estimator_factory(request.param)
    q = np.asarray(est.rotate(jnp.asarray(queries)))
    c = np.asarray(est.rotate(jnp.asarray(aniso_corpus)))[:N_FLAT]
    exact_sq = ((q.astype(np.float64)[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    srt = np.sort(exact_sq, axis=1)
    r_sq = (0.5 * (srt[:, K - 1] + srt[:, K])).astype(np.float32)
    return dict(method=request.param, est=est, est_t=carry_estimator(est), q=q, c=c,
                exact_sq=exact_sq, r_sq=r_sq)


def test_flat_cell_dco_screen(flat_cell):
    """Every method: the port's screen against the reference's oracle, no
    false prune against the exact distances, and passed rows carry them."""
    f = flat_cell
    out, ref = _dco_both(f["est"], f["est_t"], f["q"], f["c"], f["r_sq"],
                         block_q=8, block_c=128, block_d=BLOCK_D)
    e, t = _checkpoints(f["est_t"], f["q"], f["c"], f["r_sq"], BLOCK_D)
    _assert_screen(out, ref, _near(e, t, f["r_sq"], terminal=True))
    passed = out[1].numpy()
    rb = f["r_sq"].astype(np.float64)[:, None]
    assert not np.any((f["exact_sq"] <= rb * (1 - 1e-6)) & ~passed)
    np.testing.assert_allclose(out[0].numpy()[passed], f["exact_sq"][passed],
                               rtol=1e-4, atol=1e-3)


def test_flat_cell_quant_screen(flat_cell):
    """Every method: the int8 prefilter against the reference's oracle; it
    prunes no row inside the exact ball, nothing the fp32 screen passes,
    and the two-stage screen passes what the fp32 screen passes."""
    f = flat_cell
    qc = j_quantize_corpus(jnp.asarray(f["c"]))
    codes, scales = np.asarray(qc.codes), np.asarray(qc.scales)
    out, ref = _quant_both(f["est"], f["est_t"], f["q"], codes, scales, f["r_sq"],
                           block_q=8, block_c=128, block_d=BLOCK_D)
    e, t = _checkpoints(f["est_t"], f["q"], f["c"], f["r_sq"], BLOCK_D,
                        codes=codes, scales=scales)
    _assert_screen(out, ref, _near(e, t, f["r_sq"], terminal=False))
    pruned = out[1].numpy()
    rb = f["r_sq"].astype(np.float64)[:, None]
    assert not np.any((f["exact_sq"] <= rb * (1 - 1e-6)) & pruned)
    qt, ct, rt = (torch.as_tensor(f[x]) for x in ("q", "c", "r_sq"))
    _, passed, _ = t_ops.dco_screen_kernel(f["est_t"], qt, ct, rt, block_q=8,
                                           block_c=128, block_d=BLOCK_D)
    assert not bool((out[1] & passed).any())
    qct = QuantizedCorpus(torch.as_tensor(codes), torch.as_tensor(scales))
    ts = two_stage_screen(qt, ct, qct, f["est_t"].table, rt)
    base = dco_screen_batch(qt, ct, f["est_t"].table, rt)
    assert torch.equal(ts.passed, base.passed)


# ---- int8 lower-bound prefilter -------------------------------------------

def _quant_fixture(d, seed, decay=0.05):
    rng = np.random.default_rng(seed)
    scales = np.exp(-decay * np.arange(d)).astype(np.float32)
    data = (rng.standard_normal((1024, d)) * scales).astype(np.float32)
    qs = (rng.standard_normal((8, d)) * scales).astype(np.float32)
    est = build_estimator("dade", data, jax.random.PRNGKey(0), delta_d=32)
    rot = est.rotate(jnp.asarray(data))
    qc = j_quantize_corpus(rot)
    return (est, carry_estimator(est), np.asarray(est.rotate(jnp.asarray(qs))),
            np.asarray(rot), np.asarray(qc.codes), np.asarray(qc.scales))


@pytest.mark.parametrize("d,n", [(64, 128), (200, 300), (128, 256)])
def test_quant_screen_matches_reference(d, n):
    est, est_t, q, rot, codes, scales = _quant_fixture(d, d + n)
    r_sq = np.full((8,), d * 0.02, np.float32)
    out, ref = _quant_both(est, est_t, q, codes[:n], scales, r_sq,
                           block_q=8, block_c=128, block_d=64)
    e, t = _checkpoints(est_t, q, rot[:n], r_sq, 64, codes=codes[:n], scales=scales)
    _assert_screen(out, ref, _near(e, t, r_sq, terminal=False))
    assert out[1].any()


def test_quant_screen_matches_interpret_kernel():
    est, est_t, q, rot, codes, scales = _quant_fixture(64, 192)
    r_sq = np.full((8,), 64 * 0.02, np.float32)
    kw = dict(block_q=8, block_c=128, block_d=64)
    ref = j_ops.quant_screen_kernel(est, jnp.asarray(q), jnp.asarray(codes[:128]),
                                    jnp.asarray(scales), jnp.asarray(r_sq),
                                    interpret=True, **kw)
    out = t_ops.quant_screen_kernel(est_t, torch.as_tensor(q), torch.as_tensor(codes[:128]),
                                    torch.as_tensor(scales), torch.as_tensor(r_sq), **kw)
    e, t = _checkpoints(est_t, q, rot[:128], r_sq, 64, codes=codes[:128], scales=scales)
    _assert_screen(out, ref, _near(e, t, r_sq, terminal=False))


def test_quant_screen_sound_vs_fp32_screen():
    """Pruned rows never pass the fp32 screen, and the prefilter works."""
    rng = np.random.default_rng(7)
    d = 128
    sc = np.exp(-0.06 * np.arange(d)).astype(np.float32)
    data = (rng.standard_normal((2048, d)) * sc).astype(np.float32)
    est = build_estimator("dade", data, jax.random.PRNGKey(1), delta_d=32)
    est_t = carry_estimator(est)
    rot = np.asarray(est.rotate(jnp.asarray(data)))
    qc = j_quantize_corpus(jnp.asarray(rot))
    q, r_sq = torch.as_tensor(rot[:8]), torch.full((8,), 1.0)
    _, pruned, _ = t_ops.quant_screen_kernel(
        est_t, q, torch.as_tensor(np.asarray(qc.codes)[:512]),
        torch.as_tensor(np.asarray(qc.scales)), r_sq, block_d=32)
    _, passed, _ = t_ops.dco_screen_kernel(est_t, q, torch.as_tensor(rot[:512]), r_sq,
                                           block_d=32)
    assert bool(pruned.any()) and not bool((pruned & passed).any())


def test_quant_screen_pruning_monotone():
    """A tighter threshold prunes a superset, never later."""
    est, est_t, q, _, codes, scales = _quant_fixture(128, 11)
    args = (est_t, torch.as_tensor(q), torch.as_tensor(codes[:256]), torch.as_tensor(scales))
    _, p_tight, d_tight = t_ops.quant_screen_kernel(*args, torch.full((8,), 0.5), block_d=32)
    _, p_loose, d_loose = t_ops.quant_screen_kernel(*args, torch.full((8,), 5.0), block_d=32)
    assert bool((p_loose <= p_tight).all()) and bool((p_tight & ~p_loose).any())
    both = p_tight & p_loose
    assert bool((d_tight[both] <= d_loose[both]).all())


# ---- l2 scan ----------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 256])
def test_l2_scan_exact(d):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((8, d)).astype(np.float32)
    c = rng.standard_normal((256, d)).astype(np.float32)
    out = l2_scan_kernel_call(torch.as_tensor(q), torch.as_tensor(c), block_q=8,
                              block_c=128, block_d=128)
    ref = ((q.astype(np.float64)[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


def test_l2_scan_matches_interpret_kernel():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 256)).astype(np.float32)
    c = rng.standard_normal((128, 256)).astype(np.float32)
    ref = j_l2_scan(jnp.asarray(q), jnp.asarray(c), block_q=8, block_c=128,
                    block_d=128, interpret=True)
    out = l2_scan_kernel_call(torch.as_tensor(q), torch.as_tensor(c), block_q=8,
                              block_c=128, block_d=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def test_dade_screen_never_exceeds_l2_work():
    """dims_used <= D everywhere, strictly fewer on average at a tight r."""
    rng = np.random.default_rng(1)
    sc = np.exp(-0.06 * np.arange(128)).astype(np.float32)
    data = (rng.standard_normal((2048, 128)) * sc).astype(np.float32)
    est_t = carry_estimator(build_estimator("dade", data, jax.random.PRNGKey(0),
                                            delta_d=32))
    q = est_t.rotate(torch.as_tensor(data[:8]))
    c = est_t.rotate(torch.as_tensor(data[:512]))
    _, _, dims = t_ops.dco_screen_kernel(est_t, q, c, torch.full((8,), 1.0), block_d=32)
    assert int(dims.max()) <= 128 and float(dims.float().mean()) < 128


# ---- kernel-call contract ---------------------------------------------------

def test_kernel_calls_refuse_unpadded_shapes_and_mixed_devices():
    q, c = torch.zeros((8, 64)), torch.zeros((100, 64))
    eps, scale, r = torch.zeros(1), torch.ones(1), torch.zeros(8)
    with pytest.raises(ValueError, match="padded"):
        dade_dco_kernel_call(q, c, eps, scale, r, block_q=8, block_c=128, block_d=64)
    with pytest.raises(ValueError, match="int8"):
        quant_dco_kernel_call(q, torch.zeros((128, 64)), torch.ones(64), eps, scale, eps, r,
                              block_q=8, block_c=128, block_d=64)
    with pytest.raises(ValueError, match="devices"):
        l2_scan_kernel_call(q, torch.zeros((128, 64), device="meta"), block_q=8,
                            block_c=128, block_d=64)


def test_cpu_path_runs_plain_version_without_counting():
    est, est_t, q, c = _fixture(64, 128, 8)
    before = (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches,
              l2_scan_kernel_call.launches)
    qt, ct = torch.as_tensor(q), torch.as_tensor(c)
    t_ops.dco_screen_kernel(est_t, qt, ct, torch.full((8,), 30.0))
    t_ops.quant_screen_kernel(est_t, qt, torch.zeros((128, 64), dtype=torch.int8),
                              torch.ones(64), torch.full((8,), 30.0))
    l2_scan_kernel_call(qt, ct, block_q=8, block_c=128, block_d=64)
    assert (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches,
            l2_scan_kernel_call.launches) == before


# ---- the CUDA screens' host side: shapes refused, paths read off dims -------

def test_screen_launch_refuses_what_the_linear_grid_cannot_take():
    from repro_torch.kernels._screen import KERNEL_TILE, check_launch

    tq, tc = KERNEL_TILE
    check_launch(1024, 2**20, 256, 64, int8=False)  # the flat screen's shape
    # 2^20 queries: past the 65,535 query tiles a second grid axis would allow
    check_launch(2**20, 4096, 256, 64, int8=True)
    check_launch(tq, (2**31 - 1) * tc, 64, 64, int8=False)  # the last tile the grid holds
    with pytest.raises(ValueError, match="linear grid"):
        check_launch(tq, (2**31 - 1) * tc + 1, 64, 64, int8=False)
    with pytest.raises(ValueError, match="linear grid"):
        check_launch(tq + 1, 2**30 * tc, 64, 64, int8=True)
    for dim, bd in ((200, 50), (256, 24), (64, 0), (96, 64)):
        with pytest.raises(ValueError, match="16 bytes"):
            check_launch(8, 64, dim, bd, int8=False)
    # a list entry's dims after block 1 must fit the 15,360-float staging ring
    check_launch(8, 64, 7664 + 16, 16, int8=False)
    check_launch(8, 64, 6816 + 16, 16, int8=True)  # f32 values and the code bytes
    check_launch(8, 64, 2**15, 2**15, int8=False)  # one block: no list
    with pytest.raises(ValueError, match="too wide"):
        check_launch(8, 64, 7680 + 16, 16, int8=False)
    with pytest.raises(ValueError, match="too wide"):
        check_launch(8, 64, 6832 + 16, 16, int8=True)


@pytest.mark.parametrize("cap,dense_steps,list_entries", [(1, 4, 9), (0, 13, 0), (2, 4, 9)])
def test_screen_work_counts_each_tiles_path_by_hand(cap, dense_steps, list_entries):
    """Tiles of 1 x 2 pairs at block_d 16 over four blocks, hand-counted.
    The survivors after checkpoints 0, 1, 2 (dims > 16, 32, 48) per tile:
    (0,0:2) [16, 64]: 1, 1, 1; (0,2:3) [48]: 1, 1, 0; (1,0:2) [32, 16]:
    1, 0, 0; (1,2:3) [64]: 1, 1, 1.  At cap 1 or 2 every tile goes to the
    list after block 1 (9 entries); at cap 0 a tile runs dense until no
    pair survives (4 + 3 + 2 + 4 blocks)."""
    from repro_torch.kernels._screen import screen_work

    dims = torch.tensor([[16, 64, 48], [32, 16, 64]], dtype=torch.int32)
    assert screen_work(dims, 16, tile=(1, 2), cap=cap) == {
        "dense_steps": dense_steps, "list_entries": list_entries, "tiles": 4}


def test_screen_work_at_the_kernel_tile():
    """The kernel's 128 x 64 tile and list capacity: a ragged (130, 70)
    output is 2 x 2 tiles.  Tile (0, 0) keeps capacity + 1 pairs past block
    1 (block 2 dense), then 3 past blocks 2 and 3 (a list of 3, twice);
    tile (1, 1) keeps one pair to the end (3 entries); the rest retire at
    block 1."""
    from repro_torch.kernels._screen import KERNEL_TILE, LIST_CAP, screen_work

    dims = torch.full((130, 70), 16, dtype=torch.int32)
    tile = torch.full((128 * 64,), 16, dtype=torch.int32)
    tile[:LIST_CAP + 1] = 32
    tile[:3] = 64
    dims[:128, :64] = tile.reshape(128, 64)
    dims[129, 69] = 64
    assert KERNEL_TILE == (128, 64)
    assert screen_work(dims, 16) == {"dense_steps": 4 + 1, "list_entries": 3 + 3 + 3,
                                     "tiles": 4}
