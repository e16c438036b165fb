"""Port parity for the per-tile helpers: ``repro_torch.kernels.tiles``
against ``repro.kernels.tiles`` on numpy-seeded tiles.

Stage 1 is integer arithmetic followed by the same elementwise float ops,
so it must agree bit for bit; stage 2 and the merge must return the same
masks and ids (distances to float32 rounding: the port sums its fp32 dot
products one dimension at a time, the reference in the matmul's order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tiles as jt  # noqa: E402
from repro.quant.scalar import quantize_block, quantize_queries_block  # noqa: E402
from repro_torch.kernels import tiles as tt  # noqa: E402

_T = torch.as_tensor


def _tile(seed, bq=8, bc=32, dim=64, block_d=16):
    rng = np.random.default_rng(seed)
    scales = np.exp(-0.04 * np.arange(dim)).astype(np.float32)
    c = (rng.standard_normal((bc, dim)) * scales).astype(np.float32)
    q = (c[rng.integers(0, bc, bq)]
         + 0.3 * rng.standard_normal((bq, dim)) * scales).astype(np.float32)
    bs = (np.abs(c).reshape(bc, -1, block_d).max(axis=(0, 2)) / 127.0).astype(np.float32)
    codes = np.asarray(quantize_block(jnp.asarray(c), jnp.asarray(bs), block_d))
    qcodes, qscales = (np.asarray(a) for a in quantize_queries_block(jnp.asarray(q), block_d))
    s = dim // block_d
    eps = rng.uniform(0.05, 0.6, s).astype(np.float32)
    eps[-1] = 0.0
    scale = np.linspace(float(s), 1.0, s).astype(np.float32)
    d2 = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    rsq = np.quantile(d2, 0.3, axis=1).astype(np.float32)[:, None]
    return dict(q=q, c=c, bs=bs, codes=codes, qcodes=qcodes, qscales=qscales,
                eps=eps, scale=scale, rsq=rsq, block_d=block_d)


def test_mxu_block_sq_and_threshold_helpers():
    t = _tile(0)
    ref = np.asarray(jt.mxu_block_sq(jnp.asarray(t["q"]), jnp.asarray(t["c"])))
    port = tt.mxu_block_sq(_T(t["q"]), _T(t["c"])).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)  # fp32 sum order
    psum = np.abs(ref)
    eb = np.float32(0.37)
    np.testing.assert_array_equal(
        tt.lb_penalized(_T(psum), eb, _T(t["scale"][1]), slack=1e-4).numpy(),
        np.asarray(jt.lb_penalized(jnp.asarray(psum), eb, jnp.asarray(t["scale"][1]),
                                   slack=1e-4)))
    np.testing.assert_array_equal(
        tt.dade_threshold(_T(t["eps"]), _T(t["rsq"])).numpy(),
        np.asarray(jt.dade_threshold(jnp.asarray(t["eps"]), jnp.asarray(t["rsq"]))))


@pytest.mark.parametrize("seed", [0, 1])
def test_mxu_block_sq_sums_in_dimension_order(seed):
    """The order the CUDA kernel's stage 2 follows, so that the two agree
    bit for bit: each norm and dot product summed one dimension at a time,
    every product and sum rounded to float32."""
    t = _tile(seed)
    q, c = t["q"], t["c"]
    qn = np.zeros((q.shape[0], 1), np.float32)
    cn = np.zeros((1, c.shape[0]), np.float32)
    dot = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for d in range(q.shape[1]):
        qn = qn + q[:, d:d + 1] * q[:, d:d + 1]
        cn = cn + c[None, :, d] * c[None, :, d]
        dot = dot + q[:, d:d + 1] * c[None, :, d]
    want = np.maximum(qn + cn - np.float32(2.0) * dot, np.float32(0.0))
    np.testing.assert_array_equal(tt.mxu_block_sq(_T(q), _T(c)).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("block_d", [8, 16])
def test_stage1_tile_bit_exact(seed, block_d):
    t = _tile(seed, block_d=block_d)
    args_j = [jnp.asarray(t[n]) for n in ("qcodes", "qscales", "codes", "bs", "eps",
                                          "scale", "rsq")]
    args_t = [_T(t[n]) for n in ("qcodes", "qscales", "codes", "bs", "eps", "scale", "rsq")]
    a_j, d8_j = jt.stage1_tile(*args_j, block_d=block_d, slack=1e-4)
    a_t, d8_t = tt.stage1_tile(*args_t, block_d=block_d, slack=1e-4)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(d8_t.numpy(), np.asarray(d8_j))
    assert 0 < int(a_t.sum()) < a_t.numel()  # the prefilter decides both ways


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage1_tile_batched_equals_per_tile(seed):
    ts = [_tile(seed * 10 + i) for i in range(3)]
    stack = {n: np.stack([t[n] for t in ts]) for n in ("qcodes", "qscales", "codes", "rsq")}
    t0 = ts[0]
    a_b, d8_b = tt.stage1_tile(_T(stack["qcodes"]), _T(stack["qscales"]),
                               _T(stack["codes"]), _T(t0["bs"]), _T(t0["eps"]),
                               _T(t0["scale"]), _T(stack["rsq"]), block_d=16, slack=1e-4)
    for i, t in enumerate(ts):
        a, d8 = tt.stage1_tile(_T(t["qcodes"]), _T(t["qscales"]), _T(t["codes"]),
                               _T(t0["bs"]), _T(t0["eps"]), _T(t0["scale"]),
                               _T(t["rsq"]), block_d=16, slack=1e-4)
        assert torch.equal(a_b[i], a) and torch.equal(d8_b[i], d8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage2_tile_matches(seed):
    t = _tile(seed)
    rng = np.random.default_rng(seed + 100)
    active0 = rng.random((8, 32)) < 0.6
    valid = (rng.random((1, 32)) < 0.9)
    ej, sj = jnp.asarray(t["eps"]), jnp.asarray(t["scale"])
    ex_j, p_j, d32_j, sl_j = jt.stage2_tile(
        jnp.asarray(t["q"]), jnp.asarray(t["c"]), ej, sj, jnp.asarray(t["rsq"]),
        jnp.asarray(active0), jnp.asarray(valid), block_d=16)
    ex_t, p_t, d32_t, sl_t = tt.stage2_tile(
        _T(t["q"]), _T(t["c"]), _T(t["eps"]), _T(t["scale"]), _T(t["rsq"]),
        _T(active0), _T(valid), block_d=16)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(d32_t.numpy(), np.asarray(d32_j))
    assert float(sl_t) == float(sl_j)
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=1e-5, atol=1e-5)
    assert bool(tt.stage2_need(_T(active0), _T(valid))) == bool(
        jt.stage2_need(jnp.asarray(active0), jnp.asarray(valid)))
    assert not bool(tt.stage2_need(_T(active0), _T(np.zeros_like(valid))))


def test_stage2_slab_last_checkpoint_never_rejects():
    t = _tile(5)
    psum = torch.zeros((8, 32))
    act = torch.ones((8, 32), dtype=torch.bool)
    rsq = torch.zeros((8, 1))
    _, a_last, _ = tt.stage2_slab(psum, act, _T(t["q"][:, :16]), _T(t["c"][:, :16]),
                                  _T(t["eps"][0]), _T(t["scale"][0]), rsq,
                                  block_d=16, is_last=True)
    _, a_mid, _ = tt.stage2_slab(psum, act, _T(t["q"][:, :16]), _T(t["c"][:, :16]),
                                 _T(t["eps"][0]), _T(t["scale"][0]), rsq,
                                 block_d=16, is_last=False)
    assert bool(a_last.all()) and not bool(a_mid.any())


@pytest.mark.parametrize("k", [1, 4, 10])
def test_merge_topk_tile_tie_order(k):
    """Ties resolve as the reference's min-extract: the current window
    before the new tile, then the lower column."""
    rng = np.random.default_rng(k)
    top_sq = np.sort(rng.integers(0, 6, (4, k)).astype(np.float32), axis=1)
    top_sq[0, -1] = np.inf
    top_ids = rng.permutation(100)[:4 * k].reshape(4, k).astype(np.int32)
    top_ids[0, -1] = -1
    new_sq = rng.integers(0, 6, (4, 16)).astype(np.float32)
    new_sq[rng.random((4, 16)) < 0.3] = np.inf
    new_ids = (1000 + np.arange(16, dtype=np.int32)).reshape(1, 16)
    sq_j, id_j = jt.merge_topk_tile(jnp.asarray(top_sq), jnp.asarray(top_ids),
                                    jnp.asarray(new_sq), jnp.asarray(new_ids), k=k)
    sq_t, id_t = tt.merge_topk_tile(_T(top_sq), _T(top_ids), _T(new_sq),
                                    _T(new_ids), k=k)
    np.testing.assert_array_equal(sq_t.numpy(), np.asarray(sq_j))
    np.testing.assert_array_equal(id_t.numpy(), np.asarray(id_j))


def test_merge_topk_tile_unsorted_seed_window():
    top_sq = np.array([[3.0, 1.0, np.inf, 1.0]], np.float32)
    top_ids = np.array([[7, 8, 9, 10]], np.int32)
    new_sq = np.array([[1.0, np.inf, 0.5]], np.float32)
    new_ids = np.array([[20, 21, 22]], np.int32)
    sq_j, id_j = jt.merge_topk_tile(*(jnp.asarray(a) for a in (top_sq, top_ids, new_sq, new_ids)),
                                    k=4)
    sq_t, id_t = tt.merge_topk_tile(*(_T(a) for a in (top_sq, top_ids, new_sq, new_ids)), k=4)
    np.testing.assert_array_equal(sq_t.numpy(), np.asarray(sq_j))
    np.testing.assert_array_equal(id_t.numpy(), np.asarray(id_j))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_dup_mask_matches(k):
    rng = np.random.default_rng(k)
    top_ids = rng.integers(-1, 40, (6, k)).astype(np.int32)
    new_ids = rng.integers(-1, 40, (1, 24)).astype(np.int32)
    np.testing.assert_array_equal(
        tt.dup_mask(_T(new_ids), _T(top_ids), k=k).numpy(),
        np.asarray(jt.dup_mask(jnp.asarray(new_ids), jnp.asarray(top_ids), k=k)))
