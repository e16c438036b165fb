"""Port parity for the fused IVF wave scan: ``repro_torch.kernels.ops
.ivf_scan_kernel`` (on CPU tensors: the plain oracle ``ref.ivf_scan_ref``)
against ``repro.kernels.ops.ivf_scan_kernel(use_ref=True)``, and the
wave-by-wave replay of the port's trace against ``dco_screen_batch``.

Ids, ``passed`` sets and every stats column (fetch counters included) must
be equal; distances agree to fp32 rounding of the stage-2 dot products,
which sum in another order (relative 1e-6 of the squared norms involved).
The CUDA kernel itself is held against the same oracle on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_estimator, carry_ivf  # noqa: E402
from repro.core.dco import dco_screen_batch  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.quant.scalar import fit_block_scales, quantize_block  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels.ref import ivf_scan_ref  # noqa: E402
from repro_torch.quant.scalar import quantize_queries_block  # noqa: E402


def _assert_same_scan(port, ref, norm_sq):
    p_sq, p_ids, p_st = (a.numpy() for a in port)
    r_sq, r_ids, r_st = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_st, r_st)
    fin = np.isfinite(r_sq)
    np.testing.assert_array_equal(np.isfinite(p_sq), fin)
    # qn + cn - 2 q·c in float32, summed in another order.
    np.testing.assert_allclose(p_sq[fin], r_sq[fin], rtol=1e-6,
                               atol=1e-6 * norm_sq)


@pytest.fixture(scope="module")
def idx_case(fused_idx, queries):
    idx = fused_idx
    est = idx.estimator
    q_rot = est.rotate(jnp.asarray(queries))
    qn = q_rot.shape[0]
    cd = (jnp.sum(q_rot * q_rot, 1)[:, None]
          + jnp.sum(idx.centroids * idx.centroids, 1)[None, :]
          - 2.0 * q_rot @ idx.centroids.T)
    tile_cd = jnp.min(cd.reshape(qn // 8, 8, -1), axis=1)
    _, tb = jax.lax.top_k(-tile_cd, 4)
    norm_sq = float(jnp.max(jnp.sum(q_rot * q_rot, 1))) * 4.0
    return dict(idx=idx, port=carry_ivf(idx), q_rot=np.asarray(q_rot),
                ws=np.asarray(idx.starts[tb]), wr=np.asarray(idx.bucket_sizes[tb]),
                norm_sq=norm_sq)


def _both(case, k, r0, lo=0, hi=4, top0=None):
    idx, port = case["idx"], case["port"]
    ws, wr = case["ws"][:, lo:hi], case["wr"][:, lo:hi]
    kw = dict(k=k, max_bucket=idx.max_bucket, block_q=8, block_c=128,
              block_d=idx.scan_block_d, starts_aligned=True)
    t0 = (None, None) if top0 is None else top0
    ref = j_ops.ivf_scan_kernel(
        idx.estimator, jnp.asarray(case["q_rot"]), jnp.asarray(ws), jnp.asarray(wr),
        idx.flat_rot, idx.flat_codes, idx.flat_ids, idx.bscales, jnp.asarray(r0),
        *(None if a is None else jnp.asarray(a) for a in t0), use_ref=True, **kw)
    out = t_ops.ivf_scan_kernel(
        port.estimator, torch.as_tensor(case["q_rot"]), torch.as_tensor(ws),
        torch.as_tensor(wr), port.flat_rot, port.flat_codes, port.flat_ids,
        port.bscales, torch.as_tensor(r0),
        *(None if a is None else torch.as_tensor(a) for a in t0), **kw)
    return out, ref


def test_fused_idx_scan_matches_reference(idx_case):
    r0 = np.full((24,), np.inf, np.float32)
    out, ref = _both(idx_case, 10, r0)
    _assert_same_scan(out, ref, idx_case["norm_sq"])
    st = out[2].numpy()
    assert st[:, 5].sum() > 0 and st[:, 4].sum() > 0


def test_seeded_resume_matches_reference(idx_case):
    """A chunked probe plan: the second launch resumes the window and r²
    the first returned (seeded ``top0`` windows)."""
    k = 10
    r0 = np.full((24,), np.inf, np.float32)
    (sq1, ids1, _), ref1 = _both(idx_case, k, r0, 0, 2)
    np.testing.assert_array_equal(ids1.numpy(), np.asarray(ref1[1]))
    r1 = np.minimum(r0, np.asarray(ref1[0])[:, k - 1]).astype(np.float32)
    out, ref = _both(idx_case, k, r1, 2, 4,
                     top0=(np.asarray(ref1[0]), np.asarray(ref1[1])))
    _assert_same_scan(out, ref, idx_case["norm_sq"])


def _awkward(seed, *, n_rows=640, dim=48, block_d=16, block_c=32):
    """A hand-made flat layout: id holes, unaligned and overlapping windows
    (cross-gap tile reuse), buckets shorter than the window (-1 steps)."""
    rng = np.random.default_rng(seed)
    scales = np.exp(-0.05 * np.arange(dim)).astype(np.float32)
    rows = (rng.standard_normal((n_rows, dim)) * scales).astype(np.float32)
    ids = np.arange(n_rows, dtype=np.int32)
    ids[rng.random(n_rows) < 0.1] = -1
    ids[-2 * block_c:] = -1
    rows[ids < 0] = 1e18
    bs = np.asarray(fit_block_scales(jnp.asarray(np.where(rows > 1e17, 0, rows)), block_d))
    codes = np.asarray(quantize_block(jnp.asarray(np.where(rows > 1e17, 0, rows)),
                                      jnp.asarray(bs), block_d))
    qn = 10
    q = (rows[rng.integers(0, n_rows // 2, qn)]
         + 0.2 * rng.standard_normal((qn, dim)) * scales).astype(np.float32)
    q[ids[:qn] < 0] = q[0]
    q_tiles = (qn + 3) // 4
    ws = rng.integers(0, n_rows - 4 * block_c, (q_tiles, 5)).astype(np.int32)
    wr = rng.integers(1, 3 * block_c, (q_tiles, 5)).astype(np.int32)
    # Probes 1 and 2 visit the same one-tile bucket: probe 2's real step
    # re-uses the resident tile across probe 1's trailing -1 steps.
    ws[:, 1] = ws[:, 1] // block_c * block_c + 3
    ws[:, 2] = ws[:, 1]
    wr[:, 1] = wr[:, 2] = 5
    ws[:, 4] = ws[:, 0]  # a later revisit, after other tiles: fetched again
    wr[:, 4] = wr[:, 0]
    return rows, codes, ids, bs, q, ws, wr


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 10)])
def test_awkward_shapes_match_reference(method_estimator_factory, seed, k):
    rows, codes, ids, bs, q, ws, wr = _awkward(seed)
    d2 = ((q[:, None, :] - np.where(rows > 1e17, 0, rows)[None]) ** 2).sum(-1)
    r0 = np.quantile(d2, 0.05, axis=1).astype(np.float32)
    r0[3] = np.inf
    top0_sq = np.full((10, k), np.inf, np.float32)
    top0_ids = np.full((10, k), -1, np.int32)
    top0_sq[1, 0], top0_ids[1, 0] = 0.5, 5  # a seeded window entry
    est = method_estimator_factory("dade")
    import dataclasses
    est48 = dataclasses.replace(
        est, table=dataclasses.replace(
            est.table, dims=jnp.asarray([16, 32, 48], jnp.int32),
            eps=jnp.asarray([0.3, 0.1, 0.0], jnp.float32),
            scale=jnp.asarray([2.5, 1.4, 1.0], jnp.float32),
            eps_lo=jnp.zeros((3,), jnp.float32)))
    kw = dict(k=k, max_bucket=int(wr.max()), block_q=4, block_c=32, block_d=16,
              starts_aligned=False)
    ref = j_ops.ivf_scan_kernel(
        est48, jnp.asarray(q), jnp.asarray(ws), jnp.asarray(wr), jnp.asarray(rows),
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(bs), jnp.asarray(r0),
        jnp.asarray(top0_sq), jnp.asarray(top0_ids), use_ref=True, **kw)
    T = torch.as_tensor
    out = t_ops.ivf_scan_kernel(
        carry_estimator(est48), T(q), T(ws), T(wr), T(rows), T(codes), T(ids),
        T(bs), T(r0), T(top0_sq), T(top0_ids), **kw)
    _assert_same_scan(out, ref, float((q * q).sum(1).max()) * 4.0)
    st = out[2].numpy()
    tiles_stepped = (t_ops.build_window_offsets(
        T(ws), T(wr), block_c=32, cap_tiles=t_ops.ivf_cap_tiles(
            int(wr.max()), 32, starts_aligned=False), n_pad=rows.shape[0]) >= 0).sum()
    assert st[::4, 5].sum() < int(tiles_stepped)  # some steps re-used a tile


def test_wave_replay_passed_parity_and_soundness(idx_case):
    """Replays every real step of the port's trace against
    ``dco_screen_batch`` at the same frozen r²: the ``passed`` sets are
    identical and no stage-1-pruned row passes the fp32 screen.  (Whether a
    tile's fetch is elided is a property of the fixture, not asserted.)"""
    case = idx_case
    idx, port = case["idx"], case["port"]
    block_d, block_q, block_c = idx.scan_block_d, 8, 128
    q_rot = torch.as_tensor(case["q_rot"])
    cap_tiles = t_ops.ivf_cap_tiles(idx.max_bucket, block_c, starts_aligned=True)
    tile_offs = t_ops.build_window_offsets(
        torch.as_tensor(case["ws"]), torch.as_tensor(case["wr"]), block_c=block_c,
        cap_tiles=cap_tiles, n_pad=port.flat_rot.shape[0])
    eps, scale, _, _ = t_ops.block_table(port.estimator.table, q_rot.shape[1], block_d)
    qcodes, qscales = quantize_queries_block(q_rot, block_d)
    qn = q_rot.shape[0]
    *_, st, trace = ivf_scan_ref(
        tile_offs, qcodes, q_rot, qscales, torch.full((qn,), float("inf")),
        torch.full((qn, 10), float("inf")), torch.full((qn, 10), -1, dtype=torch.int32),
        port.flat_codes, port.flat_rot, port.flat_ids, port.bscales, eps, scale,
        k=10, block_q=block_q, block_c=block_c, block_d=block_d,
        cap_tiles=cap_tiles, return_trace=True)
    waves = pruned_rows = 0
    for rec in trace:
        i = rec["tile"]
        rows = idx.flat_rot[rec["row_start"]: rec["row_start"] + block_c]
        res = dco_screen_batch(jnp.asarray(case["q_rot"][i * block_q:(i + 1) * block_q]),
                               rows, idx.estimator.table, jnp.asarray(rec["rsq"].numpy()))
        valid = rec["valid"].numpy()[None, :]
        ref_passed = np.asarray(res.passed) & valid
        fused_passed = rec["passed"].numpy() & valid
        assert np.array_equal(fused_passed, ref_passed), (
            f"passed mismatch at tile={i} probe={rec['probe']} ctile={rec['ctile']}")
        s1_pruned = ~rec["active8"].numpy() & valid
        assert not np.any(s1_pruned & ref_passed)  # no false prunes
        assert rec["fetched"] == (rec["alive"] > 0)
        assert (rec["slabs"] > 0) == (rec["alive"] > 0)
        if not rec["fetched"]:
            assert not np.any(ref_passed)
        waves += 1
        pruned_rows += int(s1_pruned.sum())
    assert waves > 0 and pruned_rows > 0  # the prefilter does real work
    st = st.numpy()
    for i in range(qn // block_q):
        recs = [r for r in trace if r["tile"] == i]
        assert st[i * block_q, 4] == sum(r["slabs"] for r in recs)
        assert st[i * block_q, 5] == sum(1 for r in recs if r["fresh"])
