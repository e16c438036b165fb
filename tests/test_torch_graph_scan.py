"""Port parity for one graph beam-scan wave: ``repro_torch.kernels.ops
.graph_scan_kernel`` and ``ref.graph_scan_ref`` (on CPU tensors, the plain
version of the CUDA kernel) against ``repro.kernels.ops.graph_scan_kernel
(use_ref=True)`` and ``repro.kernels.ref.graph_scan_ref``, and the
wave-by-wave replay of the port's trace against ``dco_screen_batch``.

Ids, ``passed`` sets, every stats column (fetch counters included) and the
returned visited bitmap must be equal; squared distances agree to fp32
rounding of the stage-2 dot products, which sum in another order (relative
1e-6 of the squared norms involved).  The CUDA kernel itself is held
against the same plain version on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_graph  # noqa: E402
from repro.core.dco import dco_screen_batch  # noqa: E402
from repro.index.graph import build_graph  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.ref import graph_scan_ref as j_graph_scan_ref  # noqa: E402
from repro.quant.scalar import quantize_queries_block as j_quantize  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402
from repro_torch.kernels.ref import graph_scan_ref  # noqa: E402
from repro_torch.quant.scalar import quantize_queries_block  # noqa: E402

T = torch.as_tensor


def _assert_same_wave(port, ref, norm_sq):
    p_sq, p_ids, p_st, p_vis = (a.numpy() for a in port)
    r_sq, r_ids, r_st, r_vis = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_st, r_st)
    np.testing.assert_array_equal(p_vis, r_vis)
    fin = np.isfinite(r_sq)
    np.testing.assert_array_equal(np.isfinite(p_sq), fin)
    # qn + cn - 2 q·c in float32, summed in another order.
    np.testing.assert_allclose(p_sq[fin], r_sq[fin], rtol=1e-6,
                               atol=1e-6 * norm_sq)


_GRAPHS = {}


def _graph(n, d, bf16):
    """A small reference-built int8 graph (memoised per shape)."""
    key = (n, d, bf16)
    if key not in _GRAPHS:
        rng = np.random.default_rng(n + d)
        data = (rng.standard_normal((n, d)) * np.exp(-0.05 * np.arange(d))
                ).astype(np.float32)
        _GRAPHS[key] = build_graph(
            data, m=10, ef_construction=24, delta_d=8, quant="int8",
            adj_dtype="bfloat16" if bf16 else "float32")
    return _GRAPHS[key]


def _wave_case(seed, qn, d, ef, steps, *, bf16=False, n=300, fill=1):
    """Random frontier offsets with -1 gaps, a repeat across them, and a
    partly filled carried-in window."""
    g = _graph(n, d, bf16)
    rng = np.random.default_rng(seed)
    rot = np.asarray(g.corpus_rot)
    q = rot[:qn] + 0.02 * rng.standard_normal((qn, d)).astype(np.float32)
    q_tiles = (qn + 7) // 8
    offs = rng.integers(0, n, (q_tiles, steps)).astype(np.int32)
    offs[rng.random((q_tiles, steps)) < 0.3] = -1
    offs[:, 1] = -1
    offs[:, 2] = offs[:, 0]  # the same tile again, across a gap step
    offs[:, steps - 1] = offs[:, 0]
    top_sq = np.full((qn, ef), np.inf, np.float32)
    top_ids = np.full((qn, ef), -1, np.int32)
    for j in range(min(fill, ef)):
        nodes = rng.integers(0, n, qn)
        top_sq[:, j] = np.sum((rot[nodes] - q) ** 2, axis=1)
        top_ids[:, j] = nodes
    r0 = np.full((qn,), np.inf, np.float32)
    r0[1] = np.quantile(np.sum((rot[None] - q[:, None]) ** 2, -1)[1], 0.1)
    return g, q, offs, top_sq, top_ids, r0


@pytest.mark.parametrize("qn,d,ef,steps,tighten,bf16,vis_base,thresh", [
    (12, 64, 16, 5, True, False, 0, None),    # Q not a tile multiple
    (16, 40, 7, 3, True, False, 0, 2),        # nothing aligned, thresh_col k-1
    (16, 96, 32, 8, False, False, 0, None),   # frozen threshold
    (9, 64, 1, 4, True, True, 0, None),       # bf16 rows, EF 1
    (24, 64, 48, 6, True, False, 45, 9),      # vis_base != 0, decoupled col
])
def test_graph_wave_matches_reference(qn, d, ef, steps, tighten, bf16, vis_base,
                                      thresh):
    g, q, offs, top_sq, top_ids, r0 = _wave_case(qn + ef, qn, d, ef, steps,
                                                 bf16=bf16, fill=min(3, ef))
    n = g.corpus_rot.shape[0]
    vis_nodes = n + vis_base + 7
    # A carried-in bitmap with bits set, bit 31 of a word among them.
    words = j_ops.graph_vis_words(vis_nodes)
    vis0 = np.zeros(((qn + 7) // 8, words), np.uint32)
    vis0[:, 0] = 0x80000001
    vis0[:, 3] = 1 << 31
    vis0 = vis0.view(np.int32)
    kw = dict(ef=ef, thresh_col=thresh, block_q=8, block_c=g.adj_block,
              block_d=g.scan_block_d, tighten=tighten, vis_base=vis_base,
              vis_nodes=vis_nodes)
    ref = j_ops.graph_scan_kernel(
        g.estimator, jnp.asarray(q), jnp.asarray(offs), jnp.asarray(top_sq),
        jnp.asarray(top_ids), jnp.asarray(r0), g.adj_rot, g.adj_codes,
        g.adj_ids, g.gscales, jnp.asarray(vis0), use_ref=True, **kw)
    port = carry_graph(g)
    before = graph_scan_kernel_call.launches
    out = t_ops.graph_scan_kernel(
        port.estimator, T(q), T(offs), T(top_sq), T(top_ids), T(r0), port.adj_rot,
        port.adj_codes, port.adj_ids, port.gscales, T(vis0), **kw)
    assert graph_scan_kernel_call.launches == before  # CPU tensors: plain path
    _assert_same_wave(out, ref, float((q * q).sum(1).max()) * 4.0)
    st = out[2].numpy()
    assert st[:, 0].sum() > 0 and st[:, 3].sum() > 0  # real two-stage work
    # The bitmap holds the carried bits plus exactly each tile's real steps.
    exp = t_ops.unpack_vis(out[3], vis_nodes)
    carried = t_ops.unpack_vis(T(vis0), vis_nodes)
    for t in range(offs.shape[0]):
        want = carried[t].copy()
        want[offs[t][offs[t] >= 0] + vis_base] = True
        np.testing.assert_array_equal(exp[t], want)


@pytest.mark.parametrize("tighten", [True, False])
def test_plain_version_matches_reference_oracle(tighten):
    """``ref.graph_scan_ref`` against ``repro.kernels.ref.graph_scan_ref``
    on identical padded inputs (the reference's own quantized queries)."""
    g, q, offs, top_sq, top_ids, r0 = _wave_case(5, 16, 64, 24, 6, fill=2)
    est = g.estimator
    eps, scale, d_pad, _ = j_ops.block_table(est.table, 64, g.scan_block_d)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, d_pad - 64))))
    qcodes, qscales = j_quantize(qp, g.scan_block_d)
    n = g.corpus_rot.shape[0]
    vis0 = np.zeros((2, j_ops.graph_vis_words(n)), np.int32)
    kw = dict(ef=24, thresh_col=9, block_q=8, block_c=g.adj_block,
              block_d=g.scan_block_d, tighten=tighten)
    ref = j_graph_scan_ref(
        jnp.asarray(offs), qcodes, qp, qscales, jnp.asarray(top_sq),
        jnp.asarray(top_ids), jnp.asarray(r0), jnp.asarray(vis0), g.adj_codes,
        g.adj_rot, g.adj_ids, g.gscales, eps, scale, **kw)
    A = lambda a: T(np.asarray(a))  # noqa: E731
    out = graph_scan_ref(
        A(offs), A(qcodes), A(qp), A(qscales), A(top_sq), A(top_ids), A(r0),
        A(vis0), A(g.adj_codes), A(g.adj_rot), A(g.adj_ids), A(g.gscales),
        A(eps), A(scale), **kw)
    _assert_same_wave(out, ref, float((q * q).sum(1).max()) * 4.0)


def test_wrapper_refuses_mixed_devices_and_bad_offsets():
    g, q, offs, top_sq, top_ids, r0 = _wave_case(3, 8, 40, 8, 3)
    port = carry_graph(g)
    n = g.corpus_rot.shape[0]
    bad = offs.copy()
    bad[0, 0] = n
    with pytest.raises(ValueError, match="step offsets"):
        t_ops.graph_scan_kernel(
            port.estimator, T(q), T(bad), T(top_sq), T(top_ids), T(r0),
            port.adj_rot, port.adj_codes, port.adj_ids, port.gscales, ef=8,
            block_c=g.adj_block, block_d=g.scan_block_d)
    args, kw = t_ops.graph_scan_inputs(
        port.estimator, T(q), T(offs), T(top_sq), T(top_ids), T(r0),
        port.adj_rot, port.adj_codes, port.adj_ids, port.gscales, ef=8,
        block_c=g.adj_block, block_d=g.scan_block_d)
    args = list(args)
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        graph_scan_kernel_call(*args, **kw)
    with pytest.raises(ValueError, match="vis_base=300"):
        t_ops.graph_scan_kernel(
            port.estimator, T(q), T(offs), T(top_sq), T(top_ids), T(r0),
            port.adj_rot, port.adj_codes, port.adj_ids, port.gscales,
            vis_base=300, vis_nodes=n, ef=8, block_c=g.adj_block,
            block_d=g.scan_block_d)


def test_wave_replay_passed_parity_and_soundness(graph_idx, queries):
    """Replays every real step of the port's trace against
    ``dco_screen_batch`` at the same frozen r²: the ``passed`` sets are
    identical, no stage-1-pruned row passes the fp32 screen, a step is
    fetched iff it has a valid stage-1 survivor, the bitmap holds exactly
    the trace's marks, and the fetch counter follows the cross-gap reuse
    rule."""
    sub, g = graph_idx
    port = carry_graph(g)
    block_q, ef = 8, 24
    q_rot = np.asarray(g.estimator.rotate(jnp.asarray(queries)))
    qn, dim = q_rot.shape
    q_tiles = qn // block_q
    n = sub.shape[0]
    rng = np.random.default_rng(0)
    offs = rng.integers(0, n, (q_tiles, 7)).astype(np.int32)
    offs[:, 4:6] = -1
    offs[:, 6] = offs[:, 3]  # a revisit across the gap: no second fetch
    rot = np.asarray(g.corpus_rot)
    entry = int(g.entry)
    top_sq = np.full((qn, ef), np.inf, np.float32)
    top_ids = np.full((qn, ef), -1, np.int32)
    top_sq[:, 0] = np.sum((rot[entry] - q_rot) ** 2, axis=1)
    top_ids[:, 0] = entry
    eps, scale, d_pad, _ = t_ops.block_table(port.estimator.table, dim, g.scan_block_d)
    qp = torch.nn.functional.pad(T(q_rot), (0, d_pad - dim))
    qcodes, qscales = quantize_queries_block(qp, g.scan_block_d)
    vis0 = torch.zeros((q_tiles, t_ops.graph_vis_words(n)), dtype=torch.int32)
    *out, trace = graph_scan_ref(
        T(offs), qcodes, qp, qscales, T(top_sq), T(top_ids),
        torch.full((qn,), float("inf")), vis0, port.adj_codes, port.adj_rot,
        port.adj_ids, port.gscales, eps, scale, ef=ef, block_q=block_q,
        block_c=g.adj_block, block_d=g.scan_block_d, return_trace=True)

    pruned_rows = 0
    for rec in trace:
        i = rec["tile"]
        rows = g.adj_rot[rec["row_start"]: rec["row_start"] + g.adj_block]
        res = dco_screen_batch(jnp.asarray(qp[i * block_q:(i + 1) * block_q].numpy()),
                               rows, g.estimator.table, jnp.asarray(rec["rsq"].numpy()))
        valid = rec["valid"].numpy()[None, :]
        ref_passed = np.asarray(res.passed) & valid
        fused_passed = rec["passed"].numpy() & valid
        assert np.array_equal(fused_passed, ref_passed), (
            f"passed mismatch at tile={i} step={rec['step']}")
        s1_pruned = ~rec["active8"].numpy() & valid
        assert not np.any(s1_pruned & ref_passed)  # no false prunes
        assert rec["fetched"] == (rec["alive"] > 0)
        pruned_rows += int(s1_pruned.sum())
    assert len(trace) == int((offs >= 0).sum()) and pruned_rows > 0

    exp = t_ops.unpack_vis(out[3], n)
    st = out[2].numpy()
    for t in range(q_tiles):
        marked = {r["marked"] for r in trace if r["tile"] == t}
        assert set(np.flatnonzero(exp[t]).tolist()) == marked
        real = offs[t][offs[t] >= 0]
        landed = 1 + int(np.sum(real[1:] != real[:-1]))
        assert st[t * block_q, 5] == landed == len(real) - 1
