"""The flat serving route's fused scan at the query-tile widths it runs
(8 and 16, the CUDA kernel's; 32, the reference's on its TPU), and split
into segments (``ivf_scan_kernel_call(segments=G)``,
``build_search_step(shards=G)``), on CPU tensors (the plain version).

  * (a) per-query results do not depend on the width: ids, squared
    distances and stats columns 0-3 at block_q 8 and at every other width
    are equal, bit for bit (the plain version runs the same float
    operations per pair whatever the tile);
  * (b) at each width the port equals the JAX package's
    ``repro.kernels.ref.ivf_scan_ref`` at the same block_q: ids and all six
    stats columns equal, fetch counters included; squared distances to fp32
    rounding (the port sums stage 2 in dimension order, the reference in
    its matmul's: relative 1e-6 plus 1e-6 of the largest squared norms);
  * (c) a split walk equals the reference's sharded step given the same
    r0: ``ivf_scan_ref`` per segment from an empty window, the windows
    merged by ``jax.lax.top_k`` over the (Q, G·K) concatenation in segment
    order, the stats summed; same tolerances, with ROADMAP queue 3's
    near-tie rule for the ids (an id may differ only where the two
    distances at that position agree to that tolerance);
  * (d) ``build_search_step(shards=G)`` is the reference's G-shard step,
    run on a G-device CPU mesh in a subprocess at the serving test's
    size (G = 1, 2, 4): each segment seeds from the first wave of its own
    run and the seeds' minimum starts them all, as the reference takes
    the ``pmin`` of its shards' seeds; ids, stats columns 0-3 and (from
    the reference's oracle at the port's width) 4-5 equal, distances to
    fp32 rounding.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build_estimator  # noqa: E402
from repro.data.pipeline import synthetic_queries, synthetic_vectors  # noqa: E402
from repro.kernels.ops import block_table  # noqa: E402
from repro.kernels.ref import ivf_scan_ref as j_ivf_scan_ref  # noqa: E402
from repro.quant import fit_block_scales, quantize_block  # noqa: E402
from repro.quant.scalar import quantize_queries_block as j_quantize_queries  # noqa: E402
from repro_torch.configs.dade_ivf import ServiceConfig  # noqa: E402
from repro_torch.kernels.ivf_scan import (  # noqa: E402
    KERNEL_BLOCK_QS, KERNEL_TILE, ivf_scan_kernel_call, merge_segments, split_segments)
from repro_torch.core.estimators import SEED_SLACK, first_enabled_eps  # noqa: E402
from repro_torch.launch.annservice import (  # noqa: E402
    FUSED_BLOCK_Q, build_search_step, seed_rsq)

ROOT = Path(__file__).resolve().parents[1]

N, DIM, BD, WAVE, BC, K, Q = 4096, 64, 16, 512, 128, 10, 32
P, CAP = N // WAVE, WAVE // BC
WIDTH = KERNEL_TILE[0]
# The plain version takes any width: the CUDA kernel's and the reference's
# own TPU width (``block_q = 32 if on_tpu() else 8`` in its annservice).
WIDTHS = tuple(sorted(set(KERNEL_BLOCK_QS) | {32}))


@pytest.fixture(scope="module")
def flat():
    corpus = synthetic_vectors(N, DIM, seed=0)
    queries = synthetic_queries(Q, DIM, corpus, seed=1)
    est = build_estimator("dade", corpus, jax.random.PRNGKey(0), p_s=0.02, delta_d=BD)
    eps, scale, _, _ = block_table(est.table, DIM, BD)
    c_rot = np.asarray(est.rotate(jnp.asarray(corpus)))
    q_rot = np.asarray(est.rotate(jnp.asarray(queries)))
    bscales = fit_block_scales(jnp.asarray(c_rot), BD)
    codes = quantize_block(jnp.asarray(c_rot), bscales, BD)
    qcodes, qscales = j_quantize_queries(jnp.asarray(q_rot), BD)
    # r0: each query's 100th smallest exact distance over the first wave,
    # loose enough that every wave screens survivors.
    d2 = ((q_rot[:, None, :] - c_rot[None, :WAVE]) ** 2).sum(-1)
    r0 = np.sort(d2, axis=1)[:, 100].astype(np.float32)
    arrays = dict(qcodes=qcodes, q_rot=q_rot, qscales=qscales, r0=r0,
                  top0_sq=np.full((Q, K), np.inf, np.float32),
                  top0_ids=np.full((Q, K), -1, np.int32), codes=codes, rows=c_rot,
                  ids=np.arange(N, dtype=np.int32), bscales=bscales, eps=eps,
                  scale=scale)
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    return dict(arrays=arrays, norm_sq=float((q_rot * q_rot).sum(1).max()) * 4.0,
                corpus=corpus, c_rot=c_rot, q_rot=q_rot, codes=np.asarray(codes),
                bscales=np.asarray(bscales), eps=np.asarray(eps), scale=np.asarray(scale))


def _offs(block_q, waves=P):
    """The flat route's step table: every query tile walks every tile."""
    table = np.arange(waves * CAP, dtype=np.int32).reshape(1, waves, CAP)
    return np.ascontiguousarray(np.broadcast_to(table, (Q // block_q, waves, CAP)))


def _port(flat, block_q, segments=1):
    args = [torch.as_tensor(_offs(block_q))] + [
        torch.as_tensor(a) for a in flat["arrays"].values()]
    return ivf_scan_kernel_call(*args, k=K, block_q=block_q, block_c=BC, block_d=BD,
                                cap_tiles=CAP, segments=segments)


def _reference(flat, block_q, offs):
    a = flat["arrays"]
    return j_ivf_scan_ref(jnp.asarray(offs), *(jnp.asarray(v) for v in a.values()),
                          k=K, block_q=block_q, block_c=BC, block_d=BD, cap_tiles=CAP)


def _assert_close_scan(port, ref_sq, ref_ids, ref_st, norm_sq):
    p_sq, p_ids, p_st = (a.numpy() for a in port)
    r_sq, r_ids, r_st = (np.asarray(a) for a in (ref_sq, ref_ids, ref_st))
    np.testing.assert_array_equal(p_st, r_st)
    fin = np.isfinite(r_sq)
    np.testing.assert_array_equal(np.isfinite(p_sq), fin)
    tol = 1e-6 * np.abs(r_sq) + 1e-6 * norm_sq
    np.testing.assert_array_less(np.abs(p_sq[fin] - r_sq[fin]), tol[fin] + 1e-30)
    # Near-tie rule: an id may differ only where the distances tie to fp32
    # rounding (two candidates swap places).
    diff = p_ids != r_ids
    assert np.all(fin[diff] & (np.abs(p_sq - r_sq) <= tol)[diff])
    assert diff.sum() <= 2 * Q * 0.01 + 2  # a swap or two, not a different window


@pytest.mark.parametrize("block_q", [b for b in WIDTHS if b != 8])
def test_block_q_leaves_per_query_results(flat, block_q):
    """(a) On the flat route's table the width changes only the tile-level
    fetch counters (stats columns 4-5); everything per query is bit-equal."""
    sq8, ids8, st8 = _port(flat, 8)
    sq, ids, st = _port(flat, block_q)
    assert torch.equal(ids, ids8)
    assert torch.equal(sq, sq8)
    assert torch.equal(st[:, :4], st8[:, :4])
    assert float(st8[:, 3].sum()) > 0  # survivors reach the windows
    # A wider tile fetches a step's slab when any of its 8-query parts
    # would: per tile, at least the most and at most the sum of its parts'.
    parts = st8[::8, 4].reshape(-1, block_q // 8)
    wide = st[::block_q, 4]
    assert bool((wide >= parts.amax(1)).all()) and bool((wide <= parts.sum(1)).all())
    assert torch.equal(st[::block_q, 5], st8[::8, 5][:: block_q // 8])


@pytest.mark.parametrize("block_q", WIDTHS)
def test_width_matches_reference(flat, block_q):
    """(b) The port's plain version at each width equals the reference's
    oracle at the same block_q, fetch counters as the reference counts them."""
    ref = _reference(flat, block_q, _offs(block_q))
    _assert_close_scan(_port(flat, block_q), *ref, flat["norm_sq"])


@pytest.mark.parametrize("segments", [2, 4])
def test_split_matches_reference_shards(flat, segments):
    """(c) Segments of one walk = the reference's shards from an empty window
    and the same r0, merged by ``lax.top_k`` in segment order, stats summed."""
    offs = _offs(WIDTH)
    per = P // segments
    parts = [_reference(flat, WIDTH, offs[:, g * per:(g + 1) * per]) for g in range(segments)]
    all_sq = jnp.concatenate([p[0] for p in parts], axis=1)
    all_ids = jnp.concatenate([p[1] for p in parts], axis=1)
    neg, idx = jax.lax.top_k(-all_sq, K)
    ids = jnp.take_along_axis(all_ids, idx, axis=1)
    st = np.sum([np.asarray(p[2], np.float64) for p in parts], axis=0).astype(np.float32)
    out = _port(flat, WIDTH, segments)
    _assert_close_scan(out, -neg, ids, st, flat["norm_sq"])
    # Later segments start from r0, not from the earlier segments' windows:
    # they screen more (stage-2 slabs) than the one walk does.
    one = _port(flat, WIDTH)
    assert float(out[2][:, 1].sum()) >= float(one[2][:, 1].sum())


def test_split_segments_pads_the_last_run_with_gap_waves():
    offs = torch.as_tensor(_offs(8, waves=7))
    split = split_segments(offs, 3)
    assert tuple(split.shape) == (3 * Q // 8, 3, CAP)
    assert torch.equal(split[: Q // 8], offs[:, :3])
    assert torch.equal(split[Q // 8: 2 * Q // 8], offs[:, 3:6])
    assert torch.equal(split[2 * Q // 8:, 0], offs[:, 6])
    assert bool((split[2 * Q // 8:, 1:] == -1).all())


def test_merge_segments_breaks_ties_by_segment_order():
    sq = torch.tensor([[1.0, 3.0, float("inf")], [2.0, 3.0, 4.0]])  # segment 0, 1
    ids = torch.tensor([[10, 11, -1], [20, 21, 22]], dtype=torch.int32)
    st = torch.tensor([[1.0] * 6, [2.0] * 6])
    m_sq, m_ids, m_st = merge_segments(sq, ids, st, 2, 3)
    assert m_sq.tolist() == [[1.0, 2.0, 3.0]]
    assert m_ids.tolist() == [[10, 20, 11]]  # the tie at 3.0: segment 0 first
    assert m_st.tolist() == [[3.0] * 6]


def test_split_refuses_a_seeded_window(flat):
    args = [torch.as_tensor(_offs(8))] + [torch.as_tensor(a) for a in flat["arrays"].values()]
    args[6] = args[6].clone()
    args[6][0, 0] = 5
    with pytest.raises(ValueError, match="empty window"):
        ivf_scan_kernel_call(*args, k=K, block_q=8, block_c=BC, block_d=BD,
                             cap_tiles=CAP, segments=2)


# The reference's G-shard step, run on a G-device CPU mesh in a subprocess
# (the test process keeps one device): the inputs come in and the results
# go out as .npz files.
_REF_SHARDS = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.configs.dade_ivf import ServiceConfig
    from repro.launch.annservice import build_search_step, search_input_specs

    a = dict(np.load(sys.argv[1]))
    small = {small!r}
    out = {{}}
    kw = ({{"axis_types": (jax.sharding.AxisType.Auto,)}}
          if hasattr(jax.sharding, "AxisType") else {{}})
    for g in {shards!r}:
        mesh = jax.make_mesh((g,), ("data",), devices=jax.devices()[:g], **kw)
        svc = ServiceConfig(quant="int8", **dict(
            small, corpus_per_device=small["corpus_per_device"] // g))
        _, sh = search_input_specs(svc, mesh, quant="int8", fused=True)
        step = jax.jit(build_search_step(svc, mesh, quant="int8", fused=True,
                                         with_stats=True), in_shardings=sh)
        d, i, scan = step(jax.device_put(a["c_rot"], sh[0]),
                          jax.device_put(a["codes"], sh[1]),
                          jax.device_put(a["bscales"], sh[2]), a["q_rot"],
                          a["eps"], a["scale"], a["eps_lo"])
        out[f"d{{g}}"], out[f"i{{g}}"], out[f"scan{{g}}"] = (
            np.asarray(d), np.asarray(i), np.asarray(scan, np.float64))
    np.savez(sys.argv[2], **out)
""")
SMALL = dict(corpus_per_device=2048, dim=64, query_batch=16, k=10, delta_d=16,
             wave=256, p_s=0.02, dtype="float32")
SHARD_COUNTS = (1, 2, 4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The serving test's inputs (``tests/test_torch_serve.py``'s SMALL
    size) and the reference's step on them at every shard count."""
    corpus = synthetic_vectors(SMALL["corpus_per_device"], SMALL["dim"], seed=0)
    queries = synthetic_queries(SMALL["query_batch"], SMALL["dim"], corpus, seed=1)
    est = build_estimator("dade", corpus, jax.random.PRNGKey(0), p_s=0.02, delta_d=16)
    eps, scale, _, eps_lo = block_table(est.table, SMALL["dim"], 16)
    c_rot = np.asarray(est.rotate(jnp.asarray(corpus)))
    q_rot = np.asarray(est.rotate(jnp.asarray(queries)))
    bscales = fit_block_scales(jnp.asarray(c_rot), 16)
    codes = quantize_block(jnp.asarray(c_rot), bscales, 16)
    arrays = {name: np.asarray(a) for name, a in dict(
        c_rot=c_rot, codes=codes, bscales=bscales, q_rot=q_rot, eps=eps,
        scale=scale, eps_lo=eps_lo).items()}
    tmp = tmp_path_factory.mktemp("shards")
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REF_SHARDS.format(small=SMALL, shards=SHARD_COUNTS)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return arrays, dict(np.load(tmp / "out.npz"))


def _reference_fetch_counters(arrays, r0, shards, block_q):
    """Stats columns 4-5 of the G-shard step counted by the reference's
    oracle at query-tile width ``block_q``: each shard's run of waves from
    ``r0`` with an empty window, the counters summed over shards."""
    svc = ServiceConfig(**SMALL)
    q = svc.query_batch
    qcodes, qscales = j_quantize_queries(jnp.asarray(arrays["q_rot"]), svc.delta_d)
    cap = svc.wave // BC
    per = svc.corpus_per_device // svc.wave // shards
    total = np.zeros(2)
    for g in range(shards):
        tiles = np.arange(g * per * cap, (g + 1) * per * cap, dtype=np.int32)
        offs = np.broadcast_to(tiles.reshape(1, per, cap), (q // block_q, per, cap))
        _, _, st = j_ivf_scan_ref(
            jnp.asarray(offs), qcodes, jnp.asarray(arrays["q_rot"]), qscales,
            jnp.asarray(r0), jnp.full((q, svc.k), jnp.inf, jnp.float32),
            jnp.full((q, svc.k), -1, jnp.int32), jnp.asarray(arrays["codes"]),
            jnp.asarray(arrays["c_rot"]),
            jnp.arange(svc.corpus_per_device, dtype=jnp.int32),
            jnp.asarray(arrays["bscales"]), jnp.asarray(arrays["eps"]),
            jnp.asarray(arrays["scale"]), k=svc.k, block_q=block_q, block_c=BC,
            block_d=svc.delta_d, cap_tiles=cap)
        total += np.asarray(st, np.float64)[::block_q, 4:].sum(0)
    return total


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_search_step_shards_match_split_scan(served, shards):
    """``build_search_step(shards=G)`` is the reference's G-shard step: the
    same ids, stats columns 0-3 summed over shards equal, distances to fp32
    rounding; the fetch counters (4-5) equal the reference's oracle's at the
    port's query-tile width over the same shards from the same seed."""
    arrays, ref = served
    T = torch.as_tensor
    step = build_search_step(ServiceConfig(**SMALL), with_stats=True, shards=shards)
    d, ids, scan = step(*(T(arrays[n]) for n in ("c_rot", "codes", "bscales", "q_rot",
                                                 "eps", "scale", "eps_lo")))
    np.testing.assert_array_equal(ids.numpy(), ref[f"i{shards}"])
    np.testing.assert_allclose(d.numpy(), ref[f"d{shards}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(scan.numpy()[:4], ref[f"scan{shards}"][:4])
    r0 = seed_rsq(ServiceConfig(**SMALL), T(arrays["c_rot"]), T(arrays["q_rot"]),
                  T(arrays["eps"]), segments=shards).numpy()
    np.testing.assert_array_equal(scan.numpy()[4:], _reference_fetch_counters(
        arrays, r0, shards, FUSED_BLOCK_Q))
    assert float(scan[3]) > 0


def test_seed_takes_the_segments_minimum(served):
    """One segment seeds as the step always did (from the corpus's first
    wave, bit for bit); G segments take the minimum of their own first
    waves' seeds, so their r0 is never looser."""
    arrays, _ = served
    svc = ServiceConfig(**SMALL)
    c, q, eps = (torch.as_tensor(arrays[n]) for n in ("c_rot", "q_rot", "eps"))
    sample = c[: svc.wave]
    qb, cb = q[:, : svc.delta_d], sample[:, : svc.delta_d]
    est0 = (torch.sum(qb * qb, 1)[:, None] + torch.sum(cb * cb, 1)[None, :]
            - 2.0 * (qb @ cb.T))
    idx = torch.topk(est0, svc.k, dim=1, largest=False).indices
    diff = sample[idx] - q[:, None, :]
    t = 1.0 + first_enabled_eps(eps)
    before = torch.amax(torch.sum(diff * diff, -1), 1) * (t * t) * (1.0 + SEED_SLACK)
    one = seed_rsq(svc, c, q, eps)
    assert torch.equal(one, before)
    for g in SHARD_COUNTS[1:]:
        per = svc.corpus_per_device // svc.wave // g
        parts = [seed_rsq(svc, c[s * per * svc.wave:], q, eps)
                 for s in range(g)]
        split = seed_rsq(svc, c, q, eps, segments=g)
        assert torch.equal(split, torch.stack(parts).amin(0))
        assert bool((split <= one).all()) and bool((split < one).any())
