"""The CUDA ``ivf_scan`` (every query-tile width, split into segments),
``graph_scan`` (one wave, and the whole walk of a search), ``dade_dco``,
``quant_dco`` and ``l2_scan`` kernels against their plain PyTorch versions
on the card, bit for bit, the
repeatability of an IVF build there, the continuous engines against each
query's solo search (the walk kernel and the plain walk for the graph, the
fused scan for IVF), and the tracer's fence (needs no JAX, so it runs
where only the port is installed).

Marked ``gpu``: they skip by name where ``torch.cuda.is_available()`` is
false, since a CUDA kernel has no CPU mode.  On the card:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402
from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call, ivf_scan_plain  # noqa: E402
from repro_torch.kernels.ref import graph_scan_ref, ivf_scan_ref  # noqa: E402
from repro_torch.quant.scalar import (  # noqa: E402
    fit_block_scales, quantize_block, quantize_queries_block)


def _case(k, block_q, bf16, seed=0, n_rows=2048, dim=128, block_d=32, block_c=128, qn=16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    scales = torch.exp(-0.03 * torch.arange(dim, device="cuda"))
    rows = torch.randn((n_rows, dim), generator=g, device="cuda") * scales
    ids = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    ids[-block_c:] = -1
    bs = fit_block_scales(rows, block_d)
    codes = quantize_block(rows, bs, block_d)
    q = rows[:qn] + 0.1 * torch.randn((qn, dim), generator=g, device="cuda") * scales
    starts = torch.tensor([[0, 700, 1400, 700]] * (qn // block_q), device="cuda")
    sizes = torch.tensor([[600, 300, 500, 300]] * (qn // block_q), device="cuda")
    cap = ops.ivf_cap_tiles(600, block_c, starts_aligned=False)
    offs = ops.build_window_offsets(starts, sizes, block_c=block_c, cap_tiles=cap,
                                    n_pad=n_rows)
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    r0 = torch.full((qn,), float("inf"), device="cuda")
    args = (offs, qcodes, q, qscales, r0, torch.full((qn, k), float("inf"), device="cuda"),
            torch.full((qn, k), -1, dtype=torch.int32, device="cuda"), codes,
            rows.to(torch.bfloat16) if bf16 else rows, ids, bs,
            torch.linspace(0.3, 0.0, s, device="cuda"),
            torch.linspace(float(s), 1.0, s, device="cuda"))
    return args, dict(k=k, block_q=block_q, block_c=block_c, block_d=block_d,
                      cap_tiles=cap)


@pytest.mark.gpu
@pytest.mark.parametrize("k,block_q,bf16", [(1, 8, False), (10, 8, True), (100, 8, False)])
def test_cuda_kernel_matches_plain_version(k, block_q, bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ivf_scan kernel has no CPU mode")
    args, kw = _case(k, block_q, bf16)
    before = ivf_scan_kernel_call.launches
    sq_k, ids_k, st_k = ivf_scan_kernel_call(*args, **kw)
    sq_p, ids_p, st_p = ivf_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    assert ivf_scan_kernel_call.launches == before + 1
    assert torch.equal(st_k, st_p)
    assert torch.equal(ids_k, ids_p)
    # Both round every float operation alike, in the same order.
    assert torch.equal(sq_k, sq_p)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [1, 2, 8])
@pytest.mark.parametrize("block_q,bf16", [(8, True), (16, False), (16, True)])
def test_cuda_split_scan_matches_plain_version(segments, block_q, bf16):
    """The walk split into 1, 2 or 8 segments (4 probes: with 8, some
    segments are all gaps), at each query-tile width, against the plain
    version's split walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ivf_scan kernel has no CPU mode")
    args, kw = _case(100, block_q, bf16, seed=segments, qn=32)
    before = ivf_scan_kernel_call.launches
    out_k = ivf_scan_kernel_call(*args, **kw, segments=segments)
    out_p = ivf_scan_plain(*args, **kw, segments=segments)
    torch.cuda.synchronize()
    assert ivf_scan_kernel_call.launches == before + 1
    for a, b in zip(out_k, out_p):  # window, ids, stats: bit for bit
        assert torch.equal(a, b)
    assert float(out_k[2][:, 3].sum()) > 0


def _graph_case(ef, bf16, tighten, thresh_col, seed=0, n_nodes=600, dim=128,
                block_d=32, vis_base=0):
    """A hand-made adjacency-flat slab (32-row blocks, 16 real neighbours
    each, sentinel pad rows), step tables with -1 gaps and a repeat across
    them, a partly filled window and a carried bitmap with bit 31 set."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scales = torch.exp(-0.03 * torch.arange(dim, device="cuda"))
    base = torch.randn((n_nodes, dim), generator=g, device="cuda") * scales
    nbrs = torch.randint(0, n_nodes, (n_nodes, 16), generator=g, device="cuda")
    rows = torch.full((n_nodes, 32, dim), 1e18, device="cuda")
    rows[:, :16] = base[nbrs]
    ids = torch.full((n_nodes, 32), -1, dtype=torch.int32, device="cuda")
    ids[:, :16] = nbrs.to(torch.int32)
    bs = fit_block_scales(base, block_d)
    codes = torch.zeros((n_nodes, 32, dim), dtype=torch.int8, device="cuda")
    codes[:, :16] = quantize_block(base, bs, block_d)[nbrs]
    qn = 16
    q = base[:qn] + 0.1 * torch.randn((qn, dim), generator=g, device="cuda") * scales
    offs = torch.randint(0, n_nodes, (2, 8), generator=g, device="cuda").to(torch.int32)
    offs[:, 1] = -1
    offs[:, 2] = offs[:, 0]
    offs[:, 6:] = -1
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    top0_sq = torch.full((qn, ef), float("inf"), device="cuda")
    top0_ids = torch.full((qn, ef), -1, dtype=torch.int32, device="cuda")
    top0_sq[:, 0] = ((base[7] - q) ** 2).sum(1)
    top0_ids[:, 0] = 7
    words = ops.graph_vis_words(n_nodes + vis_base)
    vis0 = torch.zeros((2, words), dtype=torch.int32, device="cuda")
    vis0[:, 0] = -(1 << 31)  # bit 31 only
    args = (offs, qcodes, q, qscales, top0_sq, top0_ids,
            torch.full((qn,), float("inf"), device="cuda"), vis0,
            codes.reshape(-1, dim), (rows.to(torch.bfloat16) if bf16 else rows).reshape(-1, dim),
            ids.reshape(-1), bs, torch.linspace(0.3, 0.0, s, device="cuda"),
            torch.linspace(float(s), 1.0, s, device="cuda"), vis_base)
    return args, dict(ef=ef, thresh_col=thresh_col, block_q=8, block_c=32,
                      block_d=block_d, tighten=tighten)


@pytest.mark.gpu
@pytest.mark.parametrize("ef,bf16,tighten,thresh_col,vis_base", [
    (1, False, True, None, 0), (48, True, True, 9, 0), (128, False, False, None, 40)])
def test_cuda_graph_kernel_matches_plain_version(ef, bf16, tighten, thresh_col, vis_base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph_scan kernel has no CPU mode")
    args, kw = _graph_case(ef, bf16, tighten, thresh_col, vis_base=vis_base)
    before = graph_scan_kernel_call.launches
    out_k = graph_scan_kernel_call(*args, **kw)
    out_p = graph_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    assert graph_scan_kernel_call.launches == before + 1
    for a, b in zip(out_k, out_p):  # window, ids, stats, bitmap: bit for bit
        assert torch.equal(a, b)
    assert float(out_k[2][:, 3].sum()) > 0


# The walk cases: search settings beside (k=10, ef=48, expand=2, no seed,
# decoupled, route_mult 1, at most 64 waves), on f32 or bf16 rows.
_WALK_CASES = {
    "defaults": {}, "seed_r": dict(seed_r=True), "coupled": dict(decoupled=False, ef=32),
    "route_mult": dict(route_mult=1.2), "bf16": dict(bf16=True),
    "max_waves": dict(max_waves=3),
}


@pytest.fixture(scope="module")
def walk_graph():
    """An NSW graph of 1500 rows x 64 dims on the card (Δd 32) and 77
    queries: 10 query tiles, the last with 3 pad rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph_walk kernel has no CPU mode")
    from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
    from repro_torch.index.graph import build_graph

    corpus = synthetic_vectors(1500, 64, seed=0)
    index = build_graph(corpus, m=12, ef_construction=48, delta_d=32, device="cuda")
    return index, synthetic_queries(77, 64, corpus, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_WALK_CASES))
def test_cuda_graph_walk_matches_plain_walk(walk_graph, case):
    """One launch walks the whole search as ``ref.graph_walk_ref`` does:
    the window, every wave's stats rows, the bitmap and each tile's wave
    count, bit for bit."""
    import dataclasses

    from repro_torch.index.graph import walk_inputs
    from repro_torch.kernels.graph_scan import graph_walk_kernel_call
    from repro_torch.kernels.ref import graph_walk_ref

    index, queries = walk_graph
    kw = dict(k=10, ef=48, expand=2, block_q=8, max_waves=64, seed_r=False,
              decoupled=True, route_mult=1.0)
    kw.update(_WALK_CASES[case])
    if kw.pop("bf16", False):
        index = dataclasses.replace(index, adj_rot=index.adj_rot.to(torch.bfloat16))
    args, wkw, _ = walk_inputs(index, queries, **kw)
    before = graph_walk_kernel_call.launches
    out_k = graph_walk_kernel_call(*args, **wkw)
    out_p = graph_walk_ref(*args, **wkw)
    torch.cuda.synchronize()
    assert graph_walk_kernel_call.launches == before + 1
    for a, b in zip(out_k, out_p):  # window, ids, stats, bitmap, waves
        assert torch.equal(a, b)
    waves = out_k[4].tolist()
    if case == "max_waves":
        assert max(waves) == 3
    else:  # the tiles converge at different waves, well before the cap
        assert len(set(waves)) > 1 and max(waves) < 64


@pytest.mark.gpu
def test_kmeans_build_repeats_on_the_card():
    """Two IVF builds on the card give identical centroids and buckets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.data.pipeline import synthetic_vectors
    from repro_torch.index.ivf import build_ivf

    data = synthetic_vectors(65536, 64, seed=0)
    a, b = (build_ivf(data, n_clusters=64, delta_d=16, device="cuda") for _ in range(2))
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.flat_ids, b.flat_ids) and torch.equal(a.starts, b.starts)


def _screen_case(seed, dim, n, qn, block_d, method):
    from repro_torch.core.estimators import build_estimator
    from repro_torch.quant.scalar import quantize_corpus

    g = torch.Generator(device="cuda").manual_seed(seed)
    scales = torch.exp(-0.03 * torch.arange(dim, device="cuda"))
    data = torch.randn((2048, dim), generator=g, device="cuda") * scales
    est = build_estimator(method, data, delta_d=32, device="cuda")
    c = est.rotate(data[:n])
    q = est.rotate(data[:qn] + 0.3 * torch.randn((qn, dim), generator=g, device="cuda") * scales)
    r_sq = torch.quantile(torch.cdist(q, c) ** 2, 0.05, dim=1)
    r_sq[0], r_sq[1] = 0.0, 1e30
    return est, q, c, quantize_corpus(c), r_sq


def _bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.is_floating_point:
        return torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(
            a[torch.isfinite(b)], b[torch.isfinite(b)])
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n,qn,block_d,method", [
    (64, 300, 20, 32, "dade"), (200, 333, 17, 64, "adsampling"),
    (384, 150, 5, 128, "fdscanning"), (256, 1000, 40, 64, "dade")])
def test_cuda_screen_kernels_match_plain_versions(dim, n, qn, block_d, method):
    """dade_dco and quant_dco, each bit for bit against its plain version on
    the same padded inputs (ragged tiles, r² = 0 and 1e30, disabled
    checkpoints)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flat screen kernels have no CPU mode")
    from repro_torch.kernels import ops as k_ops
    from repro_torch.kernels.dade_dco import dade_dco_kernel_call
    from repro_torch.kernels.quant_dco import quant_dco_kernel_call

    est, q, c, qc, r_sq = _screen_case(dim, dim, n, qn, block_d, method)
    kw = dict(block_q=8, block_c=128, block_d=block_d)
    before = (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches)
    for bf16 in (False, True):
        qq, cc = (q.bfloat16(), c.bfloat16()) if bf16 else (q, c)
        out_k = k_ops.dco_screen_kernel(est, qq, cc, r_sq, **kw)
        out_p = k_ops.dco_screen_kernel(est, qq, cc, r_sq, use_ref=True, **kw)
        assert all(_bitwise(a, b) for a, b in zip(out_k, out_p))
    out_k = k_ops.quant_screen_kernel(est, q, qc.codes, qc.scales, r_sq, **kw)
    out_p = k_ops.quant_screen_kernel(est, q, qc.codes, qc.scales, r_sq, use_ref=True, **kw)
    assert all(_bitwise(a, b) for a, b in zip(out_k, out_p))
    assert bool(out_k[1].any()) and not bool(out_k[1].all())
    torch.cuda.synchronize()
    assert (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,qn,n,block_d", [
    (64, 37, 300, 32), (256, 130, 1000, 64), (384, 5, 150, 128), (256, 200, 2001, 16)])
def test_cuda_l2_scan_matches_plain_version(dim, qn, n, block_d):
    """l2_scan bit for bit against l2_scan_ref: Q and N not multiples of the
    kernel's 128 x 128 tile, pad rows at 1e18 (their sums overflow to inf at
    D = 384), block widths from one staged chunk (16) to eight (128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the l2_scan kernel has no CPU mode")
    from repro_torch.kernels.l2_scan import l2_scan_kernel_call
    from repro_torch.kernels.ref import l2_scan_ref

    est, q, c, _, _ = _screen_case(dim, dim, n, qn, 32, "dade")
    cp = torch.cat([c, torch.full((7, dim), 1e18, device="cuda")])
    before = l2_scan_kernel_call.launches
    out = l2_scan_kernel_call(q, cp, block_q=1, block_c=1, block_d=block_d)
    torch.cuda.synchronize()
    assert l2_scan_kernel_call.launches == before + 1
    ref = l2_scan_ref(q, cp, block_d=block_d)
    assert _bitwise(out, ref)
    assert bool(torch.isfinite(out[:, :n]).all())
    if dim == 384:
        assert bool(torch.isinf(out[:, n:]).all())



@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cap", "cap+1", "all_survive", "ragged_d384_bd128",
                                  "ragged_bd16"])
def test_cuda_screen_paths_match_plain_versions(case):
    """dade_dco and quant_dco bit for bit against their plain versions on
    each path of the kernel: the survivors of block 1 as a list (exactly
    at its capacity), run dense (one over it, and every pair surviving
    every block), Q and N ragged against the 128 x 64 tile, block_d 128
    at D = 384 and block_d 16.  The path each tile took is read off dims
    (``_screen.screen_work``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flat screen kernels have no CPU mode")
    from repro_torch.kernels._screen import path_case, screen_work
    from repro_torch.kernels.dade_dco import dade_dco_kernel_call
    from repro_torch.kernels.quant_dco import quant_dco_kernel_call
    from repro_torch.kernels.ref import dade_dco_ref, quant_dco_ref

    fp_args, q_args, bd, survivors = path_case(case, "cuda")
    kw = dict(block_q=1, block_c=1, block_d=bd)
    before = (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches)
    outs = {"dade_dco": (dade_dco_kernel_call(*fp_args, **kw),
                         dade_dco_ref(*fp_args, block_d=bd)),
            "quant_dco": (quant_dco_kernel_call(*q_args, **kw),
                          quant_dco_ref(*q_args, block_d=bd))}
    torch.cuda.synchronize()
    assert (dade_dco_kernel_call.launches, quant_dco_kernel_call.launches) == (
        before[0] + 1, before[1] + 1)
    s_count = q_args[0].shape[1] // bd
    for name, (out_k, out_p) in outs.items():
        assert all(_bitwise(a, b) for a, b in zip(out_k, out_p)), name
        dims = out_k[2]
        work = screen_work(dims, bd)
        if survivors is not None:
            assert int((dims > bd).sum()) == survivors, name
            assert work["dense_steps"] == (1 if case == "cap" else 2), (name, work)
            assert work["list_entries"] > 0, (name, work)
        elif case == "all_survive":
            assert bool((dims == s_count * bd).all()), name
            assert work == {"dense_steps": work["tiles"] * s_count, "list_entries": 0,
                            "tiles": work["tiles"]}, name
        else:
            assert work["list_entries"] > 0 and 0 < int((dims > bd).sum()), (name, work)


def _run_schedule(engine, rows, schedule):
    """Admit ``rows`` per the arrival ``schedule`` (admissions before each
    wave) and step until drained; {row: RetiredQuery}."""
    pending, hmap, out, arrivals = list(range(len(rows))), {}, {}, list(schedule)
    while pending or engine.live_count():
        for _ in range(min(arrivals.pop(0) if arrivals else len(pending), len(pending))):
            i = pending.pop(0)
            hmap[engine.admit(rows[i])] = i
        if engine.live_count():
            for rq in engine.step():
                out[hmap[rq.handle]] = rq
    return out


@pytest.mark.gpu
def test_cuda_continuous_graph_matches_walk_kernel():
    """Continuous serving through the one-wave kernel, queries joining
    mid-walk, against each query served alone by the walk kernel and by the
    plain walk: ids, distances and ledgers bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph kernels have no CPU mode")
    import numpy as np
    from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
    from repro_torch.index.graph import build_graph, search_graph_beam_host, search_graph_fused
    from repro_torch.kernels.graph_scan import graph_walk_kernel_call
    from repro_torch.launch.annservice import ContinuousGraphEngine

    corpus = synthetic_vectors(2048, 128, seed=0)
    g = build_graph(corpus, m=12, ef_construction=48, delta_d=32, device="cuda")
    rows = synthetic_queries(12, 128, corpus, seed=5)
    before = graph_scan_kernel_call.launches
    out = _run_schedule(ContinuousGraphEngine(g, k=10, ef=48), rows, [3, 1, 0, 4, 2, 1, 1])
    assert graph_scan_kernel_call.launches > before
    walks = graph_walk_kernel_call.launches
    for i, rq in out.items():
        for search in (search_graph_fused, search_graph_beam_host):
            d, ids, st = search(g, rows[i][None], k=10, ef=48, device="cuda")
            assert np.array_equal(rq.ids, ids.cpu().numpy()[0]), (i, search.__name__)
            assert np.array_equal(rq.dists, d.cpu().numpy()[0]), (i, search.__name__)
            assert rq.stats == st, (i, search.__name__)
    assert graph_walk_kernel_call.launches == walks + len(rows)


@pytest.mark.gpu
def test_cuda_continuous_ivf_matches_solo_search():
    """Continuous IVF, each slot resumed two probes a launch, against each
    query's solo ``search_ivf_fused`` on the card: ids, squared distances
    and the ledger bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ivf_scan kernel has no CPU mode")
    import numpy as np
    from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
    from repro_torch.index.ivf import build_ivf, search_ivf_fused
    from repro_torch.launch.annservice import ContinuousIVFEngine

    corpus = synthetic_vectors(16384, 128, seed=0)
    idx = build_ivf(corpus, n_clusters=64, delta_d=32, device="cuda")
    rows = synthetic_queries(12, 128, corpus, seed=5)
    before = ivf_scan_kernel_call.launches
    out = _run_schedule(ContinuousIVFEngine(idx, k=20, n_probe=7, probe_chunk=2),
                        rows, [3, 1, 0, 4, 2, 1, 1])
    assert ivf_scan_kernel_call.launches > before
    for i, rq in out.items():
        d, ids, st = search_ivf_fused(idx, rows[i][None], k=20, n_probe=7, block_q=8)
        assert np.array_equal(rq.ids, ids.cpu().numpy()[0]), i
        assert np.array_equal(rq.dists, d.cpu().numpy()[0]), i
        assert rq.stats == st, i
        assert rq.waves == 4  # ceil(7 probes / 2)


@pytest.mark.gpu
def test_tracer_fence_waits_for_the_card(monkeypatch):
    """The recording tracer synchronises the devices its tensors live on;
    the null tracer never does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.obs import NULL_TRACER, Tracer

    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (calls.append(d), real(d)))
    x = torch.ones(4, device="cuda")
    NULL_TRACER.fence(x)
    assert calls == []
    Tracer().fence((x, [x.cpu()]))
    assert calls == [x.device]
