"""The CUDA ``ivf_scan`` (every query-tile width, split into segments),
``graph_scan`` (one wave, and the whole walk of a search), ``dade_dco``,
``quant_dco`` and ``l2_scan`` kernels against their plain PyTorch versions
on the card, bit for bit, the
repeatability of an IVF build there, the continuous engines against each
query's solo search (the walk kernel and the plain walk for the graph, the
fused scan for IVF), the sharded walk (its sliced-slab launches against
the plain version, a two-rank gloo engine against the host-simulated walk),
the tracer's fence, every LM family's prefill and decode and its train
step (loss, gradients, one AdamW step) on the card against the same
seeded model on the CPU, a bf16 train state's checkpoint, a restarted
``launch.train`` run against an uninterrupted one, and two gloo ranks on
the card (the int8 error-feedback all-reduce, a data-parallel train step)
against the same on the CPU (needs no JAX, so it runs where only the port
is installed).

Marked ``gpu``: they skip by name where ``torch.cuda.is_available()`` is
false, since a CUDA kernel has no CPU mode.  On the card:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import LM_ARCHS, reduced_config  # noqa: E402
from repro_torch.interop import lm_caches_close  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 8192, 32768])
def test_cuda_row_rotation_does_not_depend_on_the_batch(batch):
    """The rotation of corpus rows (``apply_rows``: what ``build_graph``
    and the mutable index's upserts use) gives each row the bits it gets
    alone: ``rotate(x[i:i+1]) == rotate(x[:batch])[i]``, checked on every
    row up to 8,192 and on every 64th beyond.  (A matmul does not: cuBLAS
    picks its kernel by shape, and on an H100 every row of a batch of 7 rows
    or more rounds differently from its one-row product.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuBLAS's shape-dependent kernels are the case")
    from repro_torch.core.transforms import fit_pca
    from repro_torch.data.pipeline import synthetic_vectors

    x = torch.as_tensor(synthetic_vectors(batch, 256, seed=0), device="cuda")
    t = fit_pca(x if batch >= 256 else torch.as_tensor(
        synthetic_vectors(4096, 256, seed=0), device="cuda"), device="cuda")
    full = t.apply_rows(x)
    rows = range(batch) if batch <= 8192 else range(0, batch, 64)
    for i in rows:
        assert torch.equal(t.apply_rows(x[i: i + 1])[0], full[i]), i
    import dataclasses
    on_cpu = dataclasses.replace(t, basis=t.basis.cpu())
    assert torch.equal(full.cpu(), on_cpu.apply_rows(x.cpu()))  # as on the CPU


@pytest.fixture(scope="module")
def churned_cuda_graph():
    """A MutableGraph of 1,000 rows x 64 dims on the card after 120 upserts
    (drifted rows, so some requantize) and 40 deletes, and its rebuild."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph_walk kernel has no CPU mode")
    import numpy as np
    from repro_torch.core.estimators import build_estimator
    from repro_torch.data.pipeline import drifted_vectors, synthetic_vectors
    from repro_torch.index.mutable import MutableGraph

    corpus = synthetic_vectors(1000, 64, seed=0)
    est = build_estimator("dade", corpus, torch.Generator().manual_seed(0), delta_d=32,
                          quant="int8", device="cuda")
    ups = drifted_vectors(est.transform, 120, seed=11) * 1.5
    mg = MutableGraph(corpus, m=12, ef_construction=32, estimator=est, quant="int8",
                      capacity=1200, device="cuda")
    for row in ups:
        assert mg.upsert(row) >= 0
    for gid in np.random.default_rng(3).choice(mg.count, 40, replace=False):
        assert mg.delete(int(gid))
    return mg, np.concatenate([corpus, ups])


@pytest.mark.gpu
def test_cuda_mutable_graph_equals_rebuild(churned_cuda_graph):
    """On the card, the mutated slabs (written row by row) equal a
    from-scratch ``build_graph`` of the final corpus, array for array, and
    both walks return the same ids under the same tombstones."""
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.index.graph import build_graph, search_graph_fused

    mg, full = churned_cuda_graph
    assert mg.ledger.requantizes >= 1
    ref = build_graph(full, estimator=mg.estimator, m=12, ef_construction=32,
                      quant="int8", device="cuda")
    idx = mg.index
    assert idx.entry == ref.entry
    for f in ("neighbors", "corpus_rot", "qscales", "corpus_q", "gscales", "adj_ids",
              "adj_codes", "adj_rot"):
        assert torch.equal(getattr(idx, f), getattr(ref, f)), f
    q = synthetic_queries(40, 64, full, seed=4)
    t = mg.tombstones
    d, i, _ = mg.search(q, k=10)
    d_r, i_r, _ = search_graph_fused(ref, q, k=10, tombstones=t, exclude=t, device="cuda")
    assert torch.equal(i, i_r) and torch.equal(d, d_r)


@pytest.mark.gpu
def test_cuda_walk_with_tombstones_matches_plain_walk(churned_cuda_graph):
    """The walk kernel on the churned index's own inputs, deleted rows
    pre-set in its starting bitmap, equals ``ref.graph_walk_ref`` bit for
    bit (window, ids, every wave's stats, the bitmap, wave counts); no
    tile expands a tombstoned node (its bit was set before the first wave,
    and no wave's picks hold it)."""
    import numpy as np
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.index.graph import walk_inputs
    from repro_torch.kernels.graph_scan import graph_walk_kernel_call
    from repro_torch.kernels.ops import unpack_vis
    from repro_torch.kernels.ref import graph_walk_ref

    mg, full = churned_cuda_graph
    q = synthetic_queries(77, 64, full, seed=6)
    args, wkw, _ = walk_inputs(mg.index, q, k=10, ef=48, expand=2, block_q=8, max_waves=64,
                               seed_r=False, decoupled=True, route_mult=1.0,
                               tombstones=mg.tombstones)
    vis0 = unpack_vis(args[6], mg.count)
    dead = np.zeros(mg.count, bool)
    for b, c in mg.tombstones:
        dead[b: b + c] = True
    assert (vis0 == dead[None, :]).all()
    out_k = graph_walk_kernel_call(*args, **wkw)
    out_p = graph_walk_ref(*args, **wkw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    # Expanded nodes are the bits the walk added; none is tombstoned.
    added = unpack_vis(out_k[3], mg.count) & ~vis0
    assert added.any() and not (added & dead[None, :]).any()


@pytest.mark.gpu
def test_cuda_sharded_walk_sliced_slab_launch_matches_plain(walk_graph):
    """The host-simulated sharded walk on the card at S = 1, 2, 3 returns
    the plain single-shard oracle's ids and distances bit for bit, one
    launch per shard a wave; a captured sliced-slab launch (S = 3, the last
    shard, a middle wave: ``vis_base`` > 0, the threshold frozen) equals
    ``ref.graph_scan_ref`` on its inputs, bitmap included."""
    from repro_torch.index import graph as graph_mod
    from repro_torch.index.graph import search_graph_sharded
    from repro_torch.kernels.ref import graph_scan_ref

    index, queries = walk_graph
    kw = dict(k=10, ef=48, device="cuda")
    d_o, i_o, st_o = search_graph_sharded(index, queries, num_shards=1, use_ref=True, **kw)
    for shards in (1, 2, 3):
        before = graph_scan_kernel_call.launches
        d, i, st = search_graph_sharded(index, queries, num_shards=shards, **kw)
        assert torch.equal(i, i_o) and torch.equal(d, d_o), shards
        assert st.waves == st_o.waves
        assert graph_scan_kernel_call.launches == before + shards * st.waves
    kept = []

    def capturing(*a, **k):
        out = graph_scan_kernel_call(*a, **k)
        kept.append((a, k, out))
        return out

    graph_mod.graph_scan_kernel_call = capturing
    try:
        search_graph_sharded(index, queries, num_shards=3, **kw)
    finally:
        graph_mod.graph_scan_kernel_call = graph_scan_kernel_call
    args, ckw, out_k = kept[3 * (len(kept) // 6) + 2]
    assert args[14] == 2 * index.corpus_rot.shape[0] // 3 and not ckw["tighten"]
    out_p = graph_scan_ref(*args, **ckw)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):  # window, ids, stats, bitmap
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_two_rank_gloo_engine_matches_host_walk(walk_graph, tmp_path):
    """Two ranks on the card over gloo (the process-group engine, the second
    rank loading its slab from a snapshot) return the host-simulated walk's
    results, every rank ending every wave with the same window and bitmap."""
    import numpy as np
    from repro_torch.checkpoint.index_io import save_graph_index
    from repro_torch.index.graph import search_graph_sharded
    from repro_torch.launch.annservice import sharded_graph_engine

    index, queries = walk_graph
    save_graph_index(str(tmp_path), index)
    with sharded_graph_engine(index, str(tmp_path), num_shards=2, backend="gloo", k=10,
                              ef=48, record=True, device="cuda") as engine:
        d, i, st = engine(queries)
    do, io, so = search_graph_sharded(index, queries, num_shards=2, k=10, ef=48,
                                      device="cuda")
    assert np.array_equal(i, io.cpu().numpy()) and np.array_equal(d, do.cpu().numpy())
    assert st == so
    digests = engine.ranks[0]["digests"]
    assert len(digests) == st.waves and engine.ranks[1]["digests"] == digests
    assert sum(r["launches"] for r in engine.ranks.values()) == 2 * st.waves


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_matches_cpu(arch, monkeypatch):
    """The same seeded reduced model on the CPU and moved to the card:
    prefill logits and every cache leaf, then 4 decode steps from zeroed
    caches, card against CPU (float32, TF32 off; int8 codes equal but for
    near-ties, ``interop.lm_caches_close``)."""
    import copy

    from repro_torch.models.model import build_model
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card half of the comparison")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduced_config(arch)
    cpu = build_model(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(2)
    b, s = 2, 64
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((b, cfg.vision_seq, cfg.vision_dim), generator=g)
    lc, cc = cpu.prefill(batch)
    lg, cg = card.prefill({k: v.cuda() for k, v in batch.items()})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    lm_caches_close(cc, cg, rtol=1e-4, atol=1e-4, what=f"{arch} prefill")
    (cc, _), (cg, _) = cpu.init_caches(b, 16), card.init_caches(b, 16)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        lc, cc = cpu.decode_step(tok, cc, t)
        lg, cg = card.decode_step(tok.cuda(), cg, torch.tensor(t, device="cuda"))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    lm_caches_close(cc, cg, rtol=1e-4, atol=1e-4, what=f"{arch} decode")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["_sdpa", "_flat_sdpa"])
def test_cuda_bf16_attention_matches_cpu(name):
    """bf16 attention with scores of about +-60 under a softcap of 50: the
    card's float32-output products (``bmm``'s ``out_dtype``) against the
    CPU's widened operands, to about one bf16 step (rtol = atol = 1e-2)."""
    from repro_torch.models import attention
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card half of the comparison")
    g = torch.Generator().manual_seed(5)
    b, sq, skv, h, dh = 2, 8, 32, 4, 64
    q_shape = (b, sq, 2, h // 2, dh) if name == "_sdpa" else (b, sq, h, dh)
    kv_shape = (b, skv, 2 if name == "_sdpa" else h, dh)
    q = (torch.randn(q_shape, generator=g) * 5.5).bfloat16()
    k = (torch.randn(kv_shape, generator=g) * 5.5).bfloat16()
    v = torch.randn(kv_shape, generator=g).bfloat16()
    mask = torch.ones((sq, skv), dtype=torch.bool).tril(skv - sq)
    fn = getattr(attention, name)
    want = fn(q, k, v, mask, 50.0)
    got = fn(q.cuda(), k.cuda(), v.cuda(), mask.cuda(), 50.0)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_train_step_matches_cpu(arch, monkeypatch):
    """The same seeded reduced model on the CPU and moved to the card: the
    train step's loss and every gradient leaf (``train_grads``, its
    grad_accum microbatches included), then every parameter after one
    AdamW step at lr 3e-5 (a near-zero gradient whose sign the devices
    round apart moves a parameter by at most 2 x lr), within 1e-4."""
    import copy

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import train_grads, train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card half of the comparison")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduced_config(arch)
    cpu = build_model(cfg, seed=1, device="cpu").requires_grad_(True)
    card = copy.deepcopy(cpu).to("cuda")
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq=64, seed=2).batch_at(0)
    g = torch.Generator().manual_seed(3)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((4, cfg.vision_seq, cfg.vision_dim), generator=g)
    lc, _, gc = train_grads(cpu, batch)
    lg, _, gg = train_grads(card, batch)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for k in gc:
        torch.testing.assert_close(gg[k].cpu(), gc[k], rtol=1e-4, atol=1e-4, msg=k)
    opt = AdamWConfig(lr=3e-5, warmup_steps=1, total_steps=10)
    pc, pg = dict(cpu.named_parameters()), dict(card.named_parameters())
    train_step(cpu, opt, pc, adamw_init(pc), batch)
    train_step(card, opt, pg, adamw_init(pg), batch)
    for k in pc:
        torch.testing.assert_close(pg[k].detach().cpu(), pc[k].detach(), rtol=1e-4,
                                   atol=1e-4, msg=k)


@pytest.mark.gpu
def test_cuda_bf16_train_state_checkpoint_roundtrip(tmp_path):
    """A bf16 model's parameters and float32 moments saved from the card and
    restored onto it, every leaf equal bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(reduced_config("gemma-2b"), dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = dict(model.named_parameters())
    state = (params, adamw_init(params), None)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, state)
    mgr.wait()
    out = mgr.restore(3, state)
    for k, p in params.items():
        assert out[0][k].device.type == "cuda" and out[0][k].dtype == torch.bfloat16
        assert torch.equal(out[0][k], p), k
    assert int(out[1]["step"]) == 0


@pytest.mark.gpu
def test_cuda_train_cli_restart_equals_uninterrupted_run(tmp_path):
    """``launch.train --reduced --device cuda --deterministic`` with a
    failure after the first checkpoint ends equal, bit for bit, to the
    uninterrupted run."""
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = ["--arch", "mamba2-130m", "--reduced", "--steps", "12", "--batch", "4",
            "--seq", "64", "--lr", "3e-3", "--ckpt-every", "5", "--deterministic"]
    try:
        state, info = train.main(base + ["--fail-at", "7", "--ckpt-dir", str(tmp_path / "a")])
        ref, _ = train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
    assert info["restarts"] == 1
    for k in ref[0]:
        assert torch.equal(state[0][k], ref[0][k]), k


@pytest.mark.gpu
def test_cuda_bf16_attention_backward_matches_cpu():
    """The backward of the card's bf16 float32-output products
    (``attention._BmmF32``, whose products round the cotangent to bf16)
    against the CPU's widened float32 products, to about a bf16 step of
    each gradient's scale."""
    from repro_torch.models import attention
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card half of the comparison")
    g = torch.Generator().manual_seed(6)
    b, sq, skv, h, dh = 2, 16, 32, 4, 64
    q, k, v = ((torch.randn(shape, generator=g) * 2).bfloat16()
               for shape in ((b, sq, h, dh), (b, skv, h, dh), (b, skv, h, dh)))
    mask = torch.ones((sq, skv), dtype=torch.bool).tril(skv - sq)
    w = torch.randn((b, sq, h, dh), generator=g)
    grads = []
    for dev in ("cpu", "cuda"):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        out = attention._flat_sdpa(*leaves, mask.to(dev), 50.0)
        grads.append(torch.autograd.grad((out.float() * w.to(dev)).sum(), leaves))
    for want, got in zip(*grads):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


def _two_gloo_ranks_on_the_card(fn, tmp_path, *args):
    from repro_torch.launch.mesh import spawn
    return spawn(fn, 2, backend="gloo", init_file=str(tmp_path / "init"), args=args,
                 device="cuda").join(timeout_s=300)


@pytest.mark.gpu
def test_cuda_compressed_grad_allreduce_over_gloo_matches_cpu(tmp_path):
    """Two ranks on the card over gloo: the int8 error-feedback all-reduce of
    CUDA tensors (staged through the host) equals the same call on CPU
    tensors bit for bit, on every rank."""
    import numpy as np

    import _torch_dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((64, 48)).astype(np.float32),
         "b": (rng.standard_normal(48) * 1e-3).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    out = _two_gloo_ranks_on_the_card(_torch_dist.codec_devices_rank, tmp_path, g, e)
    for cpu, card in out.values():
        for c, d in zip(cpu, card):
            for k in g:
                assert np.array_equal(c[k], d[k]), k


@pytest.mark.gpu
def test_cuda_data_parallel_train_step_matches_cpu(tmp_path):
    """A 2-rank data-parallel train step of a reduced MoE model on the card
    (gloo) equals the same step on the CPU within 1e-4: loss, every summed
    gradient leaf, every parameter after one AdamW step at lr 3e-5."""
    import numpy as np

    import _torch_dist
    from repro_torch.data.pipeline import TokenPipeline
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = reduced_config("qwen2-moe-a2.7b")
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq=64, seed=2).batch_at(0)
    out = _two_gloo_ranks_on_the_card(_torch_dist.dp_step_devices_rank, tmp_path,
                                      "qwen2-moe-a2.7b", batch, 3e-5)
    for (lc, gc, pc), (lg, gg, pg) in out.values():
        np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-4)
        for k in gc:
            np.testing.assert_allclose(gg[k], gc[k], rtol=1e-4, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(pg[k], pc[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.gpu
def test_cuda_tensor_parallel_steps_match_cpu(tmp_path):
    """Two ranks of a (data=1, model=2) mesh on the card (gloo): a reduced
    MQA model's partitioned train step, prefill and 4 decode steps (the
    kv_seq-split cache's two blocks both written) equal the same ranks'
    steps on the CPU within 1e-4: loss, every gathered gradient leaf and
    parameter after one AdamW step at lr 3e-5, the prefill's and each
    decode step's logits."""
    import numpy as np

    import _torch_dist
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = reduced_config("gemma-2b")
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq=64, seed=2).batch_at(0)
    out = _two_gloo_ranks_on_the_card(_torch_dist.tp_devices_rank, tmp_path, "gemma-2b",
                                      batch, 3e-5)
    for (lc, gc, pc, prc, dc), (lg, gg, pg, prg, dg) in out.values():
        np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-4)
        for k in gc:
            np.testing.assert_allclose(gg[k], gc[k], rtol=1e-4, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(pg[k], pc[k], rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(prg, prc, rtol=1e-4, atol=1e-4)
        for t, (x, y) in enumerate(zip(dg, dc)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4, err_msg=f"step {t}")
