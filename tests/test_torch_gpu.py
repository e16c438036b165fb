"""The CUDA ``ivf_scan`` and ``graph_scan`` kernels against their plain
PyTorch versions on the card, and the repeatability of an IVF build there
(needs no JAX, so it runs where only the port is installed).

Marked ``gpu``: they skip by name where ``torch.cuda.is_available()`` is
false, since a CUDA kernel has no CPU mode.  On the card:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402
from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call  # noqa: E402
from repro_torch.kernels.ref import graph_scan_ref, ivf_scan_ref  # noqa: E402
from repro_torch.quant.scalar import (  # noqa: E402
    fit_block_scales, quantize_block, quantize_queries_block)


def _case(k, block_q, bf16, seed=0, n_rows=2048, dim=128, block_d=32, block_c=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    scales = torch.exp(-0.03 * torch.arange(dim, device="cuda"))
    rows = torch.randn((n_rows, dim), generator=g, device="cuda") * scales
    ids = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    ids[-block_c:] = -1
    bs = fit_block_scales(rows, block_d)
    codes = quantize_block(rows, bs, block_d)
    q = rows[:16] + 0.1 * torch.randn((16, dim), generator=g, device="cuda") * scales
    starts = torch.tensor([[0, 700, 1400, 700]] * (16 // block_q), device="cuda")
    sizes = torch.tensor([[600, 300, 500, 300]] * (16 // block_q), device="cuda")
    cap = ops.ivf_cap_tiles(600, block_c, starts_aligned=False)
    offs = ops.build_window_offsets(starts, sizes, block_c=block_c, cap_tiles=cap,
                                    n_pad=n_rows)
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    r0 = torch.full((16,), float("inf"), device="cuda")
    args = (offs, qcodes, q, qscales, r0, torch.full((16, k), float("inf"), device="cuda"),
            torch.full((16, k), -1, dtype=torch.int32, device="cuda"), codes,
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
