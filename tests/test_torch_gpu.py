"""The CUDA ``ivf_scan`` kernel against its plain PyTorch version on the
card (needs no JAX, so it runs where only the port is installed).

Marked ``gpu``: it skips by name where ``torch.cuda.is_available()`` is
false, since a CUDA kernel has no CPU mode.  On the card:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call  # noqa: E402
from repro_torch.kernels.ref import ivf_scan_ref  # noqa: E402
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
