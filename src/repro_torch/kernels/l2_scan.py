"""Full-D exact squared L2 scan (the FDScanning control): build, binding
and launch of the CUDA kernel.

``l2_scan_kernel_call`` is the port of the Pallas kernel
``repro.kernels.l2_scan.l2_scan_kernel_call``: the sum over dimension
blocks of ``max(qn + cn - 2 q·c, 0)``.  It runs where its tensors live: on
CUDA tensors it launches the hand-written kernel in ``csrc/l2_scan.cu``
(``sm_90a``, a register-tiled outer product over 128 x 128 tiles, built by
``nvcc`` at first use); on CPU tensors it runs the plain version
``ref.l2_scan_ref``.  There is no fallback between the two: a CUDA call
that cannot launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _screen
from repro_torch.kernels.ref import l2_scan_ref

__all__ = ["l2_scan_kernel_call", "build", "KERNEL_TILE"]

_NAME = "l2_scan"
_SOURCES = ("l2_scan.cu", "tiles.cuh")
# (queries, candidates) of one CTA; the plain version takes any tile.
KERNEL_TILE = (128, 128)


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _build.build(_NAME, _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l2_scan_launch.argtypes = [i, p, p, p, i, i, i, i, p]
    lib.l2_scan_launch.restype = i
    return lib


def l2_scan_kernel_call(
    q_rot: torch.Tensor,  # (Q, D), Q % block_q == 0
    cands_rot: torch.Tensor,  # (N, D), N % block_c == 0, D % block_d == 0
    *,
    block_q: int = 128,
    block_c: int = 128,
    block_d: int = 128,
) -> torch.Tensor:
    """Exact squared L2 distances (Q, N) f32 — full D, no screening: the sum
    over dimension blocks of ``max(qn + cn - 2 q·cᵀ, 0)``.  Every launch of
    the CUDA kernel adds one to ``l2_scan_kernel_call.launches``; the CPU
    path does not."""
    qn, dim = q_rot.shape
    n = cands_rot.shape[0]
    _screen.check_padded(_NAME, qn, n, dim, None,
                         block_q=block_q, block_c=block_c, block_d=block_d)
    dev = _screen.one_device(_NAME, q_rot, cands_rot)
    if dev.type == "cpu":
        return l2_scan_ref(q_rot, cands_rot, block_d=block_d)
    if block_d % 16:
        raise ValueError(f"the CUDA kernel stages 16 dims at a time: "
                         f"block_d={block_d} must be a multiple of 16")
    tq, tc = KERNEL_TILE
    if -(-qn // tq) * -(-n // tc) >= 2**31:
        raise ValueError(f"{qn} x {n} needs more than 2^31 - 1 {tq} x {tc} tiles")
    q, c = q_rot.float().contiguous(), cands_rot.float().contiguous()
    for name, t in (("queries", q), ("candidates", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for cp.async")
    out = torch.empty((qn, n), dtype=torch.float32, device=dev)
    err = _lib().l2_scan_launch(dev.index or 0, q.data_ptr(), c.data_ptr(),
                                out.data_ptr(), qn, n, dim, block_d,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_NAME} launch failed: cudaError {err}")
    l2_scan_kernel_call.launches += 1
    return out


l2_scan_kernel_call.launches = 0
