"""Full-D exact squared L2 scan (the FDScanning control): build, binding
and launch of the CUDA kernel.

``l2_scan_kernel_call`` is the port of the Pallas kernel
``repro.kernels.l2_scan.l2_scan_kernel_call``: the DCO screen's tiling and
per-block decomposition with no screening.  It runs where its tensors
live: on CUDA tensors it launches the hand-written kernel in
``csrc/l2_scan.cu`` (``sm_90a``, built by ``nvcc`` at first use); on CPU
tensors it runs the plain version ``ref.l2_scan_ref``.  There is no
fallback between the two: a CUDA call that cannot launch raises.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _screen
from repro_torch.kernels.ref import l2_scan_ref

__all__ = ["l2_scan_kernel_call", "build"]

_NAME = "l2_scan"


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _screen.build(_NAME)


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
    _screen.check_padded(_NAME, qn, cands_rot.shape[0], dim, None,
                         block_q=block_q, block_c=block_c, block_d=block_d)
    dev = _screen.one_device(_NAME, q_rot, cands_rot)
    if dev.type == "cpu":
        return l2_scan_ref(q_rot, cands_rot, block_d=block_d)
    (out,) = _screen.launch(_NAME, q_rot, cands_rot.float(), block_d=block_d)
    l2_scan_kernel_call.launches += 1
    return out


l2_scan_kernel_call.launches = 0
