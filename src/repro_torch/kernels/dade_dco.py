"""Blocked fp32 DCO screen (Algorithm 1): build, binding and launch of the
CUDA kernel.

``dade_dco_kernel_call`` is the port of the Pallas kernel
``repro.kernels.dade_dco.dade_dco_kernel_call``.  It runs where its tensors
live: on CUDA tensors it launches the hand-written kernel in
``csrc/dade_dco.cu`` (``sm_90a``, built by ``nvcc`` at first use); on CPU
tensors it runs the plain version ``ref.dade_dco_ref``.  There is no
fallback between the two: a CUDA call that cannot launch raises.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _screen
from repro_torch.kernels.ref import dade_dco_ref

__all__ = ["dade_dco_kernel_call", "build"]

_NAME = "dade_dco"


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _screen.build(_NAME)


def dade_dco_kernel_call(
    q_rot: torch.Tensor,  # (Q, D) f32
    cands_rot: torch.Tensor,  # (N, D) f32
    eps: torch.Tensor,  # (S,) f32 — thresholds at d = (s+1)·block_d
    scale: torch.Tensor,  # (S,) f32 — unbiasing scales (scale[-1] == 1)
    r_sq: torch.Tensor,  # (Q,) f32
    *,
    block_q: int = 128,
    block_c: int = 128,
    block_d: int = 128,
):
    """Run the DCO screen on pre-padded inputs (Q % block_q == 0,
    N % block_c == 0, D % block_d == 0, S == D // block_d; the values depend
    on ``block_d`` alone).

    Returns (est_sq (Q, N) f32, passed (Q, N) int32, dims_used (Q, N)
    int32).  Every launch of the CUDA kernel adds one to
    ``dade_dco_kernel_call.launches``; the CPU path does not.
    """
    qn, dim = q_rot.shape
    _screen.check_padded(_NAME, qn, cands_rot.shape[0], dim, eps.shape[0],
                         block_q=block_q, block_c=block_c, block_d=block_d)
    dev = _screen.one_device(_NAME, q_rot, cands_rot, eps, scale, r_sq)
    if dev.type == "cpu":
        return dade_dco_ref(q_rot, cands_rot, eps, scale, r_sq, block_d=block_d)
    out = _screen.launch(_NAME, q_rot, cands_rot.float(), block_d=block_d, eps=eps,
                         scale=scale, r_sq=r_sq)
    dade_dco_kernel_call.launches += 1
    return out


dade_dco_kernel_call.launches = 0
