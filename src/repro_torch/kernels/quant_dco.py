"""int8 lower-bound DCO prefilter: build, binding and launch of the CUDA
kernel.

``quant_dco_kernel_call`` is the port of the Pallas kernel
``repro.kernels.quant_dco.quant_dco_kernel_call``: per-dimension int8 codes
dequantized per block, the sound lower bound tested at every checkpoint.
It runs where its tensors live: on CUDA tensors it launches the
hand-written kernel in ``csrc/quant_dco.cu`` (``sm_90a``, built by
``nvcc`` at first use); on CPU tensors it runs the plain version
``ref.quant_dco_ref``.  There is no fallback between the two: a CUDA call
that cannot launch raises.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import _screen
from repro_torch.kernels.ref import quant_dco_ref

__all__ = ["quant_dco_kernel_call", "build"]

_NAME = "quant_dco"


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _screen.build(_NAME)


def quant_dco_kernel_call(
    q_rot: torch.Tensor,  # (Q, D) f32
    codes: torch.Tensor,  # (N, D) int8
    scales: torch.Tensor,  # (D,) f32 per-dimension quantization scales
    eps: torch.Tensor,  # (S,) f32 — thresholds at d = (s+1)·block_d
    scale: torch.Tensor,  # (S,) f32 — unbiasing scales
    ecum: torch.Tensor,  # (S,) f32 — E(d) at each block checkpoint
    r_sq: torch.Tensor,  # (Q,) f32
    *,
    block_q: int = 128,
    block_c: int = 128,
    block_d: int = 128,
    slack: float = 1e-4,
):
    """Run the int8 lower-bound prefilter on pre-padded inputs (Q % block_q
    == 0, N % block_c == 0, D % block_d == 0, S == D // block_d; the values
    depend on ``block_d`` alone).

    Returns (lb_sq (Q, N) f32, pruned (Q, N) int32, lb_dims (Q, N) int32).
    Every launch of the CUDA kernel adds one to
    ``quant_dco_kernel_call.launches``; the CPU path does not.
    """
    qn, dim = q_rot.shape
    _screen.check_padded(_NAME, qn, codes.shape[0], dim, eps.shape[0],
                         block_q=block_q, block_c=block_c, block_d=block_d)
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    dev = _screen.one_device(_NAME, q_rot, codes, scales, eps, scale, ecum, r_sq)
    if dev.type == "cpu":
        return quant_dco_ref(q_rot, codes, scales, eps, scale, ecum, r_sq,
                             block_d=block_d, slack=slack)
    out = _screen.launch(_NAME, q_rot, codes, block_d=block_d, cscales=scales,
                         eps=eps, scale=scale, ecum=ecum, r_sq=r_sq, slack=slack)
    quant_dco_kernel_call.launches += 1
    return out


quant_dco_kernel_call.launches = 0
