"""Symmetric int8 scalar quantization of the *rotated* corpus (port of the
parts of ``repro.quant.scalar`` the fused scan uses).

Per-dimension scales (``fit_scales``/``quantize``, ``quantize_corpus``)
feed the threshold seeds;
per-BLOCK scales (one per ``block_d`` contiguous dims) feed the fused
kernel's int8×int8 stage 1: within a block the dequantize is one scalar, so
``q'·o' = t_b·s_b·(qc·oc)`` with ``qc·oc`` accumulated in int32.  In-corpus
values never clip, so the per-dim error bound s/2 holds and the stage-1
lower bound never prunes a true survivor.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantConfig", "QuantizedCorpus", "fit_scales", "quantize",
           "quantize_corpus", "wants_quant", "fit_block_scales",
           "quantize_block", "block_err_cum", "quantize_queries_block",
           "DEFAULT_SLACK"]

# int8 code range is symmetric [-127, 127].
_QMAX = 127.0

# Deflation applied to lower bounds to absorb fp32 round-off.
DEFAULT_SLACK = 1e-4


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static corpus-quantization policy carried by an Estimator."""

    bits: int = 8
    slack: float = DEFAULT_SLACK

    def __post_init__(self):
        if self.bits != 8:
            raise ValueError(f"only int8 scalar quantization is implemented, got bits={self.bits}")
        if not 0.0 <= self.slack < 1e-2:
            raise ValueError(f"slack must be a small non-negative fraction, got {self.slack}")


def fit_scales(rot_corpus: torch.Tensor) -> torch.Tensor:
    """(D,) per-dimension scales max|x_d| / 127 (zero-variance dims get 0)."""
    max_abs = torch.amax(torch.abs(rot_corpus.float()), dim=0)
    return (max_abs / _QMAX).float()


def quantize(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Round to int8 codes (half to even, as ``jnp.round``); values beyond
    the fitted range clip to +-127."""
    x = x.float()
    safe = torch.where(scales > 0.0, scales, torch.ones_like(scales))
    q = torch.round(x / safe)
    q = torch.where(scales > 0.0, q, torch.zeros_like(q))
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QuantizedCorpus:
    """int8 codes + per-dimension scales of a rotated corpus: codes
    (..., D) int8 = round(x / scales) clipped to [-127, 127], scales (D,)
    float32 (the reconstruction error is at most scales / 2)."""

    codes: torch.Tensor
    scales: torch.Tensor


def quantize_corpus(rot_corpus: torch.Tensor,
                    scales: torch.Tensor | None = None) -> QuantizedCorpus:
    """Fit per-dimension scales (unless given) and encode."""
    if scales is None:
        scales = fit_scales(rot_corpus)
    return QuantizedCorpus(codes=quantize(rot_corpus, scales), scales=scales)


def wants_quant(quant, estimator_quant) -> bool:
    """Build-time decision: store int8 codes?  True when the build was
    passed a policy ("int8" or a QuantConfig) or the estimator carries one."""
    return estimator_quant is not None or quant not in (None, "none")


def _num_blocks(dim: int, block_d: int) -> int:
    if dim % block_d:
        raise ValueError(f"dim {dim} not a multiple of block_d {block_d}")
    return dim // block_d


def fit_block_scales(rot_corpus: torch.Tensor, block_d: int) -> torch.Tensor:
    """(S,) symmetric scales, one per block of ``block_d`` contiguous dims."""
    x = rot_corpus.float()
    s = _num_blocks(x.shape[-1], block_d)
    max_abs = torch.abs(x.reshape(-1, s, block_d)).amax(dim=(0, 2))
    return (max_abs / _QMAX).float()


def quantize_block(x: torch.Tensor, bscales: torch.Tensor, block_d: int) -> torch.Tensor:
    """Round to int8 codes under per-block scales (broadcast to per-dim)."""
    return quantize(x, torch.repeat_interleave(bscales, block_d))


def block_err_cum(bscales: torch.Tensor, *, block_d: int) -> torch.Tensor:
    """(S,) cumulative error band E(s) = sqrt(sum_{b<=s} block_d·(s_b/2)^2)."""
    h = bscales.float() * 0.5
    return torch.sqrt(torch.cumsum(block_d * (h * h), dim=0))


def quantize_queries_block(q_rot: torch.Tensor, block_d: int):
    """Quantize a query batch with per-(query, block) symmetric scales.

    Returns (codes (Q, D) int8, qscales (Q, S) f32); scales come from each
    query's own block maxima, so queries never clip.
    """
    q = q_rot.float()
    qn, dim = q.shape
    s = _num_blocks(dim, block_d)
    blocks = q.reshape(qn, s, block_d)
    t = torch.abs(blocks).amax(dim=2) / _QMAX  # (Q, S)
    safe = torch.where(t > 0.0, t, torch.ones_like(t))
    codes = torch.round(blocks / safe[:, :, None])
    codes = torch.where(t[:, :, None] > 0.0, codes, torch.zeros_like(codes))
    codes = torch.clamp(codes, -_QMAX, _QMAX).to(torch.int8)
    return codes.reshape(qn, dim), t.float()
