"""Symmetric int8 scalar quantization of the *rotated* corpus (port of the
parts of ``repro.quant.scalar`` the fused scans and the flat screen use).

Per-dimension scales (``fit_scales``/``quantize``, ``quantize_corpus``)
feed the threshold seeds and the flat int8 prefilter, whose sound lower
bound is ``lower_bound_sq`` over the cumulative band ``cum_err_sq``;
per-BLOCK scales (one per ``block_d`` contiguous dims) feed the fused
kernel's int8×int8 stage 1: within a block the dequantize is one scalar, so
``q'·o' = t_b·s_b·(qc·oc)`` with ``qc·oc`` accumulated in int32.  In-corpus
values never clip, so the per-dim error bound s/2 holds and the stage-1
lower bound never prunes a true survivor.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.tiles import sqrt_rn

__all__ = ["QuantConfig", "QuantizedCorpus", "fit_scales", "quantize",
           "quantize_corpus", "dequantize", "cum_err_sq", "lower_bound_sq",
           "upper_bound_sq", "wants_quant", "fit_block_scales",
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

    def dequantize(self) -> torch.Tensor:
        return dequantize(self.codes, self.scales)


def quantize_corpus(rot_corpus: torch.Tensor,
                    scales: torch.Tensor | None = None) -> QuantizedCorpus:
    """Fit per-dimension scales (unless given) and encode."""
    if scales is None:
        scales = fit_scales(rot_corpus)
    return QuantizedCorpus(codes=quantize(rot_corpus, scales), scales=scales)


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.float() * scales.float()


def cum_err_sq(scales: torch.Tensor, dims) -> torch.Tensor:
    """E(d)^2 = sum_{j < d} (s_j/2)^2 at each checkpoint in ``dims``
    (1-indexed dimension counts, as in ``EpsilonTable.dims``)."""
    h = scales.float() * 0.5
    e2 = torch.cumsum(h * h, dim=0)
    return e2[torch.as_tensor(dims, device=e2.device).long() - 1]


def lower_bound_sq(dq_psum: torch.Tensor, ecum_sq, *,
                   slack: float = DEFAULT_SLACK) -> torch.Tensor:
    """Sound lower bound ``max(0, sqrt(dq_psum) - E(d))^2 (1 - slack)`` on
    the true partial squared distance (``dq_psum`` over dequantized rows,
    ``ecum_sq`` = E(d)^2 broadcastable against it)."""
    root = sqrt_rn(torch.clamp_min(dq_psum, 0.0)) - sqrt_rn(torch.as_tensor(ecum_sq))
    root = torch.clamp_min(root, 0.0)
    return root * root * (1.0 - slack)


def upper_bound_sq(dq_psum: torch.Tensor, ecum_sq) -> torch.Tensor:
    """Matching upper bound ``(sqrt(dq_psum) + E(d))^2 (1 + slack)``; the
    slack inflates, so fp32 round-off never shrinks it below the truth."""
    root = sqrt_rn(torch.clamp_min(dq_psum, 0.0)) + sqrt_rn(torch.as_tensor(ecum_sq))
    return root * root * (1.0 + DEFAULT_SLACK)


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
