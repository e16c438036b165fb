"""Batched distance-comparison-operation (DCO) engine — Algorithm 1 as a
block-incremental masked screen (port of ``repro.core.dco``).

    for each checkpoint d_s in (Δd, 2Δd, ..., D):
        psum  += ||(q' - o')[d_{s-1}:d_s]||²
        est²   = psum · scale_s
        prune  = est² > (1+eps_s)² · r²             (reject H0)

Rows that survive to d = D hold the exact squared distance (scale_S = 1);
``dims_used`` records the checkpoint at which each row retired.  This is
the plain functional definition the flat screen kernel
(``kernels.ops.dco_screen_kernel``) is held against: it computes every
dimension, with matmuls of masked blocks as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.calibration import EpsilonTable

__all__ = ["DCOResult", "dco_screen", "dco_screen_batch", "block_partial_sq",
           "first_reject"]


class DCOResult(NamedTuple):
    """Outcome of a DCO screen: est_sq (..., C) f32 estimate at retirement
    (exact for rows that reached d = D), passed (..., C) bool (survived
    every test and est <= r²), dims_used (..., C) int32."""

    est_sq: torch.Tensor
    passed: torch.Tensor
    dims_used: torch.Tensor


def first_reject(reject: torch.Tensor) -> torch.Tensor:
    """Index of the first True along axis 0 of (S, ...) ``reject`` (S where
    there is none)."""
    s_count = reject.shape[0]
    s_idx = torch.arange(s_count, device=reject.device).reshape(
        (s_count,) + (1,) * (reject.dim() - 1))
    return torch.min(torch.where(reject, s_idx, s_count), dim=0).values


def block_partial_sq(q: torch.Tensor, c: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """(S, Q, C) partial squared distances at the checkpoints ``dims``:
    per block ``qn + cn - 2 q·oᵀ`` over its masked dims (a matmul), summed
    over blocks and clamped at 0."""
    dims = dims.long()
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dims.device), dims[:-1]])
    k = torch.arange(q.shape[1], device=q.device)
    blocks = []
    for start, stop in zip(starts.tolist(), dims.tolist()):
        m = ((k >= start) & (k < stop)).float()
        qm = q * m[None, :]
        cm = c * m[None, :]
        dot = qm @ cm.T  # (Q, C)
        qn = torch.sum(qm * qm, dim=1)
        cn = torch.sum(cm * cm, dim=1)
        blocks.append(qn[:, None] + cn[None, :] - 2.0 * dot)
    return torch.clamp_min(torch.cumsum(torch.stack(blocks), dim=0), 0.0)


def _retire(est_sq_all, thresh, dims, r_sq):
    """Retire each candidate at its first rejecting checkpoint (axis 0)."""
    s_count = dims.shape[0]
    first = first_reject(est_sq_all > thresh)
    never = first == s_count
    retire_s = torch.where(never, s_count - 1, first)
    est_sq = torch.gather(est_sq_all, 0, retire_s.unsqueeze(0))[0]
    passed = never & (est_sq <= r_sq)
    return DCOResult(est_sq=est_sq, passed=passed, dims_used=dims[retire_s])


def dco_screen(q_rot: torch.Tensor, cands_rot: torch.Tensor,
               table: EpsilonTable, r_sq) -> DCOResult:
    """Screen C candidates (C, D) against one query (D,) and scalar r²."""
    diff = cands_rot - q_rot[None, :]
    csq = torch.cumsum((diff * diff).float(), dim=1)  # (C, D)
    dims = table.dims.long()
    partial_sq = csq[:, dims - 1].T  # (S, C)
    est_sq_all = partial_sq * table.scale[:, None]
    t = 1.0 + table.eps[:, None]
    r = torch.as_tensor(r_sq, dtype=torch.float32, device=csq.device)
    return _retire(est_sq_all, t * t * r, table.dims, r)


def dco_screen_batch(q_rot: torch.Tensor, cands_rot: torch.Tensor,
                     table: EpsilonTable, r_sq: torch.Tensor) -> DCOResult:
    """Vectorized over a query batch (Q, D) with per-query thresholds (Q,):
    returns (Q, C) fields, the partial distances from
    :func:`block_partial_sq`."""
    csq = block_partial_sq(q_rot.float(), cands_rot.float(), table.dims)
    est_sq_all = csq * table.scale[:, None, None]
    t = 1.0 + table.eps[:, None, None]
    rsq = r_sq.float()[None, :, None]
    return _retire(est_sq_all, t * t * rsq, table.dims, rsq[0])
