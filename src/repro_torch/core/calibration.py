"""Hypothesis-testing calibration for DADE (paper §3.3, Eq. 14); port of
``repro.core.calibration``.

For every checkpoint ``d`` of the expansion schedule, ``eps_d`` is the
empirical (1 - P_s)-quantile of ``dis'_d / dis - 1`` over uniformly sampled
object pairs.  ADSampling instead uses the data-oblivious bound
``eps_d = eps0 / sqrt(d)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.transforms import OrthogonalTransform, as_tensor

__all__ = ["EpsilonTable", "calibrate", "adsampling_table",
           "expansion_schedule", "sample_pairs", "violation_rates"]


@dataclasses.dataclass(frozen=True)
class EpsilonTable:
    """Per-checkpoint thresholds for the incremental DCO loop.

    dims (S,) int32 checkpoints; eps (S,) upper-tail eps_d (0 at the exact
    last checkpoint); scale (S,) unbias factor on the squared partial
    distance; eps_lo (S,) lower-tail quantile (seed inflation).
    """

    dims: torch.Tensor
    eps: torch.Tensor
    scale: torch.Tensor
    eps_lo: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.dims.shape[0]


def expansion_schedule(dim: int, delta_d: int, device=None) -> torch.Tensor:
    """Checkpoints Δd, 2Δd, ..., D (always terminating exactly at D)."""
    if delta_d <= 0:
        raise ValueError(f"delta_d must be positive, got {delta_d}")
    steps = list(range(delta_d, dim, delta_d)) + [dim]
    return torch.tensor(steps, dtype=torch.int32, device=device)


def sample_pairs(n: int, num_pairs: int, generator: torch.Generator | None):
    """Uniform object-pair indices (i, j) with i != j, as CPU int64 tensors."""
    i = torch.randint(0, n, (num_pairs,), generator=generator)
    j = torch.randint(0, n, (num_pairs,), generator=generator)
    return i, torch.where(i == j, (j + 1) % n, j)


def calibrate(
    transform: OrthogonalTransform,
    data,
    generator: torch.Generator | None = None,
    *,
    p_s: float = 0.1,
    delta_d: int = 32,
    num_pairs: int = 4096,
    pairs=None,
) -> EpsilonTable:
    """Empirically estimate eps_d from sampled object pairs.

    ``pairs`` optionally gives the pair indices ``(i, j)`` explicitly (the
    parity tests pass the reference's own draws); otherwise they are drawn
    from ``generator``.  Runs on the transform's device.
    """
    dev = transform.device
    x = as_tensor(data, dev)
    dim = transform.dim
    dims = expansion_schedule(dim, delta_d, device=dev)
    if pairs is None:
        i, j = sample_pairs(x.shape[0], num_pairs, generator)
    else:
        i, j = (torch.tensor(np.asarray(p), dtype=torch.long) for p in pairs)
        j = torch.where(i == j, (j + 1) % x.shape[0], j)
    x1 = x[i.to(dev)]
    x2 = x[j.to(dev)]
    delta = transform.apply(x1 - x2)  # (P, D) rotated differences
    csq = torch.cumsum(delta * delta, dim=1)  # ||W_d^T dx||^2 for every d

    idx = dims.long() - 1
    partial_sq = csq[:, idx]  # (P, S)
    scale = transform.scale(dims)  # (S,)
    exact = torch.sqrt(torch.clamp_min(csq[:, -1], 1e-30))
    est = torch.sqrt(torch.clamp_min(partial_sq * scale[None, :], 0.0))
    ratio = est / exact[:, None] - 1.0  # (P, S)

    p = torch.tensor(p_s, dtype=torch.float32, device=dev)
    eps = torch.clamp_min(torch.quantile(ratio, 1.0 - p, dim=0), 0.0)
    eps_lo = torch.clamp_min(-torch.quantile(ratio, p, dim=0), 0.0)
    # Final checkpoint (d == D) is exact: eps = 0, scale = 1.
    eps[-1] = 0.0
    eps_lo[-1] = 0.0
    scale = scale.clone()
    scale[-1] = 1.0
    return EpsilonTable(dims=dims, eps=eps.float(), scale=scale.float(),
                        eps_lo=eps_lo.float())


def violation_rates(
    table: EpsilonTable,
    transform: OrthogonalTransform,
    data,
    generator: torch.Generator | None = None,
    *,
    num_pairs: int = 2048,
    pairs=None,
) -> torch.Tensor:
    """Per-checkpoint empirical violation rates: the hypothesis test of
    Eq. 14 run in reverse — given a table, measure P(dis'_d / dis - 1 >
    eps_d) on pairs from ``data``.

    On the distribution the table was calibrated for every rate sits near
    P_s; under drift the early checkpoints exceed the band, which is the
    staleness statistic of the drift watchdog (``index.mutable``).  The
    same pairs give a paired comparison of two tables (the recalibration
    swap's proof).  ``pairs`` gives the indices ``(i, j)`` explicitly (the
    parity tests pass the reference's own draws); otherwise they are drawn
    from ``generator``.  The final checkpoint is exact and reports 0.
    Returns (S,) float32 on the transform's device."""
    dev = transform.device
    x = as_tensor(data, dev)
    n = x.shape[0]
    if pairs is None:
        i, j = sample_pairs(n, num_pairs, generator)
    else:
        i, j = (torch.tensor(np.asarray(p), dtype=torch.long) for p in pairs)
        j = torch.where(i == j, (j + 1) % n, j)
    delta = transform.apply(x[i.to(dev)] - x[j.to(dev)])
    csq = torch.cumsum(delta * delta, dim=1)
    partial_sq = csq[:, table.dims.long().to(dev) - 1]  # (P, S)
    exact = torch.sqrt(torch.clamp_min(csq[:, -1], 1e-30))
    est = torch.sqrt(torch.clamp_min(partial_sq * table.scale.to(dev)[None, :], 0.0))
    ratio = est / exact[:, None] - 1.0
    return torch.mean((ratio > table.eps.to(dev)[None, :]).float(), dim=0)


def adsampling_table(transform: OrthogonalTransform, *, eps0: float = 2.1,
                     delta_d: int = 32) -> EpsilonTable:
    """ADSampling's data-oblivious thresholds: eps_d = eps0/sqrt(d), scale D/d."""
    dim = transform.dim
    dims = expansion_schedule(dim, delta_d, device=transform.device)
    d_f = dims.float()
    eps = eps0 / torch.sqrt(d_f)
    scale = dim / d_f
    eps[-1] = 0.0
    scale[-1] = 1.0
    # JL-type bounds are symmetric: reuse eps for the lower tail.
    return EpsilonTable(dims=dims, eps=eps, scale=scale, eps_lo=eps.clone())
