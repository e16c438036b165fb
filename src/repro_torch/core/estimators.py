"""Distance estimators: FDScanning, ADSampling, DADE (paper §3, §4.1);
port of ``repro.core.estimators``.

An :class:`Estimator` bundles the orthogonal transform, the epsilon table
and the scale table.  The fused kernel is method-oblivious: it reads the
blocked per-checkpoint ``eps``/``scale`` arrays as data
(:func:`kernel_spec`), never the method name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import calibration as calib
from repro_torch.core import transforms as tf
from repro_torch.quant.scalar import QuantConfig

__all__ = [
    "Estimator", "EstimatorSpec", "UnsupportedMethodError", "build_estimator",
    "kernel_spec", "blocked_schedule", "first_enabled_eps", "EPS_DISABLED",
    "SEED_SLACK",
]

# Sentinel epsilon for a DISABLED checkpoint: ``(1+EPS_DISABLED)^2 ~ 1e38``
# stays finite in fp32, so a disabled threshold is astronomically loose for
# real rows yet still collapses to 0 for pad rows (which carry r^2 = 0).
EPS_DISABLED = 1.0e19

# Relative float slack applied to SEEDED thresholds, so a method whose first
# epsilon is 0 stays sound when the k-th neighbour is itself a seed row.
SEED_SLACK = 1e-5

_FIXED_DIM_METHODS = ("pca_fixed", "rp_fixed")


class UnsupportedMethodError(ValueError):
    """The fused kernel cannot express this estimator.

    The demand-paged pipeline retires every surviving row with the EXACT
    full-D distance at its final checkpoint; the fixed-dimension projection
    baselines (pca_fixed / rp_fixed) end on an approximate estimate, so
    they are refused by name."""


@dataclasses.dataclass(frozen=True)
class Estimator:
    method: str
    transform: tf.OrthogonalTransform
    table: calib.EpsilonTable
    quant: QuantConfig | None = None

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        return self.transform.apply(x)


def _single_checkpoint_table(dim: int, device) -> calib.EpsilonTable:
    return calib.EpsilonTable(
        dims=torch.tensor([dim], dtype=torch.int32, device=device),
        eps=torch.zeros(1, device=device),
        scale=torch.ones(1, device=device),
        eps_lo=torch.zeros(1, device=device),
    )


def build_estimator(
    method: str,
    data,
    generator: torch.Generator | None = None,
    *,
    p_s: float = 0.1,
    delta_d: int = 32,
    eps0: float = 2.1,
    num_pairs: int = 4096,
    quant: QuantConfig | str | None = None,
    pairs=None,
    device: str | torch.device = "cuda",
) -> Estimator:
    """Fit an estimator on a corpus sample (``fdscanning``, ``adsampling``
    or ``dade``).  ``generator`` (a CPU ``torch.Generator``, seed 0 when
    omitted) replaces the reference's ``jax.random`` key; ``pairs`` passes
    DADE's calibration pairs explicitly."""
    if method in _FIXED_DIM_METHODS:
        raise UnsupportedMethodError(
            f"method {method!r} ends on an approximate fixed-dimension "
            f"estimate, which the fused kernel cannot express")
    if isinstance(quant, str):
        quant = None if quant in ("", "none") else QuantConfig(
            bits=int(quant.removeprefix("int")))
    dev = resolve_device(device)
    x = tf.as_tensor(data, dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    if method == "fdscanning":
        transform = tf.identity_transform(x, device=dev)
        table = _single_checkpoint_table(x.shape[1], dev)
    elif method == "adsampling":
        transform = tf.fit_random_orthogonal(x, generator, device=dev)
        table = calib.adsampling_table(transform, eps0=eps0, delta_d=delta_d)
    elif method == "dade":
        transform = tf.fit_pca(x, device=dev)
        table = calib.calibrate(transform, x, generator, p_s=p_s,
                                delta_d=delta_d, num_pairs=num_pairs,
                                pairs=pairs)
    else:
        raise ValueError(f"unknown DCO method: {method}")
    return Estimator(method=method, transform=transform, table=table,
                     quant=quant)


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """An estimator's epsilon table resampled onto the kernel's ``block_d``
    checkpoint grid (see :func:`blocked_schedule` for the rule)."""

    method: str
    block_d: int
    d_pad: int
    eps: torch.Tensor      # (S,) float32 per-checkpoint epsilon
    scale: torch.Tensor    # (S,) float32 per-checkpoint unbias factor
    eps_lo: torch.Tensor   # (S,) float32 lower-tail band (0 where disabled)

    @property
    def s_steps(self) -> int:
        return self.d_pad // self.block_d


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def blocked_schedule(table: calib.EpsilonTable, dim: int, block_d: int):
    """Resample an EpsilonTable onto the block-checkpoint grid.

    Checkpoints at or past a calibrated dim take the entry at the largest
    calibrated dim <= checkpoint; checkpoints below the first calibrated dim
    are disabled (``EPS_DISABLED``); the terminal checkpoint is the exact
    retire (eps 0, scale 1).  Returns numpy ``(eps, scale, eps_lo, d_pad)``.
    """
    dims = _np(table.dims)
    eps = _np(table.eps)
    eps_lo = _np(table.eps_lo)
    scale = _np(table.scale)
    first_cal = int(dims[0])
    d_pad = ((dim + block_d - 1) // block_d) * block_d
    out_eps, out_scale, out_lo = [], [], []
    for s in range(d_pad // block_d):
        cp = min((s + 1) * block_d, dim)
        if cp >= dim:
            out_eps.append(0.0)
            out_scale.append(1.0)
            out_lo.append(0.0)
        elif cp < first_cal:
            out_eps.append(EPS_DISABLED)
            out_scale.append(1.0)
            out_lo.append(0.0)
        else:
            i = int(np.searchsorted(dims, cp, side="right")) - 1
            out_eps.append(float(eps[i]))
            out_scale.append(float(scale[i]))
            out_lo.append(float(eps_lo[i]))
    return (np.asarray(out_eps, np.float32), np.asarray(out_scale, np.float32),
            np.asarray(out_lo, np.float32), d_pad)


def kernel_spec(estimator: Estimator, dim: int, block_d: int) -> EstimatorSpec:
    """Blocked kernel view of an estimator; the single fused entry gate.

    Raises :class:`UnsupportedMethodError` when the terminal checkpoint is
    not the exact full-D retire (checked on the table, not the name)."""
    table = estimator.table
    last_dim = int(_np(table.dims)[-1])
    last_eps = float(_np(table.eps)[-1])
    last_scale = float(_np(table.scale)[-1])
    if last_dim < dim or last_eps != 0.0 or last_scale != 1.0:
        raise UnsupportedMethodError(
            f"method {estimator.method!r} is not expressible in the fused "
            f"kernel: its terminal checkpoint (dim {last_dim}, eps "
            f"{last_eps}, scale {last_scale}) is not the exact full-D retire "
            f"(dim >= {dim}, eps 0, scale 1)")
    eps, scale, eps_lo, d_pad = blocked_schedule(table, dim, block_d)
    dev = table.eps.device
    return EstimatorSpec(
        method=estimator.method, block_d=block_d, d_pad=d_pad,
        eps=torch.as_tensor(eps, device=dev),
        scale=torch.as_tensor(scale, device=dev),
        eps_lo=torch.as_tensor(eps_lo, device=dev),
    )


def first_enabled_eps(eps: torch.Tensor) -> torch.Tensor:
    """First non-disabled checkpoint epsilon of a blocked schedule (0 when
    every checkpoint is disabled) — the seed-widening epsilon."""
    enabled = eps < EPS_DISABLED / 2
    idx = torch.argmax(enabled.to(torch.int32))
    return torch.where(enabled.any(), eps[idx], torch.zeros_like(eps[idx]))
