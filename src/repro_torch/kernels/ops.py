"""Public wrappers around the fused IVF scan (port of the IVF parts of
``repro.kernels.ops``).

Handles padding to tile boundaries, table resampling to the kernel's
block-checkpoint schedule, per-(query, block) int8 query quantization and
the row→tile offset table.  The scan itself runs where its tensors live:
on a CUDA tensor the hand-written kernel (``ivf_scan.ivf_scan_kernel_call``)
launches, on a CPU tensor the plain oracle ``ref.ivf_scan_ref`` runs.

Shape contract: offset tables use sentinel ``-1`` for steps that must ship
nothing; every non-negative offset stays inside the flat layout's tile
count.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.estimators import Estimator, blocked_schedule, kernel_spec
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.quant.scalar import quantize_queries_block

__all__ = [
    "ivf_scan_kernel", "ivf_scan_inputs", "ivf_cap_tiles", "build_window_offsets",
    "block_table", "fused_fetch_totals",
]


def fused_fetch_totals(stats, block_q: int):
    """(s1_tiles_fetched, s2_slabs_fetched) totals from fused-scan stats:
    the tile-level counters (columns 4-5) repeat on every query row of a
    tile, so the first row of each tile carries the per-tile totals."""
    st = stats.detach().cpu().numpy() if isinstance(stats, torch.Tensor) else np.asarray(stats)
    first = st[::block_q]
    return float(first[:, 5].sum()), float(first[:, 4].sum())


def ivf_cap_tiles(max_bucket: int, block_c: int, *, starts_aligned: bool) -> int:
    """Candidate tiles per probe window: ceil(max_bucket / block_c) for
    tile-aligned starts, one slack tile more otherwise."""
    if starts_aligned:
        return max((max_bucket + block_c - 1) // block_c, 1)
    return max((max_bucket + 2 * block_c - 2) // block_c, 1)


def build_window_offsets(window_starts, window_rows, *, block_c: int,
                         cap_tiles: int, n_pad: int) -> torch.Tensor:
    """(QT, P) bucket row starts/sizes -> (QT, P, cap_tiles) int32 per-step
    tile offsets; steps past a bucket's span carry -1 (ship nothing)."""
    starts = window_starts.to(torch.int64)
    rows = window_rows.to(torch.int64)
    base = starts // block_c
    span = (starts % block_c + rows + block_c - 1) // block_c  # tiles used
    t_idx = torch.arange(cap_tiles, device=starts.device)[None, None, :]
    max_tile = n_pad // block_c - 1
    offs = torch.clamp(base[:, :, None] + t_idx, 0, max_tile)
    return torch.where(t_idx < span[:, :, None], offs,
                       torch.full_like(offs, -1)).to(torch.int32)


def block_table(table: EpsilonTable, dim: int, block_d: int):
    """Resample an EpsilonTable onto the kernel's block grid; returns
    ``(eps, scale, d_pad, eps_lo)`` on the table's device (the rule is
    :func:`repro_torch.core.estimators.blocked_schedule`)."""
    eps, scale, eps_lo, d_pad = blocked_schedule(table, dim, block_d)
    dev = table.eps.device
    return (torch.as_tensor(eps, device=dev), torch.as_tensor(scale, device=dev),
            d_pad, torch.as_tensor(eps_lo, device=dev))


def _pad_axis(x: torch.Tensor, axis: int, to: int, value) -> torch.Tensor:
    rem = (-x.shape[axis]) % to
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)],
                     dim=axis)


def ivf_scan_inputs(
    estimator: Estimator,
    q_rot: torch.Tensor,  # (Q, D) rotated fp32 queries, tile-grouped by caller
    window_starts: torch.Tensor,  # (ceil(Q/block_q), P) flat ROW offsets
    window_rows: torch.Tensor,  # (ceil(Q/block_q), P) bucket sizes
    flat_rot: torch.Tensor,  # (N_pad, D_pad) f32/bf16 cluster-contiguous corpus
    flat_codes: torch.Tensor,  # (N_pad, D_pad) int8 per-block codes
    flat_ids: torch.Tensor,  # (N_pad,) int32, -1 tail padding
    bscales: torch.Tensor,  # (S,) f32 corpus per-block scales
    r0_sq: torch.Tensor,  # (Q,) f32 seeded initial squared thresholds
    top0_sq: torch.Tensor | None = None,  # (Q, K) f32 seeded top-K window
    top0_ids: torch.Tensor | None = None,  # (Q, K) int32 seeded top-K ids
    *,
    k: int,
    max_bucket: int,
    block_d: int,
    block_q: int = KERNEL_TILE[0],
    block_c: int = KERNEL_TILE[1],
    starts_aligned: bool = False,
    slack: float = 1e-4,
):
    """The padded ``(args, kwargs)`` of the ``ivf_scan_kernel_call`` that
    :func:`ivf_scan_kernel` makes for these arguments.

    ``window_starts[i, p]`` / ``window_rows[i, p]`` are the flat row offset
    and size of the p-th bucket probed by query tile i.
    """
    qn, dim = q_rot.shape
    n_pad, d_pad = flat_rot.shape
    if d_pad % block_d or bscales.shape[0] != d_pad // block_d:
        raise ValueError(
            f"flat corpus dim {d_pad} must be a multiple of block_d "
            f"{block_d} with one block scale per block")
    if n_pad % block_c:
        raise ValueError(f"flat corpus rows {n_pad} % block_c {block_c} != 0")
    cap_tiles = ivf_cap_tiles(max_bucket, block_c, starts_aligned=starts_aligned)
    if cap_tiles > n_pad // block_c:
        raise ValueError("flat corpus tail padding too small for max_bucket")

    spec = kernel_spec(estimator, dim, block_d)
    if spec.d_pad != d_pad:
        raise ValueError(
            f"blocked table spans {spec.d_pad} dims, flat corpus has {d_pad}")
    dev = flat_rot.device
    eps, scale = spec.eps.to(dev), spec.scale.to(dev)

    q = _pad_axis(q_rot.float(), 1, block_d, 0.0)
    q = _pad_axis(q, 0, block_q, 0.0)
    qcodes, qscales = quantize_queries_block(q, block_d)
    r0 = _pad_axis(r0_sq.float(), 0, block_q, 0.0)
    # Pad rows seed empty like the r²=0 pad rows — they prune instantly.
    if top0_sq is None:
        t0_sq = torch.full((q.shape[0], k), float("inf"), device=dev)
        t0_ids = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev)
    else:
        t0_sq = _pad_axis(top0_sq.float(), 0, block_q, float("inf"))
        t0_ids = _pad_axis(top0_ids.to(torch.int32), 0, block_q, -1)

    tile_offs = build_window_offsets(
        window_starts, window_rows, block_c=block_c, cap_tiles=cap_tiles,
        n_pad=n_pad)

    args = (tile_offs, qcodes, q, qscales, r0, t0_sq, t0_ids, flat_codes,
            flat_rot, flat_ids, bscales, eps, scale)
    return args, dict(k=k, block_q=block_q, block_c=block_c, block_d=block_d,
                      cap_tiles=cap_tiles, slack=slack)


def ivf_scan_kernel(estimator: Estimator, q_rot: torch.Tensor, *args, **kwargs):
    """Public entry for the fused IVF wave scan; arguments as
    :func:`ivf_scan_inputs`.  Returns (top_sq (Q, K) ascending, top_ids
    (Q, K), stats (Q, 6) f32 — see ``ref.STATS_COLS``), cropped to Q.
    """
    call_args, call_kwargs = ivf_scan_inputs(estimator, q_rot, *args, **kwargs)
    top_sq, top_ids, stats = ivf_scan_kernel_call(*call_args, **call_kwargs)
    qn = q_rot.shape[0]
    return top_sq[:qn], top_ids[:qn], stats[:qn]
