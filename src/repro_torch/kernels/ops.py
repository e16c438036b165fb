"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

Handles padding to tile boundaries, table resampling to the kernel's
block-checkpoint schedule, per-(query, block) int8 query quantization, the
row→tile offset table of the IVF scan and the visited bitmap of the graph
wave.  A kernel runs where its tensors live: on a CUDA tensor the
hand-written kernel (``dade_dco``, ``quant_dco``, ``ivf_scan``,
``graph_scan``) launches, on a CPU tensor its plain oracle in ``ref``
runs; ``use_ref=True`` asks the flat screens for the plain oracle on
either device.

Shape contract: offset tables use sentinel ``-1`` for steps that must ship
nothing; every non-negative offset stays inside the flat layout's tile
count.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.estimators import Estimator, blocked_schedule, kernel_spec
from repro_torch.kernels import graph_scan
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dade_dco import dade_dco_kernel_call
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.kernels.quant_dco import quant_dco_kernel_call
from repro_torch.kernels.tiles import sqrt_rn
from repro_torch.quant.scalar import cum_err_sq, quantize_queries_block

__all__ = [
    "dco_screen_kernel", "quant_screen_kernel", "ivf_scan_kernel", "ivf_scan_inputs", "ivf_cap_tiles", "build_window_offsets",
    "block_table", "fused_fetch_totals", "graph_vis_words", "unpack_vis",
    "pack_vis_ranges", "graph_scan_inputs", "graph_scan_kernel", "graph_walk_inputs",
    "pow2_bucket", "pad_live_rows",
]


def fused_fetch_totals(stats, block_q: int):
    """(s1_tiles_fetched, s2_slabs_fetched) totals from fused-scan stats:
    the tile-level counters (columns 4-5) repeat on every query row of a
    tile, so the first row of each tile carries the per-tile totals."""
    st = stats.detach().cpu().numpy() if isinstance(stats, torch.Tensor) else np.asarray(stats)
    first = st[::block_q]
    return float(first[:, 5].sum()), float(first[:, 4].sum())


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= ``n`` (minimum 1): the bucket grid of the
    continuous engines.  Launch dimensions that vary per wave (live-set
    tile counts, frontier step counts) round up to it, so a serving run
    sees at most ``log2(max)`` shapes per dimension."""
    if n < 1:
        raise ValueError(f"pow2_bucket needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def pad_live_rows(x, live_rows: int, bucket_rows: int, *, fill):
    """Pad the stacked live-slot rows of a continuous launch (a numpy array
    or a tensor, padded on its own device) up to the pow2 bucket with
    ``fill``, the inert value the batch path pads with.  Fails fast on a
    stack that disagrees with the declared live count (stale slot rows
    would ride into the kernel as if live) and on a bucket that is not a
    power of two."""
    if x.shape[0] != live_rows:
        raise ValueError(
            f"live-set stack has {x.shape[0]} rows, caller declared "
            f"{live_rows} live — refusing to launch stale slot rows")
    if bucket_rows < live_rows:
        raise ValueError(
            f"bucket of {bucket_rows} rows cannot hold {live_rows} live rows")
    if bucket_rows & (bucket_rows - 1):
        raise ValueError(
            f"bucket_rows={bucket_rows} is not a power of two — the "
            f"bucket grid needs pow2_bucket sizing")
    if bucket_rows == live_rows:
        return x
    shape = (bucket_rows - live_rows,) + tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)])
    x = np.asarray(x)
    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)


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


_PAD_SENTINEL = 1e18  # huge-but-finite: pad rows prune at the first block


def dco_screen_kernel(
    estimator: Estimator,
    q_rot: torch.Tensor,  # (Q, D) rotated queries
    cands_rot: torch.Tensor,  # (N, D) rotated candidates
    r_sq: torch.Tensor,  # (Q,)
    *,
    block_q: int = 128,
    block_c: int = 128,
    block_d: int = 128,
    use_ref: bool = False,
):
    """Public entry of the fp32 DCO screen: pads, resamples the table onto
    the ``block_d`` checkpoints and runs ``dade_dco_kernel_call`` (or, with
    ``use_ref``, its plain version).  Returns (est_sq (Q, N) f32, passed
    (Q, N) bool, dims_used (Q, N) int32), cropped to the caller's shapes.
    """
    qn, dim = q_rot.shape
    n = cands_rot.shape[0]
    dev = cands_rot.device
    spec = kernel_spec(estimator, dim, block_d)
    eps, scale = spec.eps.to(dev), spec.scale.to(dev)
    q = _pad_axis(q_rot.to(dev).float(), 1, block_d, 0.0)
    c = _pad_axis(cands_rot.float(), 1, block_d, 0.0)
    q = _pad_axis(q, 0, block_q, 0.0)
    c = _pad_axis(c, 0, block_c, _PAD_SENTINEL)
    r = _pad_axis(r_sq.to(dev).float(), 0, block_q, 0.0)
    if use_ref:
        est_sq, passed, dims = _ref.dade_dco_ref(q, c, eps, scale, r, block_d=block_d)
    else:
        est_sq, passed, dims = dade_dco_kernel_call(
            q, c, eps, scale, r, block_q=block_q, block_c=block_c, block_d=block_d)
    return est_sq[:qn, :n], passed[:qn, :n].bool(), dims[:qn, :n]


def quant_screen_kernel(
    estimator: Estimator,
    q_rot: torch.Tensor,  # (Q, D) rotated fp32 queries
    codes: torch.Tensor,  # (N, D) int8 corpus codes
    scales: torch.Tensor,  # (D,) per-dimension quantization scales
    r_sq: torch.Tensor,  # (Q,)
    *,
    block_q: int = 128,
    block_c: int = 128,
    block_d: int = 128,
    slack: float = 1e-4,
    use_ref: bool = False,
):
    """Public entry of the int8 lower-bound prefilter: pads, resamples the
    table, derives the cumulative error band E(d) from the scales and runs
    ``quant_dco_kernel_call`` (or, with ``use_ref``, its plain version).
    Returns (lb_sq (Q, N) f32, pruned (Q, N) bool, lb_dims (Q, N) int32),
    cropped.  Padded dimensions carry zero codes and zero scales, so they
    add nothing to the distance or the band; pad rows are zero codes.
    """
    qn, dim = q_rot.shape
    n = codes.shape[0]
    dev = codes.device
    spec = kernel_spec(estimator, dim, block_d)
    eps, scale = spec.eps.to(dev), spec.scale.to(dev)
    sc = _pad_axis(scales.to(dev).float(), 0, block_d, 0.0)
    ecum = sqrt_rn(cum_err_sq(sc, (torch.arange(spec.s_steps, device=dev) + 1) * block_d))
    q = _pad_axis(q_rot.to(dev).float(), 1, block_d, 0.0)
    q = _pad_axis(q, 0, block_q, 0.0)
    c = _pad_axis(codes, 1, block_d, 0)
    c = _pad_axis(c, 0, block_c, 0)
    r = _pad_axis(r_sq.to(dev).float(), 0, block_q, 0.0)
    if use_ref:
        lb_sq, pruned, lb_dims = _ref.quant_dco_ref(
            q, c, sc, eps, scale, ecum, r, block_d=block_d, slack=slack)
    else:
        lb_sq, pruned, lb_dims = quant_dco_kernel_call(
            q, c, sc, eps, scale, ecum, r, block_q=block_q, block_c=block_c,
            block_d=block_d, slack=slack)
    return lb_sq[:qn, :n], pruned[:qn, :n].bool(), lb_dims[:qn, :n]


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


def graph_vis_words(n_nodes: int) -> int:
    """Packed visited-bitmap width (int32 words) for ``n_nodes`` graph
    nodes: ``ceil(n_nodes / 32)`` rounded up to a multiple of 128, the
    reference's layout (sharded walks size it with the GLOBAL node count)."""
    words = (max(n_nodes, 1) + 31) // 32
    return (words + 127) // 128 * 128


def unpack_vis(vis, n_nodes: int) -> np.ndarray:
    """(q_tiles, W) packed int32 bitmap -> (q_tiles, n_nodes) bool mask on
    the host (bit ``v % 32`` of word ``v // 32``; bit 31 is the sign bit)."""
    vis = vis.cpu().numpy() if isinstance(vis, torch.Tensor) else np.asarray(vis)
    vis = vis.astype(np.int32, copy=False)
    bits = (vis[:, :, None] >> np.arange(32, dtype=np.int32)) & 1
    return bits.reshape(vis.shape[0], -1)[:, :n_nodes].astype(bool)


def pack_vis_ranges(n_nodes: int, ranges) -> np.ndarray:
    """(W,) packed int32 bitmap with every node of ``ranges`` (an iterable
    of (base, count) node ranges) set: the tombstone mask.  OR-ed into a
    walk's starting bitmap it makes those nodes pre-visited, so frontier
    selection never proposes them and the walk never expands their
    adjacency; the kernel's own OR-marking composes with the pre-set bits.
    Bit layout as :func:`unpack_vis`."""
    words = np.zeros((graph_vis_words(n_nodes),), np.uint32)
    for b, c in ranges:
        b, c = int(b), int(c)
        if c < 0 or b < 0 or b + c > n_nodes:
            raise ValueError(
                f"tombstone range [{b}, {b + c}) outside corpus [0, {n_nodes})")
        v = np.arange(b, b + c)
        np.bitwise_or.at(words, v // 32, np.uint32(1) << (v % 32).astype(np.uint32))
    return words.view(np.int32)


def graph_scan_inputs(
    estimator: Estimator,
    q_rot: torch.Tensor,  # (Q, D) rotated fp32 queries, tile-grouped by caller
    step_offs: torch.Tensor,  # (ceil(Q/block_q), steps) int TILE offsets, -1 skip
    top0_sq: torch.Tensor,  # (Q, EF) f32 beam window carried across waves
    top0_ids: torch.Tensor,  # (Q, EF) int32
    r0_sq: torch.Tensor,  # (Q,) f32 thresholds carried across waves
    adj_rot: torch.Tensor,  # (N_adj, D_pad) f32/bf16 adjacency-flat rows
    adj_codes: torch.Tensor,  # (N_adj, D_pad) int8 per-block codes
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32 corpus per-block scales
    vis0: torch.Tensor | None = None,  # (q_tiles, W) int32 packed bitmap
    *,
    vis_base: int = 0,  # global node id of local tile 0
    vis_nodes: int | None = None,  # global node count the bitmap covers
    ef: int,
    thresh_col: int | None = None,
    block_q: int = graph_scan.KERNEL_TILE[0],
    block_c: int = graph_scan.KERNEL_TILE[1],
    block_d: int = 32,
    slack: float = 1e-4,
    tighten: bool = True,
):
    """The padded ``(args, kwargs)`` of the ``graph_scan_kernel_call`` that
    :func:`graph_scan_kernel` makes for these arguments, on the device of
    ``adj_rot``.

    Queries are padded to ``block_q`` rows with inf/-1 window entries and
    r² = 0, so pad rows prune at the first checkpoint and never touch the
    outputs.  ``vis0=None`` starts an all-clear bitmap of
    ``graph_vis_words(vis_nodes)`` words per query tile; ``vis_nodes``
    defaults to ``vis_base`` plus the local tile count.
    """
    qn, dim = q_rot.shape
    n_adj, d_pad = adj_rot.shape
    if d_pad % block_d or bscales.shape[0] != d_pad // block_d:
        raise ValueError(
            f"adjacency dim {d_pad} must be a multiple of block_d "
            f"{block_d} with one block scale per block")
    if n_adj % block_c:
        raise ValueError(f"adjacency rows {n_adj} % block_c {block_c} != 0")
    spec = kernel_spec(estimator, dim, block_d)
    if spec.d_pad != d_pad:
        raise ValueError(
            f"blocked table spans {spec.d_pad} dims, adjacency has {d_pad}")
    dev = adj_rot.device
    eps, scale = spec.eps.to(dev), spec.scale.to(dev)

    q = _pad_axis(q_rot.to(dev).float(), 1, block_d, 0.0)
    q = _pad_axis(q, 0, block_q, 0.0)
    qcodes, qscales = quantize_queries_block(q, block_d)
    t_sq = _pad_axis(top0_sq.to(dev).float(), 0, block_q, float("inf"))
    t_ids = _pad_axis(top0_ids.to(dev, torch.int32), 0, block_q, -1)
    r0 = _pad_axis(r0_sq.to(dev).float(), 0, block_q, 0.0)

    q_tiles = q.shape[0] // block_q
    n_tiles = n_adj // block_c
    vis_base = int(vis_base)
    if vis_nodes is None:
        vis_nodes = vis_base + n_tiles
    if vis_base < 0 or vis_base + n_tiles > vis_nodes:
        raise ValueError(
            f"vis_base={vis_base} with {n_tiles} local tiles overruns the "
            f"{vis_nodes}-node global bitmap")
    words = graph_vis_words(vis_nodes)
    if vis0 is None:
        vis0 = torch.zeros((q_tiles, words), dtype=torch.int32, device=dev)
    elif tuple(vis0.shape) != (q_tiles, words):
        raise ValueError(
            f"visited bitmap is {tuple(vis0.shape)}, need ({q_tiles}, {words}) "
            f"(= graph_vis_words({vis_nodes}) words per query tile)")
    # Offsets on the host (the beam walk's) are range-checked here; the
    # kernel reads tile `off` unchecked.
    if step_offs.device.type == "cpu" and step_offs.numel() and (
            int(step_offs.min()) < -1 or int(step_offs.max()) >= n_tiles):
        raise ValueError(f"step offsets must be -1 or in [0, {n_tiles})")
    offs = step_offs.to(dev, torch.int32)
    if thresh_col is None:
        thresh_col = ef - 1
    args = (offs, qcodes, q, qscales, t_sq, t_ids, r0, vis0.to(dev, torch.int32),
            adj_codes, adj_rot, adj_ids, bscales, eps, scale, vis_base)
    return args, dict(ef=ef, thresh_col=thresh_col, block_q=block_q,
                      block_c=block_c, block_d=block_d, slack=slack,
                      tighten=tighten)


def graph_scan_kernel(estimator: Estimator, q_rot: torch.Tensor, *args, **kwargs):
    """Public entry for one fused graph beam-scan wave; arguments as
    :func:`graph_scan_inputs`.  Returns (top_sq (Q, EF) ascending, top_ids
    (Q, EF), stats (Q, 6) f32 — see ``ref.STATS_COLS``, vis (q_tiles, W)
    int32), cropped to Q — feed top/r²/vis back in to continue the beam."""
    call_args, call_kwargs = graph_scan_inputs(estimator, q_rot, *args, **kwargs)
    top_sq, top_ids, stats, vis = graph_scan.graph_scan_kernel_call(
        *call_args, **call_kwargs)
    qn = q_rot.shape[0]
    return top_sq[:qn], top_ids[:qn], stats[:qn], vis


def graph_walk_inputs(
    estimator: Estimator,
    q_rot: torch.Tensor,  # (Q, D) rotated fp32 queries, tile-grouped by caller
    top0_sq: torch.Tensor,  # (Q, EF) f32 seeded window
    top0_ids: torch.Tensor,  # (Q, EF) int32
    seed_sq: torch.Tensor,  # (Q,) f32 threshold floor (inf: none)
    adj_rot: torch.Tensor,  # (N_adj, D_pad) f32/bf16 adjacency-flat rows
    adj_codes: torch.Tensor,  # (N_adj, D_pad) int8 per-block codes
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32 corpus per-block scales
    *,
    entry: int,
    ef: int,
    thresh_col: int,
    expand: int,
    max_waves: int,
    route_mult: float = 1.0,
    block_q: int = graph_scan.KERNEL_TILE[0],
    block_c: int = graph_scan.KERNEL_TILE[1],
    block_d: int = 32,
    slack: float = 1e-4,
    vis0: torch.Tensor | None = None,
):
    """The padded ``(args, kwargs)`` of the ``graph_walk_kernel_call`` (or
    ``ref.graph_walk_ref``) that walks these queries through the whole
    single-shard graph, on the device of ``adj_rot``: the
    :func:`graph_scan_inputs` padding (pad rows carry an empty window and a
    threshold floor of 0, and pick nothing), the starting bitmap (``vis0``
    (q_tiles, W), its set bits never expanded — the tombstones; None: all
    clear), and the walk's schedule — the entry point, ``expand`` picks per
    query and wave, the gate r² · ``route_mult``, at most ``max_waves``
    waves."""
    qn = q_rot.shape[0]
    q_tiles = -(-qn // block_q)
    args, kw = graph_scan_inputs(
        estimator, q_rot, torch.full((q_tiles, 1), -1, dtype=torch.int32),
        top0_sq, top0_ids, seed_sq, adj_rot, adj_codes, adj_ids, bscales,
        vis0=vis0, ef=ef, thresh_col=thresh_col, block_q=block_q, block_c=block_c,
        block_d=block_d, slack=slack)
    (_, qcodes, q, qscales, t_sq, t_ids, seed, vis0, codes, rows, ids, bs, eps,
     scale, _) = args
    walk_args = (qcodes, q, qscales, t_sq, t_ids, seed, vis0, codes, rows, ids,
                 bs, eps, scale)
    return walk_args, dict(entry=int(entry), qn=qn, ef=ef, thresh_col=thresh_col,
                           expand=expand, max_waves=max_waves,
                           route_mult=float(route_mult), block_q=block_q,
                           block_c=block_c, block_d=block_d, slack=slack)
