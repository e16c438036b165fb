"""IVF index served by the fused wave-scan kernel (port of the fused route
of ``repro.index.ivf``).

Build: k-means coarse quantizer in the *rotated* space, then a CSR flat
layout: rows cluster-contiguous, every cluster start aligned to the
128-row tile grid (sentinel gap rows between clusters, sentinel tail), dims
zero-padded to the kernel's block grid, per-BLOCK int8 codes for the
kernel's stage 1.  Per-dimension int8 codes in the same layout feed the
threshold seed.

Search: queries are grouped into tiles by nearest centroid, each tile probes
its best buckets by rank-weighted votes, and one kernel launch streams every
(tile, probe) bucket window, screening, refining and keeping the top-K on
the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.estimators import (
    SEED_SLACK, Estimator, build_estimator, kernel_spec,
)
from repro_torch.core.transforms import as_tensor
from repro_torch.index.kmeans import kmeans
from repro_torch.kernels.ivf_scan import KERNEL_TILE, ivf_scan_kernel_call
from repro_torch.kernels.ops import fused_fetch_totals, ivf_scan_inputs
from repro_torch.obs.trace import current_tracer
from repro_torch.quant.accounting import (
    ID_BYTES, fetched_tile_bytes, stage2_fetch_report, two_stage_bytes,
)
from repro_torch.quant.scalar import (
    fit_block_scales, fit_scales, quantize, quantize_block,
)

__all__ = ["IVFIndex", "build_ivf", "search_ivf_fused", "fused_search_inputs",
           "FusedScanStats", "SENTINEL", "ALIGN"]

SENTINEL = 1e18  # huge-but-finite pad row value: prunes at the first block
ALIGN = 128      # cluster starts sit on this row grid
# The fused search's (query, candidate) tile: probes are routed per query
# tile, so the width is part of the result; 8 is the reference's default.
BLOCK_Q, BLOCK_C = 8, KERNEL_TILE[1]


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    estimator: Estimator
    centroids: torch.Tensor  # (Nc, D) rotated space
    bucket_sizes: torch.Tensor  # (Nc,) int32
    starts: torch.Tensor  # (Nc + 1,) int32 aligned flat row offsets
    flat_rot: torch.Tensor  # (N_pad, D_pad) f32, SENTINEL gaps/tail
    flat_codes: torch.Tensor  # (N_pad, D_pad) int8 per-block codes
    flat_ids: torch.Tensor  # (N_pad,) int32, -1 gaps/tail
    bscales: torch.Tensor  # (D_pad // scan_block_d,) f32
    seed_codes: torch.Tensor  # (N_pad, D) int8 per-dimension codes
    qscales: torch.Tensor  # (D,) f32 per-dimension scales
    max_bucket: int = 0
    scan_block_d: int = 0

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        """Padded bucket capacity the threshold seed scans per query."""
        return (max(1, self.max_bucket) + ALIGN - 1) // ALIGN * ALIGN

    @property
    def device(self) -> torch.device:
        return self.flat_rot.device


def flat_layout(sizes: np.ndarray, max_bucket: int):
    """(aligned starts (Nc + 1,) int64, n_pad): every cluster start on the
    ALIGN grid, tail padding so the largest window stays in bounds."""
    astarts = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum((sizes + ALIGN - 1) // ALIGN * ALIGN, out=astarts[1:])
    n_flat = int(astarts[-1])
    n_pad = (n_flat + max_bucket + 2 * ALIGN + ALIGN - 1) // ALIGN * ALIGN
    if n_pad >= np.iinfo(np.int32).max:
        raise ValueError("aligned flat layout overflows int32 offsets")
    return astarts, n_pad


def build_ivf(
    data,
    *,
    method: str = "dade",
    n_clusters: int = 256,
    kmeans_iters: int = 15,
    generator: torch.Generator | None = None,
    estimator: Estimator | None = None,
    scan_block_d: int | None = None,
    device: str | torch.device = "cuda",
    **est_kwargs,
) -> IVFIndex:
    """Build the fused-route IVF index over (N, D) data on ``device``.

    ``scan_block_d`` is the kernel's dimension-block width (default: the
    estimator's first checkpoint, so kernel checkpoints coincide with the
    calibrated table).  Only the int8 fused layout is built: the padded
    gather layout of the reference's ``search_ivf`` is not part of the port.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = as_tensor(data, dev)
    if estimator is None:
        estimator = build_estimator(method, x, generator, quant="int8",
                                    device=dev, **est_kwargs)
    rot = estimator.rotate(x)
    n, dim = rot.shape
    if n >= np.iinfo(np.int32).max:
        raise ValueError(f"corpus of {n} rows overflows int32 bucket ids")
    cents, assignment = kmeans(rot, n_clusters, kmeans_iters,
                               generator=generator, device=dev)

    block_d = (int(estimator.table.dims[0]) if scan_block_d is None
               else int(scan_block_d))
    # Refuse an estimator the kernel cannot express here, by name.
    kernel_spec(estimator, dim, block_d)
    d_pad = (dim + block_d - 1) // block_d * block_d

    order = torch.argsort(assignment, stable=True)
    sizes_t = torch.bincount(assignment, minlength=n_clusters)
    sizes = sizes_t.cpu().numpy().astype(np.int32)
    max_bucket = int(sizes.max())
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    astarts, n_pad = flat_layout(sizes, max_bucket)
    # Destination row of the r-th row of cluster c: astarts[c] + r.
    cl = assignment[order]
    rank = torch.arange(n, device=dev) - torch.as_tensor(starts, device=dev)[cl]
    dest = torch.as_tensor(astarts, device=dev)[cl] + rank

    rot_pad = torch.zeros((n, d_pad), dtype=torch.float32, device=dev)
    rot_pad[:, :dim] = rot
    bscales = fit_block_scales(rot_pad, block_d)
    qscales = fit_scales(rot)
    flat_rot = torch.full((n_pad, d_pad), SENTINEL, dtype=torch.float32, device=dev)
    flat_codes = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=dev)
    seed_codes = torch.zeros((n_pad, dim), dtype=torch.int8, device=dev)
    flat_ids = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    flat_rot[dest] = rot_pad[order]
    flat_codes[dest] = quantize_block(rot_pad[order], bscales, block_d)
    seed_codes[dest] = quantize(rot[order], qscales)
    flat_ids[dest] = order.to(torch.int32)
    return IVFIndex(
        estimator=estimator, centroids=cents,
        bucket_sizes=sizes_t.to(torch.int32),
        starts=torch.as_tensor(astarts, dtype=torch.int32, device=dev),
        flat_rot=flat_rot, flat_codes=flat_codes, flat_ids=flat_ids,
        bscales=bscales, seed_codes=seed_codes, qscales=qscales,
        max_bucket=max_bucket, scan_block_d=block_d)


def _quant_seed_rsq(index: IVFIndex, q_rot: torch.Tensor,
                    seed_bucket: torch.Tensor, k: int, *,
                    chunk: int = 128) -> torch.Tensor:
    """Quantized threshold seeding: prescreen ``seed_bucket``'s rows with
    the per-dimension int8 codes, verify the k apparent-nearest exactly and
    return the k-th exact squared distance widened by the first
    checkpoint's overshoot band (a sound initial r²: the k-th exact
    distance of any k real candidates upper-bounds the final k-th)."""
    dim = q_rot.shape[1]
    cap = index.capacity
    slot = torch.arange(cap, device=q_rot.device)
    eps0 = index.estimator.table.eps[0]
    out = []
    for lo in range(0, q_rot.shape[0], chunk):
        q = q_rot[lo:lo + chunk]
        b = seed_bucket[lo:lo + chunk].long()
        rows = index.starts[b].long()[:, None] + slot[None, :]  # (q, cap)
        valid = slot[None, :] < index.bucket_sizes[b].long()[:, None]
        deq = index.seed_codes[rows].float() * index.qscales
        approx = torch.sum((deq - q[:, None, :]) ** 2, dim=-1)
        approx = torch.where(valid, approx, torch.full_like(approx, float("inf")))
        sel = torch.argsort(approx, dim=1, stable=True)[:, :k]  # best by int8
        pick = torch.gather(rows, 1, sel)
        exact = torch.sum((index.flat_rot[pick][..., :dim] - q[:, None, :]) ** 2, dim=-1)
        exact = torch.where(torch.gather(valid, 1, sel), exact,
                            torch.full_like(exact, float("inf")))
        out.append(torch.amax(exact, dim=1))
    kth = torch.cat(out)
    t = 1.0 + eps0
    return kth * (t * t) * (1.0 + SEED_SLACK)


class FusedScanStats(NamedTuple):
    """Per-batch accounting from the fused wave scan (host-side floats);
    ``fetched_*``/``s2_*`` are fetch-granular, ``bytes_per_query`` is the
    semantic dims-consumed quantity."""

    avg_fp_dims: float
    avg_int8_dims: float
    rows_per_query: float
    bytes_per_query: float
    passed_per_query: float
    s1_tiles_fetched: float = 0.0
    s2_slabs_total: float = 0.0
    s2_slabs_fetched: float = 0.0
    s2_skip_rate: float = 0.0
    fetched_bytes_per_query: float = 0.0


def _route_tiles(index: IVFIndex, q_rot: torch.Tensor, *, n_probe: int,
                 block_q: int):
    """Tile-level probe routing: group queries into tiles of ``block_q`` by
    nearest centroid and rank each tile's buckets by rank-weighted votes
    from its queries' own top-``n_probe`` lists, tie-broken by the tile-min
    centroid distance.  Returns ``(order, inv, q_sorted, tile_buckets,
    window_starts, window_rows)``."""
    qn = q_rot.shape[0]
    cents = index.centroids
    cd = (torch.sum(q_rot * q_rot, dim=1)[:, None]
          + torch.sum(cents * cents, dim=1)[None, :]
          - 2.0 * (q_rot @ cents.T))
    nearest = torch.argmin(cd, dim=1)
    order = torch.argsort(nearest, stable=True)
    inv = torch.argsort(order)
    q_sorted = q_rot[order]
    cd_sorted = cd[order]

    q_tiles = (qn + block_q - 1) // block_q
    pad = q_tiles * block_q - qn
    nc = cd.shape[1]
    inf_rows = torch.full((pad, nc), float("inf"), device=cd.device)
    tile_cd = torch.cat([cd_sorted, inf_rows]).reshape(q_tiles, block_q, nc).amin(dim=1)
    q_probe = torch.argsort(cd_sorted, dim=1, stable=True)[:, :n_probe]
    rank_w = 1.0 / (torch.arange(n_probe, dtype=torch.float32, device=cd.device) + 1.0)
    # Rank-0 outweighs everything: every query's primary bucket gets a slot.
    rank_w[0] = float(n_probe * block_q)
    votes_q = torch.zeros((qn, nc), dtype=torch.float32, device=cd.device)
    votes_q.scatter_add_(1, q_probe, rank_w[None, :].expand(qn, n_probe))
    per_row = torch.cat([votes_q, torch.zeros((pad, nc), device=cd.device)]
                        ).reshape(q_tiles, block_q, nc)
    votes = per_row[:, 0]
    for r in range(1, block_q):  # row order of the reference's sum
        votes = votes + per_row[:, r]
    finite_cd = torch.where(torch.isfinite(tile_cd), tile_cd, torch.zeros_like(tile_cd))
    tiebreak = finite_cd / (torch.amax(finite_cd) + 1.0) * 1e-3  # < votes
    tile_buckets = torch.argsort(votes - tiebreak, dim=1, descending=True,
                                 stable=True)[:, :n_probe]
    window_starts = index.starts[tile_buckets]
    window_rows = index.bucket_sizes[tile_buckets]
    return order, inv, q_sorted, tile_buckets, window_starts, window_rows


def _fused_stats(index: IVFIndex, stats, *, qn: int, k: int,
                 block_q: int = BLOCK_Q, block_c: int = BLOCK_C,
                 seed_r: bool = True) -> FusedScanStats:
    """FusedScanStats epilogue from raw (Q, 6) kernel counters (a tensor or
    a numpy array), shared by ``search_ivf_fused`` and the continuous
    engine, so a solo slot's ledger is built by the arithmetic of the
    search (the counters are integer-valued f32: their sums are exact and
    the ledgers compare with ``==``).  The fetch counters sit on the first
    row of each ``block_q`` tile."""
    tr = current_tracer()
    if isinstance(stats, torch.Tensor):
        stats = stats.detach().cpu().numpy()
    st = np.asarray(stats, np.float64)
    rows = max(float(st[:, 2].sum()), 1.0)
    d_pad = index.flat_rot.shape[1]
    dim = index.seed_codes.shape[1]
    # Seeding streams the nearest bucket's int8 codes and k exact rows per
    # query before the launch — count those corpus bytes too.
    seed_bytes = (index.capacity * dim + 4 * k * d_pad) if seed_r else 0
    s1_tiles, s2_slabs = fused_fetch_totals(st, block_q)
    fp_itemsize = index.flat_rot.element_size()
    s2_fetched_b, _, s2_skip, s2_total = stage2_fetch_report(
        s1_tiles, s2_slabs, block_c=block_c, d_pad=d_pad,
        block_d=index.scan_block_d, fp_bytes=fp_itemsize)
    s1_bytes = fetched_tile_bytes(s1_tiles, block_c=block_c, dims=d_pad,
                                  bytes_per_dim=1, id_bytes=ID_BYTES)
    tr.instant("ivf.stage1_dma", tiles=s1_tiles, bytes=s1_bytes)
    tr.instant("ivf.stage2", slabs=s2_slabs, bytes=float(s2_fetched_b))
    fetched = s1_bytes + s2_fetched_b
    return FusedScanStats(
        avg_fp_dims=float(st[:, 1].sum()) / rows,
        avg_int8_dims=float(st[:, 0].sum()) / rows,
        rows_per_query=rows / qn,
        bytes_per_query=two_stage_bytes(float(st[:, 0].sum()),
                                        float(st[:, 1].sum())) / qn + seed_bytes,
        passed_per_query=float(st[:, 3].sum()) / qn,
        s1_tiles_fetched=s1_tiles,
        s2_slabs_total=s2_total,
        s2_slabs_fetched=s2_slabs,
        s2_skip_rate=s2_skip,
        fetched_bytes_per_query=fetched / qn + seed_bytes,
    )


def fused_search_inputs(
    index: IVFIndex,
    queries,
    *,
    k: int = 10,
    n_probe: int = 8,
    block_q: int = BLOCK_Q,
    block_c: int = BLOCK_C,
    seed_r: bool = True,
):
    """Routing and threshold seed of :func:`search_ivf_fused`: returns the
    ``(args, kwargs)`` of its one ``ivf_scan_kernel_call`` and ``inv``, the
    permutation from tile-grouped rows back to query order.  Spans
    ``ivf.route`` and ``ivf.seed`` when a tracer is installed."""
    tr = current_tracer()
    dev = index.device
    q_rot = index.estimator.rotate(as_tensor(queries, dev))
    qn = q_rot.shape[0]
    n_probe = min(n_probe, index.n_clusters)
    with tr.span("ivf.route", n_probe=n_probe):
        order, inv, q_sorted, tile_buckets, window_starts, window_rows = _route_tiles(
            index, q_rot, n_probe=n_probe, block_q=block_q)
        tr.fence(window_rows)
    with tr.span("ivf.seed", seed_r=seed_r):
        if seed_r:
            # Seed from the tile's best bucket (guaranteed scanned), so the
            # verified candidates re-enter the on-card top-K in wave 0.
            seed_bucket = torch.repeat_interleave(tile_buckets[:, 0], block_q)[:qn]
            r0 = _quant_seed_rsq(index, q_sorted, seed_bucket, k)
        else:
            r0 = torch.full((qn,), float("inf"), device=dev)
        tr.fence(r0)
    args, kwargs = ivf_scan_inputs(
        index.estimator, q_sorted, window_starts, window_rows,
        index.flat_rot, index.flat_codes, index.flat_ids, index.bscales,
        r0, k=k, max_bucket=index.max_bucket, block_q=block_q,
        block_c=block_c, block_d=index.scan_block_d,
        # Cluster starts sit on the 128-row grid; a tile width dividing it
        # inherits exact windows.
        starts_aligned=(ALIGN % block_c == 0))
    return args, kwargs, inv


def search_ivf_fused(
    index: IVFIndex,
    queries,
    *,
    k: int = 10,
    n_probe: int = 8,
    block_q: int = BLOCK_Q,
    block_c: int = BLOCK_C,
    seed_r: bool = True,
):
    """IVF search through the fused wave-scan kernel, on the index's device:
    queries grouped into tiles of ``block_q`` by nearest centroid, each tile
    probing its ``n_probe`` best buckets in ``block_c``-row candidate tiles,
    from a threshold seeded by ``seed_r`` (else r² = inf).

    Returns (dists (Q, K), ids (Q, K) int32, FusedScanStats).
    """
    tr = current_tracer()
    args, kwargs, inv = fused_search_inputs(
        index, queries, k=k, n_probe=n_probe, block_q=block_q,
        block_c=block_c, seed_r=seed_r)
    qn = inv.shape[0]
    with tr.span("ivf.launch", q_tiles=args[0].shape[0]):
        top_sq, top_ids, stats = tr.fence(tuple(
            x[:qn] for x in ivf_scan_kernel_call(*args, **kwargs)))
    dists = torch.sqrt(torch.clamp_min(top_sq, 0.0))[inv]
    ids = top_ids[inv]
    return dists, ids, _fused_stats(index, stats, qn=qn, k=k, block_q=block_q,
                                    block_c=block_c, seed_r=seed_r)
