"""NSW proximity-graph index searched by the fused graph beam scan (port of
the batched route of ``repro.index.graph``).

Build (offline): incremental NSW insertion on the host, in numpy — each
point beam-searches the current graph for its ``ef_construction`` nearest,
connects to the best ``m`` bidirectionally with hnswlib's diversity
heuristic, and over-full rows are re-selected; a medoid replaces HNSW's
upper layers as the entry point.  The numpy build code is a verbatim copy of
the reference's, so both build the same graph from the same rotated
corpus.  The int8 layout for the kernel is then laid out on the device: the
*adjacency-flat* slab, node v's neighbour rows (vectors, per-block int8
codes, ids) stored contiguously at rows ``[v·A, (v+1)·A)``, A =
``adj_block`` (``m`` rounded up to 32), pad rows sentinel-valued with id -1.

Search (``search_graph_fused``): a wave-synchronous frontier expansion over
the whole query batch.  Queries are sorted along the leading PCA
coordinate and grouped into tiles of 8; each wave, every tile's frontier —
the best unexpanded entries of its queries' beam windows that still beat
the routing radius — is screened (int8 stage 1, demand-paged fp stage 2,
the ef-sized window, r² and the packed visited bitmap carried from wave to
wave).  A tile's walk depends on nothing outside the tile, so on the card
ONE launch of the ``graph_walk`` kernel runs the whole search, each tile's
CTA picking its own frontier between waves; the host does the prologue
(rotation, tile sort, seeds) and reads the results back once.
``search_graph_beam_host`` runs the identical schedule through the plain
version ``ref.graph_walk_ref`` (``ref.graph_scan_ref`` waves with the
frontier picked by ``ref.select_wave_ref``); the two return the same
results.

Not ported here: the per-query greedy ``search_graph``, sharded walks,
tombstones and delete filters, tracing and chaos hooks.
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
from repro_torch.kernels.graph_scan import KERNEL_TILE, graph_walk_kernel_call
from repro_torch.kernels.ops import fused_fetch_totals, graph_walk_inputs
from repro_torch.kernels.ref import graph_walk_ref
from repro_torch.quant.accounting import (
    ID_BYTES, fetched_tile_bytes, row_gather_bytes, stage2_fetch_report,
    two_stage_bytes,
)
from repro_torch.quant.scalar import (
    fit_block_scales, quantize_block, quantize_corpus, wants_quant,
)

__all__ = ["GraphIndex", "build_graph", "graph_from_rotated",
           "search_graph_fused", "search_graph_beam_host", "GraphScanStats",
           "walk_inputs", "SENTINEL"]

SENTINEL = 1e18  # pad rows of a neighbour block: masked by id, never read as data
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    estimator: Estimator
    corpus_rot: torch.Tensor  # (N, D) rotated corpus
    neighbors: torch.Tensor  # (N, M) int32, -1 padded
    entry: int  # medoid entry point
    corpus_q: torch.Tensor  # (N, D) int8 per-dimension codes (threshold seed)
    qscales: torch.Tensor  # (D,) per-dimension scales
    # Adjacency-flat layout: node v's neighbour rows at [v*A, (v+1)*A).
    adj_rot: torch.Tensor  # (N*A, D_pad) f32 or bf16, SENTINEL pad rows
    adj_codes: torch.Tensor  # (N*A, D_pad) int8 per-block codes, 0 pad rows
    adj_ids: torch.Tensor  # (N*A,) int32, -1 pad rows
    gscales: torch.Tensor  # (D_pad // scan_block_d,) f32 block scales
    adj_block: int = 0
    scan_block_d: int = 0

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adj_rot.device


# ---------------------------------------------------------------------------
# The host-side build: verbatim copies of the reference's numpy functions
# (repro.index.graph), so both build the same graph from the same rotated
# corpus; the mutable index of a later slice replays them exactly.
# ---------------------------------------------------------------------------


def _greedy_search_np(rot, adj, entry, q, ef):
    """Host beam search used during construction (exact distances).

    Vectorized inner loop: a whole neighbourhood's distance updates land as
    one batched admit/merge/trim (argpartition) instead of per-neighbor
    Python list surgery — graph build is O(N·ef·M) either way, but the
    constant is numpy's, not the interpreter's.  Admission tests against
    the beam's worst *before* the batch (the sequential loop re-tested
    after every insert); that is mildly more permissive — a superset beam —
    so construction recall can only match or improve.
    """
    n = rot.shape[0]
    visited = np.zeros(n, bool)
    d0 = float(np.sum((rot[entry] - q) ** 2))
    visited[entry] = True
    cand_ids = np.asarray([entry], np.int64)
    cand_d = np.asarray([d0], np.float64)
    result_ids = np.asarray([entry], np.int64)
    result_d = np.asarray([d0], np.float64)
    while cand_ids.size:
        i = int(np.argmin(cand_d))
        cid, cd = cand_ids[i], cand_d[i]
        keep = np.ones(cand_ids.size, bool)
        keep[i] = False
        cand_ids, cand_d = cand_ids[keep], cand_d[keep]
        worst = result_d.max() if result_d.size >= ef else np.inf
        if cd > worst:
            break
        nbrs = adj[cid]
        nbrs = nbrs[(nbrs >= 0) & ~visited[nbrs]]
        if nbrs.size == 0:
            continue
        visited[nbrs] = True
        diff = rot[nbrs] - q[None, :]
        nd = np.einsum("nd,nd->n", diff, diff)
        adm = nd < worst
        if not adm.any():
            continue
        result_ids = np.concatenate([result_ids, nbrs[adm]])
        result_d = np.concatenate([result_d, nd[adm]])
        if result_d.size > ef:
            sel = np.argpartition(result_d, ef - 1)[:ef]
            result_ids, result_d = result_ids[sel], result_d[sel]
        cand_ids = np.concatenate([cand_ids, nbrs[adm]])
        cand_d = np.concatenate([cand_d, nd[adm]])
    order = np.argsort(result_d, kind="stable")
    return [int(result_ids[i]) for i in order]


def _select_heuristic_np(rot, a, cand, mmax):
    """hnswlib's diversity heuristic: keep c unless some already-selected
    s is closer to c than c is to a (preserves long-range bridges —
    distance-only trimming fragments clustered corpora).

    Module-level (not a ``build_graph`` closure) because the mutable-index
    engine (``index.mutable``) replays the EXACT build arithmetic for
    incremental upserts; any drift here would break the rebuilt-index
    bit-identity contract."""
    cand = np.unique(cand[cand >= 0])
    cand = cand[cand != a]
    if cand.size == 0:
        return cand
    d_a = np.einsum("nd,nd->n", rot[cand] - rot[a], rot[cand] - rot[a])
    order = np.argsort(d_a)
    selected: list[int] = []
    rest: list[int] = []
    for i in order:
        c, dc = cand[i], d_a[i]
        if len(selected) >= mmax:
            break
        dsel = [
            float(np.dot(rot[c] - rot[s], rot[c] - rot[s]))
            for s in selected
        ]
        if all(ds > dc for ds in dsel):
            selected.append(int(c))
        else:
            rest.append(int(c))
    # keepPrunedConnections: fill remaining slots with nearest pruned
    for c in rest:
        if len(selected) >= mmax:
            break
        selected.append(c)
    return np.asarray(selected, np.int64)


def _connect_np(rot, adj, deg, a, b, m):
    """Append edge a->b into the over-provisioned adjacency; past capacity,
    re-select a's neighbourhood to m with the diversity heuristic."""
    if deg[a] < adj.shape[1]:
        adj[a, deg[a]] = b
        deg[a] += 1
    else:
        keep = _select_heuristic_np(
            rot, a, np.concatenate([adj[a, : deg[a]], [b]]), m)
        adj[a, : len(keep)] = keep
        adj[a, len(keep):] = -1
        deg[a] = len(keep)


def _insert_node_np(rot, adj, deg, v, *, m, ef_construction):
    """One NSW insertion: beam-search the first v rows for node v's
    ``ef_construction`` nearest, connect bidirectionally to the best m.
    Returns the connect targets — every node whose adjacency row may have
    changed (the set a mutable index must re-trim)."""
    found = _greedy_search_np(rot[:v], adj[:v], 0, rot[v], ef_construction)
    targets = _select_heuristic_np(rot, v, np.asarray(found[: 2 * m]), m)
    for u in targets:
        _connect_np(rot, adj, deg, v, u, m)
        _connect_np(rot, adj, deg, u, v, m)
    return targets


def _trim_row_np(rot, adj, deg, v, m):
    """Node v's serving row: its over-provisioned adjacency trimmed to m
    (diversity-aware), -1 padded.  Depends only on (rot, adj[v], deg[v]) —
    re-trimming after every touch converges to the batch end-trim."""
    nbrs = adj[v, : deg[v]]
    if nbrs.size > m:
        nbrs = _select_heuristic_np(rot, v, nbrs, m)
    out = np.full((m,), -1, np.int64)
    out[: nbrs.size] = nbrs
    return out


def _medoid_entry_np(rot):
    """The build's entry rule: the node nearest the corpus mean."""
    return int(np.argmin(
        np.einsum("nd,nd->n", rot - rot.mean(0), rot - rot.mean(0))))


def graph_from_rotated(
    rot: np.ndarray,  # (N, D) float32 corpus in the estimator's basis
    estimator: Estimator,
    *,
    m: int = 16,
    ef_construction: int = 100,
    scan_block_d: int | None = None,
    adj_block: int | None = None,
    adj_dtype: str = "float32",
    device: str | torch.device = "cuda",
) -> GraphIndex:
    """The NSW graph of an already rotated corpus and its int8
    adjacency-flat layout on ``device``; :func:`build_graph` after the
    rotation.  The insertion loop runs in numpy on the host."""
    dev = resolve_device(device)
    rot = np.array(rot, np.float32)  # owned and writable: torch shares it on the CPU
    n, dim = rot.shape
    adj = np.full((n, 2 * m), -1, np.int64)  # over-provision, trim at the end
    deg = np.zeros(n, np.int64)
    for v in range(1, n):
        _insert_node_np(rot, adj, deg, v, m=m, ef_construction=ef_construction)
    # Trim to M (diversity-aware) and pick the medoid entry.
    final = np.full((n, m), -1, np.int64)
    for v in range(n):
        final[v] = _trim_row_np(rot, adj, deg, v, m)
    entry = _medoid_entry_np(rot)

    rot_t = torch.as_tensor(rot, device=dev)
    qc = quantize_corpus(rot_t)
    block_d = (int(estimator.table.dims[0]) if scan_block_d is None
               else int(scan_block_d))
    # Refuse an estimator the kernel cannot express here, by name.
    kernel_spec(estimator, dim, block_d)
    d_pad = (dim + block_d - 1) // block_d * block_d
    a_block = (max(m, 1) + 31) // 32 * 32 if adj_block is None else int(adj_block)
    if a_block < m:
        raise ValueError(f"adj_block {a_block} < graph degree m {m}")
    rot_pad = torch.zeros((n, d_pad), dtype=torch.float32, device=dev)
    rot_pad[:, :dim] = rot_t
    gscales = fit_block_scales(rot_pad, block_d)
    codes_blk = quantize_block(rot_pad, gscales, block_d)
    # A trimmed row holds its neighbours first and -1 after them, so slot j
    # of node v's block is neighbour j (or a pad row).
    nb = torch.as_tensor(final, device=dev)
    valid = (nb >= 0)[:, :, None]
    src = nb.clamp_min(0)
    adj_rot = torch.full((n, a_block, d_pad), SENTINEL, dtype=torch.float32, device=dev)
    adj_codes = torch.zeros((n, a_block, d_pad), dtype=torch.int8, device=dev)
    adj_ids = torch.full((n, a_block), -1, dtype=torch.int32, device=dev)
    adj_rot[:, :m] = torch.where(valid, rot_pad[src], adj_rot[:, :m])
    adj_codes[:, :m] = torch.where(valid, codes_blk[src], adj_codes[:, :m])
    adj_ids[:, :m] = nb.to(torch.int32)
    return GraphIndex(
        estimator=estimator, corpus_rot=rot_t,
        neighbors=nb.to(torch.int32), entry=entry,
        corpus_q=qc.codes, qscales=qc.scales,
        adj_rot=adj_rot.reshape(n * a_block, d_pad).to(_DTYPES[adj_dtype]),
        adj_codes=adj_codes.reshape(n * a_block, d_pad),
        adj_ids=adj_ids.reshape(n * a_block), gscales=gscales,
        adj_block=a_block, scan_block_d=block_d)


def build_graph(
    data,
    *,
    method: str = "dade",
    m: int = 16,
    ef_construction: int = 100,
    generator: torch.Generator | None = None,
    estimator: Estimator | None = None,
    quant: str | None = "int8",
    scan_block_d: int | None = None,
    adj_block: int | None = None,
    adj_dtype: str = "float32",
    device: str | torch.device = "cuda",
    **est_kwargs,
) -> GraphIndex:
    """Build the NSW graph over (N, D) data and its int8 adjacency-flat
    layout on ``device``.

    The estimator is fitted on ``device`` (unless given) and rotates the
    corpus there; the insertion loop runs in numpy on the host.
    ``adj_block`` defaults to ``m`` rounded up to 32, the kernel's
    neighbour-block height; ``scan_block_d`` to the estimator's first
    checkpoint; ``adj_dtype="bfloat16"`` stores the rows at 2 B/dim (stage
    2 upcasts per block).  Only the int8 layout the fused walk reads is
    built: ``quant`` must ask for it (or the estimator carry it).
    """
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    if estimator is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        estimator = build_estimator(method, x, generator, quant=quant,
                                    device=dev, **est_kwargs)
    if not wants_quant(quant, estimator.quant):
        raise ValueError("the port builds the int8 adjacency-flat layout only "
                         "(quant='int8'): the unquantized greedy search_graph "
                         "route is not ported")
    rot = estimator.rotate(x).cpu().numpy()
    return graph_from_rotated(
        rot, estimator, m=m, ef_construction=ef_construction,
        scan_block_d=scan_block_d, adj_block=adj_block, adj_dtype=adj_dtype,
        device=dev)


# ---------------------------------------------------------------------------
# The batched beam scan
# ---------------------------------------------------------------------------


class GraphScanStats(NamedTuple):
    """Per-batch accounting from the batched beam scan (host-side floats).

    Three byte ledgers of one trajectory: ``bytes_per_query`` counts the
    dims each screen consumed (1 B per int8 dim, the row dtype's bytes per
    fp dim); ``fetched_bytes_per_query`` what the demand-paged kernel moves
    (whole int8 tiles with their ids, fp slabs while stage 2 is active);
    ``gather_bytes_per_query`` what a row-gathering host engine would move
    (every screened row whole).
    """

    waves: float  # kernel launches (frontier waves) until convergence
    expansions_per_query: float  # candidate tiles streamed / query
    rows_per_query: float  # valid neighbour rows screened / query
    avg_int8_dims: float  # int8 dims consumed per screened row
    avg_fp_dims: float  # fp dims consumed per screened row
    passed_per_query: float  # rows surviving the full screen / query
    bytes_per_query: float  # semantic dims-consumed ledger
    fetched_bytes_per_query: float  # DMA-granular kernel ledger
    gather_bytes_per_query: float  # row-granular host-gather ledger
    s1_tiles_fetched: float = 0.0  # int8 adjacency tiles fetched
    s2_slabs_total: float = 0.0  # fp slabs a non-paged pipeline ships
    s2_slabs_fetched: float = 0.0  # fp slabs actually fetched on demand
    s2_skip_rate: float = 0.0  # 1 - fetched/total (fetch elision)


def _beam_seed_rsq(index: GraphIndex, q_rot: torch.Tensor, k: int) -> torch.Tensor:
    """Seed threshold from the entry point's int8-prescreened neighbourhood:
    verify the k apparent-nearest exactly and widen the k-th by the first
    checkpoint's overshoot band.  Sound floor — the k verified rows are real
    corpus rows, so the final k-th distance can only be smaller."""
    table = index.estimator.table
    m = index.degree
    nbrs0 = index.neighbors[index.entry].long()  # (M,)
    nvalid = nbrs0 >= 0
    codes0 = index.corpus_q[nbrs0.clamp_min(0)]
    deq0 = codes0.float() * index.qscales[None, :]
    approx = torch.sum((deq0[None, :, :] - q_rot[:, None, :]) ** 2, dim=-1)
    approx = torch.where(nvalid[None, :], approx,
                         torch.full_like(approx, float("inf")))  # (Q, M)
    kk = min(k, m)
    # A stable ascending sort keeps the lower index first among equal
    # estimates, the tie order of the reference's lax.top_k.
    sel = torch.argsort(approx, dim=1, stable=True)[:, :kk]
    rows0 = index.corpus_rot[nbrs0.clamp_min(0)][sel]  # (Q, kk, D)
    exact0 = torch.sum((rows0 - q_rot[:, None, :]) ** 2, dim=-1)
    t = 1.0 + table.eps[0]
    kth = torch.amax(exact0, dim=1) * (t * t) * (1.0 + SEED_SLACK)
    enough = bool(torch.sum(nvalid) >= k) and kk == k
    return kth if enough else torch.full_like(kth, float("inf"))


def walk_inputs(index: GraphIndex, queries, *, k: int, ef: int, expand: int,
                block_q: int, max_waves: int, seed_r: bool, decoupled: bool,
                route_mult: float):
    """The prologue of a search: ``(args, kwargs, inv)`` of the
    ``graph_walk_kernel_call`` (or ``ref.graph_walk_ref``) that walks these
    queries, rotated, sorted into tiles (``inv`` undoes the sort) and
    seeded with the entry point and, with ``seed_r``, the threshold floor
    (the padding gives pad rows an empty window and r² = 0)."""
    if not 1 <= k <= ef:
        raise ValueError(f"need 1 <= k <= ef, got k={k} ef={ef}")
    dev = index.device
    q_rot = index.estimator.rotate(as_tensor(queries, dev))
    qn = q_rot.shape[0]
    # Tile coherence: sort queries along the leading (max-variance) PCA
    # coordinate so a tile's walks traverse overlapping graph regions and
    # the per-tile frontier union stays small.  Stable, as jnp.argsort.
    order = torch.argsort(q_rot[:, 0], stable=True)
    inv = torch.argsort(order, stable=True).cpu().numpy()
    q_sorted = q_rot[order]
    entry = index.entry
    top_sq = torch.full((qn, ef), float("inf"), device=dev)
    top_ids = torch.full((qn, ef), -1, dtype=torch.int32, device=dev)
    top_sq[:, 0] = torch.sum((index.corpus_rot[entry][None, :] - q_sorted) ** 2, dim=1)
    top_ids[:, 0] = entry
    seed = (_beam_seed_rsq(index, q_sorted, k) if seed_r
            else torch.full((qn,), float("inf"), device=dev))
    args, kw = graph_walk_inputs(
        index.estimator, q_sorted, top_sq, top_ids, seed, index.adj_rot,
        index.adj_codes, index.adj_ids, index.gscales, entry=entry, ef=ef,
        thresh_col=(k - 1) if decoupled else (ef - 1), expand=expand,
        max_waves=max_waves, route_mult=route_mult, block_q=block_q,
        block_c=index.adj_block, block_d=index.scan_block_d)
    return args, kw, inv


def _run_wave_loop(index: GraphIndex, queries, *, k: int, ef: int, expand: int,
                   block_q: int, max_waves: int, seed_r: bool, decoupled: bool,
                   route_mult: float, use_ref: bool):
    """The single-shard wave loop of the reference, run as one walk: up to
    ``max_waves`` waves, each from r² = min(seed, window[thresh_col]), the
    first expanding the entry point, every later one the frontier the
    reference's ``_select_wave`` picks (``ref.select_wave_ref``), until no
    tile has a frontier left.  On CUDA tensors one ``graph_walk_kernel_call``
    runs the whole walk, each tile picking its own frontiers on the card;
    on CPU tensors (or with ``use_ref``) the plain ``ref.graph_walk_ref``
    runs it.  The host does the prologue and reads the results back once.
    Returns ``(dists, ids, acc)`` with ``acc`` the raw accounting
    ``_graph_stats`` turns into ``GraphScanStats``."""
    args, kw, inv = walk_inputs(
        index, queries, k=k, ef=ef, expand=expand, block_q=block_q,
        max_waves=max_waves, seed_r=seed_r, decoupled=decoupled,
        route_mult=route_mult)
    qn = kw["qn"]
    walk = graph_walk_ref if use_ref else graph_walk_kernel_call
    t_sq, t_ids, st, _, tile_waves = walk(*args, **kw)
    waves = int(tile_waves.max()) if tile_waves.numel() else 0
    top_sq, top_ids = t_sq[:qn].cpu().numpy(), t_ids[:qn].cpu().numpy()
    st = st[:waves].cpu().numpy()
    # The ledger of a launch per wave: each wave's fp32 column sums, added
    # into float64 wave by wave.
    sem = np.zeros((4,), np.float64)  # stats cols 0-3 summed over waves
    s1_tiles = s2_slabs = 0.0
    for w in range(waves):
        sem += st[w, :qn, :4].sum(axis=0)
        w1, w2 = fused_fetch_totals(st[w], block_q)
        s1_tiles += w1
        s2_slabs += w2
    dists = np.sqrt(np.maximum(top_sq, 0.0))[inv][:, :k]
    ids = top_ids[inv][:, :k]
    acc = dict(waves=waves, sem=sem, s1_tiles=s1_tiles, s2_slabs=s2_slabs, qn=qn)
    return dists, ids, acc


def _graph_stats(index: GraphIndex, *, dim: int, k: int, seed_r: bool,
                 qn: int, waves: float, sem, s1_tiles: float,
                 s2_slabs: float) -> GraphScanStats:
    """The ``GraphScanStats`` ledger arithmetic of one batch."""
    rows = max(float(sem[2]), 1.0)
    d_pad = index.adj_rot.shape[1]
    fp_bytes = index.adj_rot.element_size()  # f32 or bf16 rows
    # Seeding streams the entry's int8 neighbour block + k exact rows per
    # query before wave 0 — count those corpus bytes in every ledger.
    seed_bytes = (index.degree * dim + 4 * k * dim) if seed_r else 0
    s2_fetched_b, _, s2_skip, s2_total = stage2_fetch_report(
        s1_tiles, s2_slabs, block_c=index.adj_block, d_pad=d_pad,
        block_d=index.scan_block_d, fp_bytes=fp_bytes)
    fetched = fetched_tile_bytes(
        s1_tiles, block_c=index.adj_block, dims=d_pad, bytes_per_dim=1,
        id_bytes=ID_BYTES) + s2_fetched_b
    return GraphScanStats(
        waves=float(waves),
        expansions_per_query=s1_tiles / qn,
        rows_per_query=rows / qn,
        avg_int8_dims=float(sem[0]) / rows,
        avg_fp_dims=float(sem[1]) / rows,
        passed_per_query=float(sem[3]) / qn,
        bytes_per_query=float(two_stage_bytes(
            sem[0], sem[1], fp_bytes=fp_bytes)) / qn + seed_bytes,
        fetched_bytes_per_query=fetched / qn + seed_bytes,
        gather_bytes_per_query=row_gather_bytes(
            rows, dims=dim, fp_bytes=fp_bytes) / qn + seed_bytes,
        s1_tiles_fetched=s1_tiles,
        s2_slabs_total=s2_total,
        s2_slabs_fetched=s2_slabs,
        s2_skip_rate=s2_skip,
    )


def _beam_scan(index: GraphIndex, queries, *, k, ef, expand, block_q,
               max_waves, seed_r, decoupled, route_mult, use_ref, device):
    """The shared wave loop plus the ``GraphScanStats`` epilogue; runs on
    ``device``, where the index must live, and returns its results there."""
    dev = resolve_device(device)
    if dev.type != index.device.type or dev.index not in (None, index.device.index):
        raise ValueError(f"the index lives on {index.device}, the search was "
                         f"asked to run on {dev}")
    dists, ids, acc = _run_wave_loop(
        index, queries, k=k, ef=ef, expand=expand, block_q=block_q,
        max_waves=max_waves, seed_r=seed_r, decoupled=decoupled,
        route_mult=route_mult, use_ref=use_ref)
    stats = _graph_stats(
        index, dim=index.corpus_rot.shape[1], k=k, seed_r=seed_r,
        qn=acc["qn"], waves=acc["waves"], sem=acc["sem"],
        s1_tiles=acc["s1_tiles"], s2_slabs=acc["s2_slabs"])
    return (torch.as_tensor(dists, device=index.device),
            torch.as_tensor(ids, device=index.device), stats)


def search_graph_fused(index: GraphIndex, queries, *, k: int = 10, ef: int = 48,
                       expand: int = 2, block_q: int = KERNEL_TILE[0],
                       max_waves: int = 64, seed_r: bool = False,
                       decoupled: bool = True, route_mult: float = 1.0,
                       device: str | torch.device = "cuda"):
    """Batched graph search through the fused beam-scan walk on ``device``
    (the index's): each wave, every query tile's ``expand`` best unexpanded
    beam entries per query are screened for the whole tile, the waves of a
    search in one kernel launch.  Returns (dists (Q, k), ids (Q, k),
    GraphScanStats).

    Expansion is per *tile*: a node any of the tile's queries proposes is
    screened (and marked expanded) for all of them.  ``decoupled=True``
    takes the DCO threshold from the k-th best of the window (the paper's
    HNSW++-style decoupling), ``decoupled=False`` from the ef-th.
    ``route_mult`` widens the frontier proposal gate to ``route_mult · r²``
    without touching the screen threshold.
    """
    return _beam_scan(index, queries, k=k, ef=ef, expand=expand,
                      block_q=block_q, max_waves=max_waves, seed_r=seed_r,
                      decoupled=decoupled, route_mult=route_mult,
                      use_ref=False, device=device)


def search_graph_beam_host(index: GraphIndex, queries, *, k: int = 10,
                           ef: int = 48, expand: int = 2,
                           block_q: int = KERNEL_TILE[0], max_waves: int = 64,
                           seed_r: bool = False, decoupled: bool = True,
                           route_mult: float = 1.0,
                           device: str | torch.device = "cuda"):
    """The identical wave schedule run through the plain version
    ``ref.graph_walk_ref``: the same results and ledgers as
    :func:`search_graph_fused`."""
    return _beam_scan(index, queries, k=k, ef=ef, expand=expand,
                      block_q=block_q, max_waves=max_waves, seed_r=seed_r,
                      decoupled=decoupled, route_mult=route_mult,
                      use_ref=True, device=device)
