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
results.  The continuous engine (``launch.annservice.
ContinuousGraphEngine``) walks each query in a tile of its own, seeded by
the same prologue (``_prep_wave_state``), one wave per launch, with the
frontier picked between waves by ``_select_wave``.

``search_graph`` is the reference's greedy per-query walk (plain PyTorch,
the only search of an unquantized build).  Tombstones (pre-visited nodes)
and the delete filter (``exclude``) serve the mutable index
(``index.mutable``) and shard failover.

Sharded walks (``search_graph_sharded``): the corpus split into
``num_shards`` contiguous node ranges (``shard_graph_nodes``), each wave
screened by one one-wave launch per shard over the shard's slab rows with
the wave-start threshold frozen, the shards' windows merged
(``merge_shard_windows``) and their bitmaps OR-ed between waves, the host
picking each wave's frontier.  A frozen wave commutes across shards, so
every shard count returns the ``num_shards=1`` walk's results bit for bit.
``wave_step`` swaps the host-simulated launches for a process group's
(``launch.annservice.build_sharded_graph_engine``).
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
from repro_torch.core.dco import dco_screen
from repro_torch.core.topk import _smallest
from repro_torch.core.transforms import as_tensor
from repro_torch.kernels import ref
from repro_torch.kernels.graph_scan import (
    KERNEL_TILE, graph_scan_kernel_call, graph_walk_kernel_call,
)
from repro_torch.kernels.ops import (
    fused_fetch_totals, graph_scan_inputs, graph_vis_words, graph_walk_inputs,
    pack_vis_ranges, pow2_bucket,
)
from repro_torch.kernels.ref import graph_walk_ref, select_wave_ref
from repro_torch.obs.trace import current_tracer
from repro_torch.quant.accounting import (
    ID_BYTES, fetched_tile_bytes, frontier_exchange_bytes, row_gather_bytes,
    stage2_fetch_report, two_stage_bytes,
)
from repro_torch.quant.scalar import (
    QuantizedCorpus, fit_block_scales, quantize_block, quantize_corpus, wants_quant,
)
from repro_torch.quant.screen import two_stage_screen
from repro_torch.runtime.chaos import current_chaos

__all__ = ["GraphIndex", "build_graph", "graph_from_rotated", "search_graph",
           "adjacency_rows", "search_graph_fused", "search_graph_beam_host", "GraphScanStats",
           "walk_inputs", "SENTINEL", "shard_graph_nodes", "dead_shard_tombstones",
           "merge_shard_windows", "GraphShardedStats", "search_graph_sharded", "slab_rows",
           "GraphSlab", "graph_slab", "localize_frontier", "merge_shard_state",
           "frozen_wave_inputs", "shard_launches"]

SENTINEL = 1e18  # pad rows of a neighbour block: masked by id, never read as data
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    estimator: Estimator
    corpus_rot: torch.Tensor  # (N, D) rotated corpus
    neighbors: torch.Tensor  # (N, M) int32, -1 padded
    entry: int  # medoid entry point
    # The int8 build's arrays (None in an unquantized build, which only the
    # greedy ``search_graph`` walks).
    corpus_q: torch.Tensor | None = None  # (N, D) int8 per-dimension codes
    qscales: torch.Tensor | None = None  # (D,) per-dimension scales
    # Adjacency-flat layout: node v's neighbour rows at [v*A, (v+1)*A).
    adj_rot: torch.Tensor | None = None  # (N*A, D_pad) f32 or bf16, SENTINEL pads
    adj_codes: torch.Tensor | None = None  # (N*A, D_pad) int8 block codes, 0 pads
    adj_ids: torch.Tensor | None = None  # (N*A,) int32, -1 pad rows
    gscales: torch.Tensor | None = None  # (D_pad // scan_block_d,) f32 block scales
    adj_block: int = 0
    scan_block_d: int = 0

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def has_quant(self) -> bool:
        return self.corpus_q is not None

    @property
    def has_fused(self) -> bool:
        return self.adj_codes is not None

    @property
    def device(self) -> torch.device:
        return self.corpus_rot.device


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
    quant: str | None = "int8",
    scan_block_d: int | None = None,
    adj_block: int | None = None,
    adj_dtype: str = "float32",
    device: str | torch.device = "cuda",
) -> GraphIndex:
    """The NSW graph of an already rotated corpus on ``device``, with the
    int8 adjacency-flat layout when ``quant`` asks for it (or the estimator
    carries it); :func:`build_graph` after the rotation.  The insertion
    loop runs in numpy on the host."""
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
    nb = torch.as_tensor(final, device=dev).to(torch.int32)
    if not wants_quant(quant, estimator.quant):
        return GraphIndex(estimator=estimator, corpus_rot=rot_t, neighbors=nb,
                          entry=entry)
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
    adj_rot, adj_codes, adj_ids = adjacency_rows(nb, rot_pad, codes_blk, a_block)
    return GraphIndex(
        estimator=estimator, corpus_rot=rot_t, neighbors=nb, entry=entry,
        corpus_q=qc.codes, qscales=qc.scales, adj_rot=adj_rot.to(_DTYPES[adj_dtype]),
        adj_codes=adj_codes, adj_ids=adj_ids, gscales=gscales, adj_block=a_block,
        scan_block_d=block_d)


def adjacency_rows(neighbors: torch.Tensor, rot_pad: torch.Tensor,
                   codes_blk: torch.Tensor, a_block: int):
    """The adjacency-flat blocks of the nodes whose trimmed rows are
    ``neighbors`` (V, M): (V*A, D_pad) f32 rows, (V*A, D_pad) int8 codes and
    (V*A,) int32 ids, gathered from ``rot_pad`` / ``codes_blk`` on their
    device, SENTINEL / 0 / -1 in the pad slots."""
    v, m = neighbors.shape
    d_pad = rot_pad.shape[1]
    dev = rot_pad.device
    # A trimmed row holds its neighbours first and -1 after them, so slot j
    # of node v's block is neighbour j (or a pad row).
    nb = neighbors.to(dev).long()
    valid = (nb >= 0)[:, :, None]
    src = nb.clamp_min(0)
    adj_rot = torch.full((v, a_block, d_pad), SENTINEL, dtype=torch.float32, device=dev)
    adj_codes = torch.zeros((v, a_block, d_pad), dtype=torch.int8, device=dev)
    adj_ids = torch.full((v, a_block), -1, dtype=torch.int32, device=dev)
    adj_rot[:, :m] = torch.where(valid, rot_pad[src], adj_rot[:, :m])
    adj_codes[:, :m] = torch.where(valid, codes_blk[src], adj_codes[:, :m])
    adj_ids[:, :m] = nb.to(torch.int32)
    return (adj_rot.reshape(v * a_block, d_pad), adj_codes.reshape(v * a_block, d_pad),
            adj_ids.reshape(v * a_block))


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
    """Build the NSW graph over (N, D) data on ``device``.

    The estimator is fitted on ``device`` (unless given) and rotates the
    corpus there (``apply_rows``: each row's result independent of the
    batch, so an upsert's row equals the same row rotated with the corpus);
    the insertion loop runs in numpy on the host.  With ``quant="int8"``
    (the default, or an estimator carrying it) the int8 arrays and the
    adjacency-flat layout of the fused walk are built too: ``adj_block``
    defaults to ``m`` rounded up to 32, the kernel's neighbour-block
    height; ``scan_block_d`` to the estimator's first checkpoint;
    ``adj_dtype="bfloat16"`` stores the rows at 2 B/dim.  ``quant=None``
    builds only what the greedy :func:`search_graph` walks.
    """
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    if estimator is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        estimator = build_estimator(method, x, generator, quant=quant,
                                    device=dev, **est_kwargs)
    rot = estimator.transform.apply_rows(x).cpu().numpy()
    return graph_from_rotated(
        rot, estimator, m=m, ef_construction=ef_construction, quant=quant,
        scan_block_d=scan_block_d, adj_block=adj_block, adj_dtype=adj_dtype,
        device=dev)


# ---------------------------------------------------------------------------
# The greedy per-query walk
# ---------------------------------------------------------------------------


def _smallest_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of 1-D ``x``, ties to the lower index."""
    return _smallest(x[None], k)[0]


def search_graph(index: GraphIndex, queries, *, k: int = 10, ef: int = 64,
                 max_steps: int = 512, decoupled: bool = True,
                 use_quant: bool = False, seed_r: bool = False,
                 with_stats: bool = False):
    """The reference's greedy DCO beam search (paper §3.4), one query at a
    time on the index's device, plain PyTorch.

    Per query: W, an ef-sized window of estimated distances; C, a frontier
    of 2·ef unexpanded nodes ordered by estimate; R, the k exact results
    gated by the DCO.  Each step pops C's nearest node and screens its
    neighbours (``core.dco.dco_screen``, or the two-stage int8 screen with
    ``use_quant``) against r = R's k-th (``decoupled``) or W's ef-th
    distance, floored by the ``seed_r`` threshold seed; it stops when C's
    nearest cannot improve W or after ``max_steps``.  Returns (dists (Q,
    k), ids (Q, k), avg_dims (Q,)); ``with_stats`` widens the third output
    to (Q, 3) [avg_dims, rows screened, steps]."""
    if use_quant and not index.has_quant:
        raise ValueError("search_graph(use_quant=True) needs build_graph(quant='int8')")
    if seed_r and not index.has_quant:
        raise ValueError("search_graph(seed_r=True) needs build_graph(quant='int8')")
    dev = index.device
    q_rot = index.estimator.rotate(as_tensor(queries, dev))
    table = index.estimator.table
    n = index.corpus_rot.shape[0]
    c_max = 2 * ef  # frontier capacity
    inf = torch.tensor(float("inf"), device=dev)
    r_seed = (_beam_seed_rsq(index, q_rot, k) if seed_r
              else torch.full((q_rot.shape[0],), float("inf"), device=dev))
    e = index.entry
    outs = []
    for qv, r_seed_q in zip(q_rot, r_seed):
        w_sq = torch.full((ef,), float("inf"), device=dev)
        c_sq = torch.full((c_max,), float("inf"), device=dev)
        c_ids = torch.full((c_max,), -1, dtype=torch.int32, device=dev)
        top_sq = torch.full((k,), float("inf"), device=dev)
        top_ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
        visited = torch.zeros((n,), dtype=torch.bool, device=dev)
        d_entry = torch.sum((index.corpus_rot[e] - qv) ** 2)
        w_sq[0] = c_sq[0] = top_sq[0] = d_entry
        c_ids[0] = top_ids[0] = e
        visited[e] = True
        steps = dims_acc = rows_acc = 0
        while steps < max_steps:
            nearest = torch.min(c_sq)
            if not (bool(torch.isfinite(nearest)) and bool(nearest <= w_sq[-1])):
                break
            slot = int(torch.argmin(c_sq))
            node = int(c_ids[slot])
            c_sq[slot] = inf  # pop
            nbrs = index.neighbors[node]  # (M,)
            nb = nbrs.long().clamp_min(0)
            fresh = (nbrs >= 0) & ~visited[nb]
            visited[nb[nbrs >= 0]] = True
            cands = index.corpus_rot[nb]  # (M, D)
            r_sq = top_sq[-1] if decoupled else w_sq[-1]
            r_sq = torch.minimum(r_sq, r_seed_q)
            r_sq = torch.where(torch.isfinite(r_sq), r_sq, torch.tensor(1e18, device=dev))
            if use_quant:
                res = two_stage_screen(
                    qv[None], cands, QuantizedCorpus(index.corpus_q[nb], index.qscales),
                    table, r_sq[None])
                est_all, passed_all, dims_all = res.est_sq[0], res.passed[0], res.dims_used[0]
            else:
                res = dco_screen(qv, cands, table, r_sq)
                est_all, passed_all, dims_all = res.est_sq, res.passed, res.dims_used
            est_sq = torch.where(fresh, est_all, inf)
            passed = passed_all & fresh
            dims_acc += int(torch.sum(torch.where(fresh, dims_all, 0)))
            rows_acc += int(torch.sum(fresh))
            # R: survivors carry exact distances (they reached d = D).
            all_sq = torch.cat([top_sq, torch.where(passed, est_sq, inf)])
            all_ids = torch.cat([top_ids, nbrs.to(torch.int32)])
            sel = _smallest_k(all_sq, k)
            top_sq, top_ids = all_sq[sel], all_ids[sel]
            # W: estimates advance the window whatever the DCO decided.
            w_sq = torch.cat([w_sq, est_sq])[_smallest_k(torch.cat([w_sq, est_sq]), ef)]
            # C: only neighbours that could still improve the window enter.
            cand_sq = torch.where(est_sq <= w_sq[-1], est_sq, inf)
            all_c = torch.cat([c_sq, cand_sq])
            sel_c = _smallest_k(all_c, c_max)
            c_sq = all_c[sel_c]
            c_ids = torch.cat([c_ids, nbrs.to(torch.int32)])[sel_c]
            steps += 1
        avg = torch.tensor(float(dims_acc), dtype=torch.float32) / max(float(rows_acc), 1.0)
        extra = torch.stack([avg, torch.tensor(float(rows_acc)), torch.tensor(float(steps))])
        outs.append((torch.sqrt(torch.clamp_min(top_sq, 0.0)), top_ids, avg, extra))
    dists = torch.stack([o[0] for o in outs])
    ids = torch.stack([o[1] for o in outs])
    third = torch.stack([o[3] if with_stats else o[2] for o in outs]).to(dev)
    return dists, ids, third


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


def _beam_seed_rsq(index: GraphIndex, q_rot: torch.Tensor, k: int, *,
                   entry: int | None = None,
                   alive: torch.Tensor | None = None) -> torch.Tensor:
    """Seed threshold from the entry point's int8-prescreened neighbourhood:
    verify the k apparent-nearest exactly and widen the k-th by the first
    checkpoint's overshoot band.  Sound floor — the k verified rows are real
    corpus rows, so the final k-th distance can only be smaller.

    ``entry`` overrides the build's medoid (the surviving-corpus fallback
    when the medoid is tombstoned); ``alive`` — an (N,) bool mask, False on
    tombstoned nodes — drops dead neighbours from the sample as -1 padding
    is dropped, so the seed rests on k verified surviving rows."""
    table = index.estimator.table
    m = index.degree
    e = index.entry if entry is None else int(entry)
    nbrs0 = index.neighbors[e].long()  # (M,)
    nvalid = nbrs0 >= 0
    if alive is not None:
        nvalid = nvalid & alive[nbrs0.clamp_min(0)]
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


def _alive_mask(n: int, ranges) -> np.ndarray:
    """(n,) bool, False on every node of the (base, count) ``ranges``."""
    alive = np.ones((n,), bool)
    for b, c in ranges:
        alive[int(b): int(b) + int(c)] = False
    return alive


def _surviving_entry(index: GraphIndex, tombstones) -> int:
    """The entry point when the build's medoid is tombstoned: the node
    nearest the mean of the surviving corpus, the build's medoid rule
    restated over the nodes that can still be expanded (numpy, as the
    reference computes it)."""
    rot = index.corpus_rot.cpu().numpy()
    alive = _alive_mask(rot.shape[0], tombstones)
    if not alive.any():
        raise ValueError("every node is tombstoned — nothing left to serve from")
    centre = rot[alive].mean(axis=0)
    d = np.sum((rot - centre[None, :]) ** 2, axis=1)
    d[~alive] = np.inf
    return int(np.argmin(d))


# The reference's host frontier selection (``repro.index.graph._select_wave``)
# in tensor form: one body with the walk kernel's plain twin, per-tile
# ``expand`` budgets allowed (the continuous engine's slots carry their own).
_select_wave = select_wave_ref


def _prep_wave_state(index: GraphIndex, queries, *, k: int, ef: int,
                     block_q: int, seed_r: bool, tombstones=()):
    """The prologue of a walk, shared by the batch search and the
    continuous engine's admission: rotate and tile-sort the queries, pad
    them to whole ``block_q`` tiles, seed each real row's window with the
    entry point (or, when ``tombstones`` cover the build's medoid, the
    surviving-corpus fallback) and (with ``seed_r``) its threshold floor,
    sampled from the entry's alive neighbours only.  Pad rows carry an
    empty window (inf/-1), r² floor 0 and a zero query.  Returns ``(inv,
    q_sorted (q_pad, D), q_tiles, q_pad, qn, entry, top_sq (q_pad, ef),
    top_ids, seed (q_pad,))`` on the index's device, ``inv`` (a tensor)
    undoing the sort."""
    if not 1 <= k <= ef:
        raise ValueError(f"need 1 <= k <= ef, got k={k} ef={ef}")
    dev = index.device
    q_rot = index.estimator.rotate(as_tensor(queries, dev))
    qn = q_rot.shape[0]
    # Tile coherence: sort queries along the leading (max-variance) PCA
    # coordinate so a tile's walks traverse overlapping graph regions and
    # the per-tile frontier union stays small.  Stable, as jnp.argsort.
    order = torch.argsort(q_rot[:, 0], stable=True)
    inv = torch.argsort(order, stable=True)
    q_sorted = q_rot[order]
    q_tiles = -(-qn // block_q)
    q_pad = q_tiles * block_q
    entry = index.entry
    if tombstones and any(b <= entry < b + c for b, c in tombstones):
        entry = _surviving_entry(index, tombstones)
    top_sq = torch.full((q_pad, ef), float("inf"), device=dev)
    top_ids = torch.full((q_pad, ef), -1, dtype=torch.int32, device=dev)
    top_sq[:qn, 0] = torch.sum((index.corpus_rot[entry][None, :] - q_sorted) ** 2, dim=1)
    top_ids[:qn, 0] = entry
    seed = torch.zeros((q_pad,), device=dev)
    if seed_r:
        alive = (torch.as_tensor(_alive_mask(index.corpus_rot.shape[0], tombstones),
                                 device=dev) if tombstones else None)
        seed[:qn] = _beam_seed_rsq(index, q_sorted, k, entry=entry, alive=alive)
    else:
        seed[:qn] = float("inf")
    q_sorted = torch.nn.functional.pad(q_sorted, (0, 0, 0, q_pad - qn))
    return inv, q_sorted, q_tiles, q_pad, qn, entry, top_sq, top_ids, seed


def walk_inputs(index: GraphIndex, queries, *, k: int, ef: int, expand: int,
                block_q: int, max_waves: int, seed_r: bool, decoupled: bool,
                route_mult: float, tombstones=()):
    """The prologue of a search: ``(args, kwargs, inv)`` of the
    ``graph_walk_kernel_call`` (or ``ref.graph_walk_ref``) that walks these
    queries, from :func:`_prep_wave_state` (``inv``, a numpy permutation,
    undoes the tile sort).  ``tombstones`` ((base, count) node ranges) are
    pre-set in every tile's starting bitmap, so the walk never expands
    them."""
    inv, q_sorted, q_tiles, _, qn, entry, top_sq, top_ids, seed = _prep_wave_state(
        index, queries, k=k, ef=ef, block_q=block_q, seed_r=seed_r,
        tombstones=tombstones)
    vis0 = None
    if tombstones:
        row = torch.as_tensor(pack_vis_ranges(index.corpus_rot.shape[0], tombstones),
                              device=index.device)
        vis0 = row[None, :].expand(q_tiles, -1).contiguous()
    args, kw = graph_walk_inputs(
        index.estimator, q_sorted[:qn], top_sq[:qn], top_ids[:qn], seed[:qn],
        index.adj_rot, index.adj_codes, index.adj_ids, index.gscales,
        entry=entry, ef=ef, thresh_col=(k - 1) if decoupled else (ef - 1),
        expand=expand, max_waves=max_waves, route_mult=route_mult,
        block_q=block_q, block_c=index.adj_block, block_d=index.scan_block_d,
        vis0=vis0)
    return args, kw, inv.cpu().numpy()


def _exclude_ids(top_sq: np.ndarray, top_ids: np.ndarray, n: int, exclude):
    """The delete filter: drop the ids of the (base, count) ``exclude``
    ranges from the full ef windows, then re-sort (stable, so ties keep
    their window order) so the best surviving entries come first."""
    dead = ~_alive_mask(n, exclude)
    drop = (top_ids >= 0) & dead[np.maximum(top_ids, 0)]
    top_sq = np.where(drop, np.inf, top_sq)
    top_ids = np.where(drop, -1, top_ids).astype(np.int32)
    order = np.argsort(top_sq, axis=1, kind="stable")
    return (np.take_along_axis(top_sq, order, axis=1),
            np.take_along_axis(top_ids, order, axis=1))


def _run_wave_loop(index: GraphIndex, queries, *, k: int, ef: int, expand: int,
                   block_q: int, max_waves: int, seed_r: bool, decoupled: bool,
                   route_mult: float, use_ref: bool, tombstones=(), exclude=()):
    """The single-shard wave loop of the reference, run as one walk: up to
    ``max_waves`` waves, each from r² = min(seed, window[thresh_col]), the
    first expanding the entry point, every later one the frontier the
    reference's ``_select_wave`` picks (``ref.select_wave_ref``), until no
    tile has a frontier left.  On CUDA tensors one ``graph_walk_kernel_call``
    runs the whole walk, each tile picking its own frontiers on the card;
    on CPU tensors (or with ``use_ref``) the plain ``ref.graph_walk_ref``
    runs it.  The host does the prologue and reads the results back once.

    The reference's per-wave spans become three here — ``graph.prologue``,
    ``graph.launch`` (annotated with the walk's ``waves``) and
    ``graph.readback`` — since the waves run inside one launch.  For the
    same reason the chaos harness's per-wave hook fires after the launch,
    as often as the reference's loop calls it: once per wave the walk ran,
    plus once for the wave that found no frontier (unless the walk hit
    ``max_waves``), so an armed ``shard_stall`` injects the reference's
    total stall.

    ``tombstones`` ((base, count) node ranges) are pre-set in the starting
    bitmap: never expanded, never seeding the threshold.  ``exclude`` (a
    subset of them: the deleted rows) is also dropped from the ef windows
    before the top k are taken (:func:`_exclude_ids`), since a tombstoned
    row can still enter a window as some expanded node's neighbour.

    Returns ``(dists, ids, acc)`` with ``acc`` the raw accounting
    ``_graph_stats`` turns into ``GraphScanStats``."""
    tr = current_tracer()
    with tr.span("graph.prologue", queries=len(queries)):
        args, kw, inv = walk_inputs(
            index, queries, k=k, ef=ef, expand=expand, block_q=block_q,
            max_waves=max_waves, seed_r=seed_r, decoupled=decoupled,
            route_mult=route_mult, tombstones=tombstones)
        tr.fence(args)
    qn = kw["qn"]
    walk = graph_walk_ref if use_ref else graph_walk_kernel_call
    with tr.span("graph.launch") as sp:
        t_sq, t_ids, st, _, tile_waves = tr.fence(walk(*args, **kw))
        waves = int(tile_waves.max()) if tile_waves.numel() else 0
        sp.annotate(waves=waves)
    with tr.span("graph.readback"):
        top_sq, top_ids = t_sq[:qn].cpu().numpy(), t_ids[:qn].cpu().numpy()
        st = st[:waves].cpu().numpy()
    chaos = current_chaos()  # NULL_CHAOS: a no-op
    for w in range(waves + (waves < max_waves)):
        chaos.on_wave(w)
    # The ledger of a launch per wave: each wave's fp32 column sums, added
    # into float64 wave by wave.
    sem = np.zeros((4,), np.float64)  # stats cols 0-3 summed over waves
    s1_tiles = s2_slabs = 0.0
    for w in range(waves):
        sem += st[w, :qn, :4].sum(axis=0)
        w1, w2 = fused_fetch_totals(st[w], block_q)
        s1_tiles += w1
        s2_slabs += w2
    if exclude:
        top_sq, top_ids = _exclude_ids(top_sq, top_ids, index.corpus_rot.shape[0],
                                       exclude)
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
               max_waves, seed_r, decoupled, route_mult, use_ref, device,
               tombstones=(), exclude=()):
    """The shared wave loop plus the ``GraphScanStats`` epilogue; runs on
    ``device``, where the index must live, and returns its results there."""
    dev = resolve_device(device)
    if not index.has_fused:
        raise ValueError("the batched beam scan needs build_graph(..., quant='int8')")
    if dev.type != index.device.type or dev.index not in (None, index.device.index):
        raise ValueError(f"the index lives on {index.device}, the search was "
                         f"asked to run on {dev}")
    dists, ids, acc = _run_wave_loop(
        index, queries, k=k, ef=ef, expand=expand, block_q=block_q,
        max_waves=max_waves, seed_r=seed_r, decoupled=decoupled,
        route_mult=route_mult, use_ref=use_ref,
        tombstones=tuple((int(b), int(c)) for b, c in tombstones),
        exclude=tuple((int(b), int(c)) for b, c in exclude))
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
                       device: str | torch.device = "cuda", tombstones=(),
                       exclude=()):
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

    ``tombstones``/``exclude`` are the mutable index's hooks ((base, count)
    node ranges; a single row is ``(id, 1)``): tombstoned nodes are
    pre-visited in the walk's bitmap (never expanded), excluded ids are
    also dropped from the result windows.
    """
    return _beam_scan(index, queries, k=k, ef=ef, expand=expand,
                      block_q=block_q, max_waves=max_waves, seed_r=seed_r,
                      decoupled=decoupled, route_mult=route_mult,
                      use_ref=False, device=device, tombstones=tombstones,
                      exclude=exclude)


def search_graph_beam_host(index: GraphIndex, queries, *, k: int = 10,
                           ef: int = 48, expand: int = 2,
                           block_q: int = KERNEL_TILE[0], max_waves: int = 64,
                           seed_r: bool = False, decoupled: bool = True,
                           route_mult: float = 1.0,
                           device: str | torch.device = "cuda", tombstones=(),
                           exclude=()):
    """The identical wave schedule run through the plain version
    ``ref.graph_walk_ref``: the same results and ledgers as
    :func:`search_graph_fused`."""
    return _beam_scan(index, queries, k=k, ef=ef, expand=expand,
                      block_q=block_q, max_waves=max_waves, seed_r=seed_r,
                      decoupled=decoupled, route_mult=route_mult,
                      use_ref=True, device=device, tombstones=tombstones,
                      exclude=exclude)


# ---------------------------------------------------------------------------
# The corpus-sharded walk: cross-shard frontier exchange
# ---------------------------------------------------------------------------


def shard_graph_nodes(n: int, num_shards: int):
    """Contiguous node ranges of the corpus-sharded walk: shard s owns nodes
    ``[s·(n/S), (s+1)·(n/S))`` and so rows ``[base·adj_block,
    (base+count)·adj_block)`` of the adjacency-flat slab.  Fails fast,
    naming the values, when the split is uneven."""
    if num_shards < 1:
        raise ValueError(
            f"sharded graph serving needs num_shards >= 1, got "
            f"num_shards={num_shards}")
    if n % num_shards:
        raise ValueError(
            f"sharded graph serving needs the node count to split evenly "
            f"across shards: corpus nodes n={n} % num_shards={num_shards} "
            f"!= 0 (pad the corpus or pick a shard count that divides it)")
    per = n // num_shards
    return [(s * per, per) for s in range(num_shards)]


def dead_shard_tombstones(n: int, num_shards: int, dead) -> tuple:
    """(base, count) node ranges of the ``dead`` shards (indices under the
    ``shard_graph_nodes(n, num_shards)`` split): what a failover run passes
    as ``tombstones``.  The ranges are node spans, so the same tombstones
    drive the degraded S-shard walk and its ``num_shards=1`` oracle."""
    ranges = shard_graph_nodes(n, num_shards)
    out = []
    for s in sorted({int(d) for d in dead}):
        if not 0 <= s < num_shards:
            raise ValueError(
                f"dead shard {s} out of range for num_shards={num_shards}")
        out.append(ranges[s])
    return tuple(out)


def merge_shard_windows(g_sq: torch.Tensor, g_ids: torch.Tensor, *, ef: int):
    """Cross-shard beam-window merge: (S, Q, EF) per-shard windows -> (Q, EF),
    the EF best distinct ids by distance, in the reference's order.

      * a stable sort on distance over the shards' windows concatenated in
        shard order, so ties go to the lower shard, then the lower column;
      * of equal real ids the first in that order is kept (an id admitted
        by two shards carries the same distance from both: its adjacency
        rows are byte-equal copies), found with one stable sort by id,
        which makes equal ids adjacent in distance order;
      * dropped entries become inf / -1 and sort last.

    ``torch.topk`` would not do: its order among equal values is not
    defined.  For S = 1 the merge is the identity."""
    s, qn, ef2 = g_sq.shape
    if ef2 != ef:
        raise ValueError(
            f"shard windows carry ef={ef2} columns, merge asked for ef={ef}")
    sq = g_sq.transpose(0, 1).reshape(qn, s * ef)
    ids = g_ids.transpose(0, 1).reshape(qn, s * ef)
    sq_s, order = torch.sort(sq, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    order_id = torch.argsort(ids_s, dim=1, stable=True)
    by_id = torch.gather(ids_s, 1, order_id)
    adj_dup = torch.cat([torch.zeros((qn, 1), dtype=torch.bool, device=sq.device),
                         (by_id[:, 1:] == by_id[:, :-1]) & (by_id[:, 1:] >= 0)], dim=1)
    dup = torch.zeros_like(adj_dup).scatter_(1, order_id, adj_dup)
    sq_d = torch.where(dup, torch.full_like(sq_s, float("inf")), sq_s)
    ids_d = torch.where(dup, torch.full_like(ids_s, -1), ids_s)
    sq_f, order2 = torch.sort(sq_d, dim=1, stable=True)
    return sq_f[:, :ef].contiguous(), torch.gather(ids_d, 1, order2[:, :ef])


def merge_shard_state(g_sq: torch.Tensor, g_ids: torch.Tensor, g_vis: torch.Tensor, *,
                      ef: int):
    """What every shard carries into the next wave: the shards' (S, Q, EF)
    windows merged (:func:`merge_shard_windows`) and their (S, q_tiles, W)
    bitmaps OR-ed (for S = 1, the shard's own)."""
    if g_sq.shape[0] == 1:
        return g_sq[0], g_ids[0], g_vis[0]
    sq, ids = merge_shard_windows(g_sq, g_ids, ef=ef)
    vis = g_vis[0]
    for v in g_vis[1:]:
        vis = vis | v
    return sq, ids, vis


def frozen_wave_inputs(estimator: Estimator, q_sorted, top_sq, top_ids, vis, slab,
                       gscales, *, base: int, n_nodes: int, ef: int, thresh_col: int,
                       block_q: int, block_c: int, block_d: int):
    """The inputs every frozen-threshold wave of a search shares over one
    shard's ``slab`` (adj_rot, adj_codes, adj_ids): ``(queries, table,
    kwargs)`` of ``graph_scan_kernel_call`` — the query codes, padded rows
    and scales; the block scales and the blocked table; the launch's
    keywords (``tighten=False``).  The window, r², bitmap and step table
    are the wave's own."""
    args, kw = graph_scan_inputs(
        estimator, q_sorted, torch.full((vis.shape[0], 1), -1, dtype=torch.int32), top_sq,
        top_ids, torch.zeros_like(top_sq[:, 0]), *slab, gscales, vis, vis_base=base,
        vis_nodes=n_nodes, ef=ef, thresh_col=thresh_col, block_q=block_q,
        block_c=block_c, block_d=block_d, tighten=False)
    return args[1:4], args[11:14], kw


def shard_launches(scan, parts, inputs, top_sq, top_ids, r0, vis):
    """One frozen-threshold wave over the shards in ``parts``: (offs, slab,
    base) each, the shard's localized frontier (:func:`localize_frontier`),
    its (adj_rot, adj_codes, adj_ids) rows and its first node, screened by
    ``scan`` (``graph_scan_kernel_call`` or ``ref.graph_scan_ref``) with the
    wave's shared ``inputs`` (:func:`frozen_wave_inputs`).  Returns the
    shards' outputs stacked in ``parts`` order: (S', Q, EF) windows and ids,
    (S', Q, 6) stats, (S', q_tiles, W) bitmaps; :func:`merge_shard_state`
    merges them once every shard's are in (a process group gathers first)."""
    q_in, table, kw = inputs
    outs = [scan(offs, *q_in, top_sq, top_ids, r0, vis, codes, rot, ids, *table, base, **kw)
            for offs, (rot, codes, ids), base in parts]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


class GraphShardedStats(NamedTuple):
    """Per-batch accounting of the corpus-sharded beam scan.

    The fetch ledgers are per shard (what each shard's memory shipped) plus
    their sum; the exchange ledger counts the cross-shard frontier traffic
    (``quant.accounting.frontier_exchange_bytes``).  Totals equal the
    single-shard walk's: splitting a frozen wave moves bytes between
    ledgers, it creates no work."""

    waves: float  # frontier waves until convergence (shard-count-invariant)
    num_shards: int
    rows_per_query: float  # valid neighbour rows screened / query (all shards)
    passed_per_query: float  # rows surviving the full screen / query
    bytes_per_query: float  # semantic dims-consumed ledger, summed
    fetched_bytes_per_query: float  # DMA ledger summed over shards
    shard_fetched_bytes_per_query: tuple  # per-shard DMA ledger
    shard_s1_tiles_fetched: tuple  # per-shard int8 adjacency tiles fetched
    shard_s2_slabs_fetched: tuple  # per-shard fp slabs fetched on demand
    s2_skip_rate: float  # fetch elision over all shards
    exchange_bytes_per_wave: float  # cross-shard frontier traffic / wave
    exchange_bytes_per_query: float  # total exchange / query
    # Failover accounting; zero / empty on a healthy run.
    tombstoned_nodes: float = 0.0  # nodes pre-visited by tombstones
    dead_shards: tuple = ()  # shards fully covered by tombstones


def _graph_sharded_stats(index: GraphIndex, *, dim: int, k: int, seed_r: bool,
                         qn: int, waves: float, sem, s1_tiles, s2_slabs,
                         exch_bytes: float, num_shards: int,
                         tombstones=()) -> GraphShardedStats:
    """The ``GraphShardedStats`` ledger arithmetic, shared by the sharded
    batch epilogue and the continuous engine's per-query ledger."""
    a_block = index.adj_block
    rows = max(float(sem[2]), 1.0)
    d_pad = index.adj_rot.shape[1]
    fp_bytes = index.adj_rot.element_size()
    seed_bytes = (index.degree * dim + 4 * k * dim) if seed_r else 0
    shard_fetched = []
    s2_total_all = 0.0
    for s in range(num_shards):
        s2_fetched_b, _, _, s2_total = stage2_fetch_report(
            s1_tiles[s], s2_slabs[s], block_c=a_block, d_pad=d_pad,
            block_d=index.scan_block_d, fp_bytes=fp_bytes)
        s2_total_all += s2_total
        shard_fetched.append(
            (fetched_tile_bytes(s1_tiles[s], block_c=a_block, dims=d_pad,
                                bytes_per_dim=1, id_bytes=ID_BYTES)
             + s2_fetched_b) / qn)
    skip = ((1.0 - float(np.asarray(s2_slabs).sum()) / s2_total_all)
            if s2_total_all else 0.0)
    tomb_nodes = 0
    dead = ()
    if tombstones:
        n = index.corpus_rot.shape[0]
        alive = _alive_mask(n, tombstones)
        tomb_nodes = int((~alive).sum())
        dead = tuple(s for s, (b, c) in enumerate(shard_graph_nodes(n, num_shards))
                     if not alive[b: b + c].any())
    return GraphShardedStats(
        waves=float(waves),
        num_shards=num_shards,
        rows_per_query=rows / qn,
        passed_per_query=float(sem[3]) / qn,
        bytes_per_query=float(two_stage_bytes(
            sem[0], sem[1], fp_bytes=fp_bytes)) / qn + seed_bytes,
        fetched_bytes_per_query=float(sum(shard_fetched)) + seed_bytes,
        shard_fetched_bytes_per_query=tuple(shard_fetched),
        shard_s1_tiles_fetched=tuple(np.asarray(s1_tiles).tolist()),
        shard_s2_slabs_fetched=tuple(np.asarray(s2_slabs).tolist()),
        s2_skip_rate=skip,
        exchange_bytes_per_wave=exch_bytes / max(waves, 1),
        exchange_bytes_per_query=exch_bytes / qn,
        tombstoned_nodes=float(tomb_nodes),
        dead_shards=dead,
    )


def slab_rows(index, base: int, count: int):
    """(adj_rot, adj_codes, adj_ids): the adjacency-flat rows of nodes
    ``[base, base + count)``, views of the slabs of ``index`` (a GraphIndex
    or anything with its slab fields)."""
    a = index.adj_block
    rows = slice(base * a, (base + count) * a)
    return index.adj_rot[rows], index.adj_codes[rows], index.adj_ids[rows]


@dataclasses.dataclass(frozen=True)
class GraphSlab:
    """What one shard of a corpus-sharded walk screens with: the adjacency
    rows of its nodes ``[base, base + count)`` of an ``n_nodes``-node
    graph, the block scales and the estimator (its table)."""

    estimator: Estimator
    adj_rot: torch.Tensor  # (count*A, D_pad)
    adj_codes: torch.Tensor  # (count*A, D_pad) int8
    adj_ids: torch.Tensor  # (count*A,) int32, global ids
    gscales: torch.Tensor
    adj_block: int
    scan_block_d: int
    n_nodes: int
    base: int


def graph_slab(index: GraphIndex, base: int, count: int) -> GraphSlab:
    """Shard ``[base, base + count)`` of ``index`` as a :class:`GraphSlab`
    (views, nothing copied)."""
    rot, codes, ids = slab_rows(index, base, count)
    return GraphSlab(estimator=index.estimator, adj_rot=rot, adj_codes=codes,
                     adj_ids=ids, gscales=index.gscales, adj_block=index.adj_block,
                     scan_block_d=index.scan_block_d,
                     n_nodes=index.corpus_rot.shape[0], base=int(base))


def localize_frontier(offs: torch.Tensor, ranges) -> torch.Tensor:
    """(q_tiles, steps) global frontier -> (S, q_tiles, steps): shard s sees
    the nodes it owns as offsets into its slab, at the same step positions,
    and -1 elsewhere."""
    minus = torch.full_like(offs, -1)
    return torch.stack([torch.where((offs >= b) & (offs < b + c), offs - b, minus)
                        for b, c in ranges])


def _run_sharded_wave_loop(index: GraphIndex, queries, *, k: int, ef: int,
                           expand: int, block_q: int, max_waves: int, seed_r: bool,
                           decoupled: bool, route_mult: float, num_shards: int,
                           use_ref: bool, wave_step=None, tombstones=(), exclude=()):
    """The reference's sharded wave loop: one wave at a time, the threshold
    frozen at each wave's start (``tighten=False``).

    Each wave: r0 = min(seed, window[thresh_col]); wave 0 expands the entry
    point, every later wave the frontier ``_select_wave`` picks with the
    gate r0 · ``route_mult``, until no tile has one; the frontier goes into
    a power-of-two ``steps`` table and is scattered per shard
    (:func:`localize_frontier`); each shard screens it with one launch of
    the one-wave kernel over its slab rows (``vis_base`` its first node, the
    bitmap the global one), or ``ref.graph_scan_ref`` with ``use_ref``;
    then the windows merge (:func:`merge_shard_windows`), the bitmaps OR,
    and the host books each shard's fetch counters and the wave's exchange
    bytes.  ``wave_step(offs_sh, q_sorted, top_sq, top_ids, r0, vis, *,
    wave)`` replaces the launches and the merge (a process group's step);
    it returns the merged window, bitmap and the (S, Q, 6) stats.

    Tombstones are pre-set in the starting bitmap (the entry and the seed
    fall back to the surviving corpus); ``exclude`` drops ids from the
    final windows.  The per-wave spans and instants are the reference's.
    Returns ``(dists, ids, acc)``, numpy, ``acc`` the raw accounting."""
    thresh_col = (k - 1) if decoupled else (ef - 1)
    est = index.estimator
    n = index.corpus_rot.shape[0]
    ranges = shard_graph_nodes(n, num_shards)
    a_block, block_d = index.adj_block, index.scan_block_d
    inv, q_sorted, q_tiles, q_pad, qn, entry, top_sq, top_ids, seed = _prep_wave_state(
        index, queries, k=k, ef=ef, block_q=block_q, seed_r=seed_r, tombstones=tombstones)
    dev = index.device
    words = graph_vis_words(n)
    vis = torch.zeros((q_tiles, words), dtype=torch.int32, device=dev)
    if tombstones:
        vis |= torch.as_tensor(pack_vis_ranges(n, tombstones), device=dev)[None, :]
    chaos = current_chaos()  # NULL_CHAOS: every on_wave below is a no-op
    if wave_step is None:
        slabs = [slab_rows(index, b, c) for b, c in ranges]
        inputs = frozen_wave_inputs(
            est, q_sorted, top_sq, top_ids, vis, slabs[0], index.gscales, base=0,
            n_nodes=n, ef=ef, thresh_col=thresh_col, block_q=block_q, block_c=a_block,
            block_d=block_d)
    sem = np.zeros((4,), np.float64)  # stats cols 0-3 summed over waves
    s1_tiles = np.zeros((num_shards,), np.float64)
    s2_slabs = np.zeros((num_shards,), np.float64)
    exch_bytes = 0.0
    waves = 0
    tr = current_tracer()
    d_pad = index.adj_rot.shape[1]
    fp_bytes = index.adj_rot.element_size()
    mult = torch.tensor(route_mult, dtype=torch.float32, device=dev)
    while waves < max_waves:
        chaos.on_wave(waves)  # injected shard-stall latency (chaos drills)
        with tr.span("graph.wave", wave=waves, num_shards=num_shards) as wsp:
            with tr.span("graph.route"):
                r0 = torch.minimum(seed, top_sq[:, thresh_col])
                if waves == 0:
                    # The entry point is expanded unconditionally: its own
                    # distance may exceed a seeded threshold, but its
                    # neighbourhood is what fills the window.
                    offs = torch.full((q_tiles, 1), entry, dtype=torch.int32, device=dev)
                    width = 1
                else:
                    offs = _select_wave(top_sq, top_ids, vis, r0 * mult, block_q=block_q,
                                        qn=qn, expand=expand, ef=ef)
                    width = int((offs >= 0).sum(dim=1).max())
                if width == 0:
                    wsp.annotate(terminal=True)
                    break  # no window entry can improve any query's result
                steps = pow2_bucket(width)
                offs = torch.nn.functional.pad(offs, (0, max(steps - offs.shape[1], 0)),
                                               value=-1)[:, :steps]
                offs_sh = localize_frontier(offs, ranges)
            wsp.annotate(width=width, steps=steps)

            if wave_step is not None:
                # The process group's step holds the launches, the
                # all-gather and the merge: no separate merge span.
                with tr.span("graph.launch", steps=steps):
                    t_sq, t_ids, t_vis, st_sh = tr.fence(wave_step(
                        offs_sh, q_sorted, top_sq, top_ids, r0, vis, wave=waves))
                tr.instant("graph.merge", in_step=True)
            else:
                # Looked up at call time: a caller may wrap the launch.
                scan = ref.graph_scan_ref if use_ref else graph_scan_kernel_call
                with tr.span("graph.launch", steps=steps):
                    g_sq, g_ids, st_sh, g_vis = shard_launches(
                        scan, [(offs_sh[s], slabs[s], b) for s, (b, _) in enumerate(ranges)],
                        inputs, top_sq, top_ids, r0, vis)
                    tr.fence(g_sq)
                with tr.span("graph.merge", num_shards=num_shards):
                    t_sq, t_ids, t_vis = merge_shard_state(g_sq, g_ids, g_vis, ef=ef)
                    t_sq, t_ids = tr.fence((t_sq, t_ids))

            with tr.span("graph.host_commit"):
                top_sq, top_ids, vis = t_sq, t_ids, t_vis
                st_np = st_sh.cpu().numpy()
                for s in range(num_shards):
                    sem += st_np[s][:qn, :4].sum(axis=0)
                    w1, w2 = fused_fetch_totals(st_np[s], block_q)
                    s1_tiles[s] += w1
                    s2_slabs[s] += w2
                    tr.instant("graph.stage1_dma", shard=s, wave=waves, tiles=w1,
                               bytes=fetched_tile_bytes(w1, block_c=a_block, dims=d_pad,
                                                        bytes_per_dim=1, id_bytes=ID_BYTES))
                    tr.instant("graph.stage2", shard=s, wave=waves, slabs=w2,
                               bytes=fetched_tile_bytes(w2, block_c=a_block, dims=block_d,
                                                        bytes_per_dim=fp_bytes))
                wave_exch = frontier_exchange_bytes(
                    num_shards=num_shards, queries=q_pad, ef=ef,
                    vis_words=q_tiles * words, q_tiles=q_tiles, steps=steps)
                tr.instant("graph.exchange", wave=waves, bytes=wave_exch)
                exch_bytes += wave_exch
            waves += 1

    top_sq_f, top_ids_f = top_sq[:qn].cpu().numpy(), top_ids[:qn].cpu().numpy()
    if exclude:
        top_sq_f, top_ids_f = _exclude_ids(top_sq_f, top_ids_f, n, exclude)
    inv = inv.cpu().numpy()
    dists = np.sqrt(np.maximum(top_sq_f, 0.0))[inv][:, :k]
    ids = top_ids_f[inv][:, :k]
    acc = dict(waves=waves, sem=sem, s1_tiles=s1_tiles, s2_slabs=s2_slabs,
               exch_bytes=exch_bytes, qn=qn)
    return dists, ids, acc


def search_graph_sharded(index: GraphIndex, queries, *, num_shards: int, k: int = 10,
                         ef: int = 48, expand: int = 2, block_q: int = KERNEL_TILE[0],
                         max_waves: int = 64, seed_r: bool = False,
                         decoupled: bool = True, route_mult: float = 1.0,
                         use_ref: bool = False, wave_step=None,
                         device: str | torch.device = "cuda", tombstones=(),
                         exclude=()):
    """Corpus-sharded batched graph search on ``device`` (the index's): the
    walk split over ``num_shards`` contiguous node ranges with cross-shard
    frontier exchange between waves.  Returns (dists (Q, k), ids (Q, k),
    GraphShardedStats).

    It differs from :func:`search_graph_fused` in one way: the DCO threshold
    is frozen at the wave-start r² for the whole wave (``tighten=False``),
    because a frozen wave is order-independent, so shards screening their
    parts of it commute.  So every shard count returns the same ids and
    distances, and ``num_shards=1, use_ref=True`` (the plain one-wave scan
    on the whole slab) is the oracle of every sharded run, on the card or
    across a process group (``wave_step``).  On CUDA tensors each shard's
    screen is one launch of the one-wave kernel; on CPU tensors, or with
    ``use_ref``, its plain version.

    Failover: ``tombstones`` ((base, count) node ranges, normally
    ``dead_shard_tombstones(n, S, dead)``) pre-visit the dead shards' nodes
    in the bitmap, so the surviving shards serve the walk over the rest of
    the corpus, equal to ``num_shards=1, use_ref=True`` with the same
    tombstones (the surviving-corpus oracle); the threshold seed samples
    only alive neighbours of the (possibly fallback) entry.  ``exclude``
    drops those ids from the result windows (mutable-index deletes)."""
    dev = resolve_device(device)
    if not index.has_fused:
        raise ValueError("the batched beam scan needs build_graph(..., quant='int8')")
    if dev.type != index.device.type or dev.index not in (None, index.device.index):
        raise ValueError(f"the index lives on {index.device}, the search was "
                         f"asked to run on {dev}")
    tombstones = tuple((int(b), int(c)) for b, c in tombstones)
    dists, ids, acc = _run_sharded_wave_loop(
        index, queries, k=k, ef=ef, expand=expand, block_q=block_q,
        max_waves=max_waves, seed_r=seed_r, decoupled=decoupled,
        route_mult=route_mult, num_shards=num_shards, use_ref=use_ref,
        wave_step=wave_step, tombstones=tombstones,
        exclude=tuple((int(b), int(c)) for b, c in exclude))
    stats = _graph_sharded_stats(
        index, dim=index.corpus_rot.shape[1], k=k, seed_r=seed_r, qn=acc["qn"],
        waves=acc["waves"], sem=acc["sem"], s1_tiles=acc["s1_tiles"],
        s2_slabs=acc["s2_slabs"], exch_bytes=acc["exch_bytes"],
        num_shards=num_shards, tombstones=tombstones)
    return (torch.as_tensor(dists, device=index.device),
            torch.as_tensor(ids, device=index.device), stats)
