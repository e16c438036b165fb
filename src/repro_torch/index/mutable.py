"""Streaming mutable indexes over the tile-aligned layouts (port of
``repro.index.mutable``).

Every index is built offline into sentinel-padded, tile-aligned slabs.  This
module makes those slabs mutable without giving up two properties:

  * **Layout invariants** — an upsert is a row write inside pre-reserved
    growth headroom (``capacity``); a delete is a tombstone (a bit pre-set
    in the graph walk's visited bitmap), never a compaction.  Kernels keep
    seeing the shapes they were built for.
  * **Rebuild equivalence** — a mutated index answers queries with the ids
    of a from-scratch rebuild of the final corpus.  For the graph this
    holds array for array: upserts replay the graph build's numpy arithmetic
    (``_insert_node_np`` / ``_trim_row_np`` of ``index.graph``), and every
    corpus row is rotated row by row (``OrthogonalTransform.apply_rows``),
    so an upserted row equals the same row rotated with the whole corpus.

Quantized mirrors stay honest by eager requantization on clip: the int8
scales are ``max|x_d|/127`` over the corpus, so a new row outside the fitted
envelope re-encodes every code slab from refitted scales, which therefore
always equal a rebuild's.

:class:`MutableGraph` keeps its serving slabs on its device: an upsert
writes the new row and re-gathers only the adjacency blocks of the nodes
its insertion touched (a requantize re-gathers them all, in one gather), and
``index`` is a view of the written prefix — it shares the slabs' storage,
so an index taken before a later mutation sees that mutation too.

:class:`DriftWatchdog` watches DADE staleness: it runs the paper's
hypothesis test in reverse (``calibration.violation_rates``) on a reservoir
sample of the live corpus and, when the observed false-prune rate leaves
the calibrated ``P_s`` band, recalibrates the epsilon table and swaps it in
behind a paired parity proof on the same pairs.  The PCA transform stays
frozen (the rotated slabs depend on it); only the table moves.  Pairs come
from ``torch.Generator`` streams seeded per check (the reference draws them
from ``jax.random`` keys, which torch cannot replay), or explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import calibration as calib
from repro_torch.core.estimators import Estimator, build_estimator
from repro_torch.core.transforms import as_tensor
from repro_torch.index.flat import FlatIndex, search_flat
from repro_torch.index.graph import (
    _DTYPES, SENTINEL, GraphIndex, _insert_node_np, _medoid_entry_np, _trim_row_np,
    adjacency_rows, search_graph_fused,
)
from repro_torch.index.ivf import IVFIndex, build_ivf, search_ivf
from repro_torch.quant.scalar import (
    fit_block_scales, fit_scales, quantize, quantize_block, wants_quant,
)
from repro_torch.runtime.chaos import current_chaos

__all__ = ["MutationLedger", "MutableFlat", "MutableIVF", "MutableGraph",
           "DriftWatchdog", "ids_to_ranges"]


def ids_to_ranges(ids) -> tuple:
    """Sorted ids -> merged ``((base, count), ...)`` ranges, the form of the
    graph search's ``tombstones=`` / ``exclude=`` hooks."""
    out: list[tuple[int, int]] = []
    for i in sorted(int(i) for i in ids):
        if out and i == out[-1][0] + out[-1][1]:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((i, 1))
    return tuple(out)


@dataclasses.dataclass
class MutationLedger:
    """Closed mutation accounting: ``applied == upserts + deletes +
    rejected`` at all times (what ``scripts/check_metrics_schema.py``
    enforces on the exported ``mutate.*`` family).  ``rejected`` counts
    refused operations (capacity exhausted, unknown or double delete);
    ``requantizes`` counts full int8 re-encodes triggered by scale clips."""

    applied: int = 0
    upserts: int = 0
    deletes: int = 0
    rejected: int = 0
    requantizes: int = 0

    def check(self) -> None:
        if self.applied != self.upserts + self.deletes + self.rejected:
            raise AssertionError(
                f"mutation ledger not closed: applied={self.applied} != "
                f"{self.upserts}+{self.deletes}+{self.rejected}")

    def as_metrics(self, prefix: str = "mutate") -> dict[str, float]:
        return {
            f"{prefix}.applied": float(self.applied),
            f"{prefix}.upserts": float(self.upserts),
            f"{prefix}.deletes": float(self.deletes),
            f"{prefix}.rejected": float(self.rejected),
            f"{prefix}.requantize": float(self.requantizes),
        }


def _vector(vec, dev: torch.device) -> torch.Tensor:
    """One vector (numpy, list or tensor) as a (1, D) float32 row on ``dev``."""
    return as_tensor(vec, dev).reshape(1, -1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _MutableBase:
    """Shared bookkeeping: the version-keyed view cache, the ledger, the
    estimator swap."""

    def __init__(self, estimator: Estimator):
        self.estimator = estimator
        self.ledger = MutationLedger()
        self._version = 0
        self._cache: tuple[int, object] | None = None

    def _bump(self) -> None:
        self._version += 1

    def set_estimator(self, est: Estimator) -> None:
        """Swap in a recalibrated estimator.  The transform must be the SAME
        object: the rotated slabs were produced by it."""
        if est.transform is not self.estimator.transform:
            raise ValueError(
                "set_estimator: transform changed — recalibration swaps the "
                "epsilon table only; the rotation is frozen with the slabs")
        self.estimator = est
        self._bump()


def _fit_estimator(method, x, generator, estimator, quant, dev, est_kwargs):
    if estimator is not None:
        return estimator
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return build_estimator(method, x, generator, quant=quant, device=dev, **est_kwargs)


# ---------------------------------------------------------------------------
# Flat
# ---------------------------------------------------------------------------


class MutableFlat(_MutableBase):
    """Mutable linear-scan index: an append-only growth slab and an alive
    bitmap, on the host; ``view()`` gathers the live rows into a
    :class:`FlatIndex` on the device (ids mapped back to global ids by
    :meth:`search`).  The int8 mirror keeps scales fitted over every row
    ever written — still a sound envelope for the live rows — refitted
    eagerly whenever a new row clips."""

    def __init__(self, data, *, capacity: int | None = None, method: str = "dade",
                 generator: torch.Generator | None = None,
                 estimator: Estimator | None = None, quant=None,
                 device: str | torch.device = "cuda", **est_kwargs):
        dev = resolve_device(device)
        x = as_tensor(data, dev)
        estimator = _fit_estimator(method, x, generator, estimator, quant, dev,
                                   est_kwargs)
        super().__init__(estimator)
        self.device = dev
        rot0 = _host(estimator.transform.apply_rows(x))
        n, dim = rot0.shape
        cap = int(capacity) if capacity is not None else 2 * n
        if cap < n:
            raise ValueError(f"capacity {cap} < initial corpus {n}")
        self.capacity = cap
        self.count = n
        self._corpus = np.zeros((cap, dim), np.float32)
        self._corpus[:n] = _host(x)
        self._rot = np.zeros((cap, dim), np.float32)
        self._rot[:n] = rot0
        self._alive = np.zeros(cap, bool)
        self._alive[:n] = True
        self._quant = wants_quant(quant, estimator.quant)
        if self._quant:
            self._amax = np.max(np.abs(rot0), axis=0)
            self._qscales = _host(fit_scales(torch.as_tensor(rot0)))
            self._codes = np.zeros((cap, dim), np.int8)
            self._codes[:n] = _host(quantize(torch.as_tensor(rot0),
                                             torch.as_tensor(self._qscales)))

    @property
    def live_count(self) -> int:
        return int(self._alive[: self.count].sum())

    def upsert(self, vec) -> int:
        """Append one vector; returns its global id, or -1 when refused
        (capacity exhausted)."""
        self.ledger.applied += 1
        if self.count >= self.capacity:
            self.ledger.rejected += 1
            return -1
        v = self.count
        x = _vector(vec, self.device)
        row = _host(self.estimator.transform.apply_rows(x))[0]
        self._corpus[v] = _host(x)[0]
        self._rot[v] = row
        self._alive[v] = True
        self.count = v + 1
        if self._quant:
            if np.any(np.abs(row) > self._amax):
                self._requantize()
            else:
                self._codes[v] = _host(quantize(torch.as_tensor(row)[None],
                                                torch.as_tensor(self._qscales)))[0]
        self.ledger.upserts += 1
        self._bump()
        return v

    def _requantize(self) -> None:
        rot = torch.as_tensor(self._rot[: self.count])
        self._amax = np.max(np.abs(self._rot[: self.count]), axis=0)
        self._qscales = _host(fit_scales(rot))
        self._codes[: self.count] = _host(quantize(rot, torch.as_tensor(self._qscales)))
        self.ledger.requantizes += 1

    def delete(self, gid: int) -> bool:
        self.ledger.applied += 1
        gid = int(gid)
        if not (0 <= gid < self.count and self._alive[gid]):
            self.ledger.rejected += 1
            return False
        self._alive[gid] = False
        self.ledger.deletes += 1
        self._bump()
        return True

    def view(self) -> tuple[FlatIndex, np.ndarray]:
        """(FlatIndex over the gathered live rows, live-row -> global-id map)."""
        if self._cache is not None and self._cache[0] == self._version:
            return self._cache[1]
        live = np.flatnonzero(self._alive[: self.count]).astype(np.int32)
        dev = self.device
        idx = FlatIndex(
            estimator=self.estimator,
            corpus_rot=torch.as_tensor(self._rot[live], device=dev),
            corpus=torch.as_tensor(self._corpus[live], device=dev),
            corpus_q=torch.as_tensor(self._codes[live], device=dev) if self._quant else None,
            qscales=torch.as_tensor(self._qscales, device=dev) if self._quant else None,
        )
        self._cache = (self._version, (idx, live))
        return idx, live

    def search(self, queries, *, k: int = 10, **kwargs):
        """Flat K-NN over the live rows; ids are GLOBAL ids."""
        idx, live = self.view()
        res = search_flat(idx, queries, k=k, **kwargs)
        ids = _host(res.ids)
        gids = np.where(ids >= 0, live[np.maximum(ids, 0)], -1).astype(np.int32)
        return res._replace(ids=torch.as_tensor(gids, device=self.device))


# ---------------------------------------------------------------------------
# IVF
# ---------------------------------------------------------------------------


class MutableIVF(_MutableBase):
    """Mutable IVF over per-cluster growth slabs, centroids frozen.

    Upserts go to the nearest frozen centroid (``_assign``) and land in the
    lowest free slot of that cluster's sentinel-padded slab; deletes punch a
    hole (id -1, sentinel row) that ``search_ivf``'s validity mask skips and
    later upserts reuse.  An upsert into a full slab is refused (ledger
    ``rejected``): spilling to another cluster would break the probe order.

    Only the padded-gather engine (``search_ivf``) is served; the fused CSR
    layout is an offline artifact, rebuilt when churn quiesces.
    :meth:`compact` is the rebuild comparator: the live corpus under the
    frozen centroids and estimator, holes squeezed, scales refitted."""

    def __init__(self, data, *, growth: int = 128, n_clusters: int = 64,
                 method: str = "dade", generator: torch.Generator | None = None,
                 estimator: Estimator | None = None, quant=None,
                 device: str | torch.device = "cuda", **build_kwargs):
        base = build_ivf(data, method=method, n_clusters=n_clusters,
                         generator=generator, estimator=estimator, quant=quant,
                         device=device, **build_kwargs)
        self._init_from(base, data, growth=growth)

    @classmethod
    def from_index(cls, base: IVFIndex, data, *, growth: int = 128) -> "MutableIVF":
        """A mutable index grown from an already built ``base`` (its
        padded-gather layout) over the corpus ``data`` it was built from."""
        self = cls.__new__(cls)
        self._init_from(base, data, growth=growth)
        return self

    def _init_from(self, base: IVFIndex, data, *, growth: int) -> None:
        super().__init__(base.estimator)
        self.device = base.device
        self._quant = base.has_quant
        self.centroids = _host(base.centroids)
        nc, cap0, dim = base.buckets.shape
        growth = (int(growth) + 127) // 128 * 128
        cap = cap0 + growth
        self.capacity = cap
        self._buckets = np.full((nc, cap, dim), SENTINEL, np.float32)
        self._buckets[:, :cap0] = _host(base.buckets)
        self._bucket_ids = np.full((nc, cap), -1, np.int32)
        self._bucket_ids[:, :cap0] = _host(base.bucket_ids)
        sizes = _host(base.bucket_sizes).astype(np.int64)
        self._fill = sizes.copy()  # high-water slot per cluster
        self._live = sizes.copy()  # live rows per cluster
        self.count = int(sizes.sum())  # global ids handed out so far
        # The rows as the build rotated them (one batch), for scale refits.
        rot0 = _host(self.estimator.rotate(as_tensor(data, self.device)))
        self._rot_seen = [rot0]
        self._slot: dict[int, tuple[int, int]] = {}
        for c in range(nc):
            for s in range(int(sizes[c])):
                self._slot[int(self._bucket_ids[c, s])] = (c, s)
        self._deleted: set[int] = set()
        if self._quant:
            self._amax = np.max(np.abs(rot0), axis=0)
            self._qscales = _host(base.qscales)
            self._qbuckets = np.zeros((nc, cap, dim), np.int8)
            self._qbuckets[:, :cap0] = _host(base.qbuckets)

    def _assign(self, rot_row: np.ndarray) -> int:
        """The frozen-centroid assignment rule, shared with :meth:`compact`."""
        d = self.centroids - rot_row[None, :]
        return int(np.argmin(np.einsum("nd,nd->n", d, d)))

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    def upsert(self, vec) -> int:
        self.ledger.applied += 1
        row = _host(self.estimator.transform.apply_rows(_vector(vec, self.device)))[0]
        c = self._assign(row)
        holes = np.flatnonzero(self._bucket_ids[c, : self._fill[c]] < 0)
        if holes.size:
            s = int(holes[0])
        elif self._fill[c] < self.capacity:
            s = int(self._fill[c])
            self._fill[c] += 1
        else:
            self.ledger.rejected += 1
            return -1
        gid = self.count
        self.count = gid + 1
        self._buckets[c, s] = row
        self._bucket_ids[c, s] = gid
        self._slot[gid] = (c, s)
        self._live[c] += 1
        self._rot_seen.append(row[None, :])
        if self._quant:
            if np.any(np.abs(row) > self._amax):
                self._requantize()
            else:
                self._qbuckets[c, s] = _host(quantize(
                    torch.as_tensor(row)[None], torch.as_tensor(self._qscales)))[0]
        self.ledger.upserts += 1
        self._bump()
        return gid

    def _requantize(self) -> None:
        seen = np.concatenate(self._rot_seen, axis=0)
        self._rot_seen = [seen]
        self._amax = np.max(np.abs(seen), axis=0)
        self._qscales = _host(fit_scales(torch.as_tensor(seen)))
        scales = torch.as_tensor(self._qscales)
        for c in range(self._buckets.shape[0]):
            f = int(self._fill[c])
            if not f:
                continue
            sl = self._bucket_ids[c, :f] >= 0
            rows = torch.as_tensor(self._buckets[c, :f][sl])
            self._qbuckets[c, :f][sl] = _host(quantize(rows, scales))
        self.ledger.requantizes += 1

    def delete(self, gid: int) -> bool:
        self.ledger.applied += 1
        gid = int(gid)
        if gid in self._deleted or gid not in self._slot:
            self.ledger.rejected += 1
            return False
        c, s = self._slot[gid]
        self._bucket_ids[c, s] = -1
        self._buckets[c, s] = SENTINEL
        if self._quant:
            self._qbuckets[c, s] = 0
        self._live[c] -= 1
        self._deleted.add(gid)
        self.ledger.deletes += 1
        self._bump()
        return True

    def _index(self, buckets, bucket_ids, sizes, qbuckets, qscales, max_bucket):
        dev = self.device
        t = (lambda a: None if a is None else torch.as_tensor(a, device=dev))
        return IVFIndex(
            estimator=self.estimator, centroids=t(self.centroids),
            bucket_sizes=t(np.asarray(sizes, np.int32)), buckets=t(buckets),
            bucket_ids=t(bucket_ids), qbuckets=t(qbuckets), qscales=t(qscales),
            max_bucket=int(max_bucket))

    def view(self) -> IVFIndex:
        """The padded-gather index over the (hole-y) growth slabs."""
        if self._cache is not None and self._cache[0] == self._version:
            return self._cache[1]
        idx = self._index(self._buckets, self._bucket_ids, self._live,
                          self._qbuckets if self._quant else None,
                          self._qscales if self._quant else None,
                          self._fill.max())
        self._cache = (self._version, idx)
        return idx

    def compact(self) -> IVFIndex:
        """From-scratch layout of the LIVE corpus under the frozen centroids
        and estimator: holes squeezed, scales refitted on the live rows."""
        nc, _, dim = self._buckets.shape
        rows: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(nc)]
        for gid in sorted(self._slot):
            if gid in self._deleted:
                continue
            c, s = self._slot[gid]
            rows[c].append((gid, self._buckets[c, s]))
        cap = max(1, max((len(r) for r in rows), default=1))
        cap = (cap + 127) // 128 * 128
        buckets = np.full((nc, cap, dim), SENTINEL, np.float32)
        bucket_ids = np.full((nc, cap), -1, np.int32)
        sizes = np.zeros(nc, np.int32)
        for c in range(nc):
            for s, (gid, row) in enumerate(rows[c]):
                buckets[c, s] = row
                bucket_ids[c, s] = gid
            sizes[c] = len(rows[c])
        qbuckets = qscales = None
        if self._quant:
            live_rot = np.concatenate(
                [buckets[c, : sizes[c]] for c in range(nc) if sizes[c]], axis=0)
            qscales = _host(fit_scales(torch.as_tensor(live_rot)))
            qbuckets = np.zeros((nc, cap, dim), np.int8)
            for c in range(nc):
                if sizes[c]:
                    qbuckets[c, : sizes[c]] = _host(quantize(
                        torch.as_tensor(buckets[c, : sizes[c]]),
                        torch.as_tensor(qscales)))
        return self._index(buckets, bucket_ids, sizes, qbuckets, qscales, sizes.max())

    def search(self, queries, *, k: int = 10, **kwargs):
        kwargs.setdefault("device", self.device)
        return search_ivf(self.view(), queries, k=k, **kwargs)


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class MutableGraph(_MutableBase):
    """Mutable NSW graph in capacity slabs, array for array a rebuild.

    The constructor replays the graph build's insertion loop into
    over-allocated slabs and KEEPS the over-provisioned adjacency and
    degrees the one-shot build throws away: that state lets an upsert
    continue the construction exactly where a from-scratch build of the
    longer corpus would be.  After every upsert the touched rows are
    re-trimmed (``_trim_row_np`` depends only on the row's own
    over-provisioned neighbours and the rotated rows, so trimming after the
    last touch equals the end-of-build trim) and the entry medoid
    is recomputed lazily.  So after any upsert sequence the neighbours,
    entry and int8 arrays equal ``build_graph`` over the concatenated corpus
    bit for bit.

    Deletes are mark-deletes: the row stays a routing waypoint (as in a
    rebuild of the concatenated corpus) but is tombstoned (never expanded,
    never seeding the threshold) and excluded from result windows;
    :meth:`search` passes both.  The serving slabs (rotated rows, trimmed
    neighbours, int8 codes and the adjacency-flat layout) live on
    ``device``; the build's working state lives in numpy on the host.
    """

    def __init__(self, data, *, m: int = 16, ef_construction: int = 100,
                 capacity: int | None = None, method: str = "dade",
                 generator: torch.Generator | None = None,
                 estimator: Estimator | None = None, quant=None,
                 scan_block_d: int | None = None, adj_block: int | None = None,
                 adj_dtype: str = "float32", device: str | torch.device = "cuda",
                 **est_kwargs):
        dev = resolve_device(device)
        x = as_tensor(data, dev)
        estimator = _fit_estimator(method, x, generator, estimator, quant, dev,
                                   est_kwargs)
        super().__init__(estimator)
        self.device = dev
        rot0_t = estimator.transform.apply_rows(x)
        rot0 = _host(rot0_t)
        n, dim = rot0.shape
        cap = int(capacity) if capacity is not None else 2 * n
        if cap < n:
            raise ValueError(f"capacity {cap} < initial corpus {n}")
        self.capacity = cap
        self.count = n
        self.m = int(m)
        self.efc = int(ef_construction)
        self._corpus = np.zeros((cap, dim), np.float32)
        self._corpus[:n] = _host(x)
        self._rot = np.zeros((cap, dim), np.float32)
        self._rot[:n] = rot0
        # The build's working state, kept live: over-provisioned adjacency
        # (2m slots) and degrees, and the trimmed serving rows.
        self._adj = np.full((cap, 2 * self.m), -1, np.int64)
        self._deg = np.zeros(cap, np.int64)
        for v in range(1, n):
            _insert_node_np(self._rot, self._adj, self._deg, v, m=self.m,
                            ef_construction=self.efc)
        self._final = np.full((cap, self.m), -1, np.int64)
        for v in range(n):
            self._final[v] = _trim_row_np(self._rot, self._adj, self._deg, v, self.m)
        self._entry: int | None = _medoid_entry_np(self._rot[:n])
        self._deleted: set[int] = set()
        # The serving slabs on the device.
        self._rot_t = torch.zeros((cap, dim), dtype=torch.float32, device=dev)
        self._rot_t[:n] = rot0_t
        self._nbr_t = torch.full((cap, self.m), -1, dtype=torch.int32, device=dev)
        self._nbr_t[:n] = torch.as_tensor(self._final[:n], device=dev)
        self._quant = wants_quant(quant, estimator.quant)
        self.scan_block_d = 0
        self.adj_block = 0
        if self._quant:
            block_d = (int(estimator.table.dims[0]) if scan_block_d is None
                       else int(scan_block_d))
            d_pad = (dim + block_d - 1) // block_d * block_d
            a_block = ((max(self.m, 1) + 31) // 32 * 32 if adj_block is None
                       else int(adj_block))
            if a_block < self.m:
                raise ValueError(f"adj_block {a_block} < graph degree {self.m}")
            self.scan_block_d = block_d
            self.adj_block = a_block
            self._adt = _DTYPES[adj_dtype]
            self._rot_pad_t = torch.zeros((cap, d_pad), dtype=torch.float32, device=dev)
            self._rot_pad_t[:n, :dim] = rot0_t
            self._codes_t = torch.zeros((cap, dim), dtype=torch.int8, device=dev)
            self._codes_blk_t = torch.zeros((cap, d_pad), dtype=torch.int8, device=dev)
            self._adj_rot_t = torch.full((cap * a_block, d_pad), SENTINEL,
                                         dtype=self._adt, device=dev)
            self._adj_codes_t = torch.zeros((cap * a_block, d_pad), dtype=torch.int8,
                                            device=dev)
            self._adj_ids_t = torch.full((cap * a_block,), -1, dtype=torch.int32,
                                         device=dev)
            self._requantize()
            self.ledger.requantizes -= 1  # the initial encode, not a clip

    # ---- quant slab maintenance -----------------------------------------

    def _refresh_adj_rows(self, nodes) -> None:
        """Re-gather the adjacency blocks of ``nodes`` on the device."""
        a = self.adj_block
        dev = self.device
        nodes_t = torch.as_tensor(np.asarray(sorted(nodes), np.int64), device=dev)
        rot, codes, ids = adjacency_rows(self._nbr_t[nodes_t], self._rot_pad_t,
                                         self._codes_blk_t, a)
        rows = (nodes_t[:, None] * a + torch.arange(a, device=dev)[None, :]).reshape(-1)
        self._adj_rot_t[rows] = rot.to(self._adt)
        self._adj_codes_t[rows] = codes
        self._adj_ids_t[rows] = ids

    def _requantize(self) -> None:
        """Full re-encode from refitted scales (a new row clipped): refitting
        over the whole written slab is what ``build_graph`` fits over the
        concatenated corpus, so the codes stay a rebuild's."""
        c = self.count
        block_d = self.scan_block_d
        amax = np.max(np.abs(self._rot[:c]), axis=0)
        self._amax = amax
        pad = np.zeros((self._rot_pad_t.shape[1],), np.float32)
        pad[: amax.shape[0]] = amax
        self._bamax = pad.reshape(-1, block_d).max(axis=1)
        rot = self._rot_t[:c]
        self._qscales_t = fit_scales(rot)
        self._codes_t[:c] = quantize(rot, self._qscales_t)
        self._gscales_t = fit_block_scales(self._rot_pad_t[:c], block_d)
        self._codes_blk_t[:c] = quantize_block(self._rot_pad_t[:c], self._gscales_t,
                                               block_d)
        self._refresh_adj_rows(range(c))
        self.ledger.requantizes += 1

    # ---- mutations -------------------------------------------------------

    def upsert(self, vec) -> int:
        """Insert one vector through the build's own incremental link
        step; returns its global id, or -1 when capacity is exhausted."""
        self.ledger.applied += 1
        if self.count >= self.capacity:
            self.ledger.rejected += 1
            return -1
        v = self.count
        x = _vector(vec, self.device)
        row_t = self.estimator.transform.apply_rows(x)[0]
        row = _host(row_t)
        self._corpus[v] = _host(x)[0]
        self._rot[v] = row
        self._rot_t[v] = row_t
        self.count = v + 1
        targets = _insert_node_np(self._rot, self._adj, self._deg, v,
                                  m=self.m, ef_construction=self.efc)
        touched = sorted({v, *(int(t) for t in np.asarray(targets).ravel())})
        for t in touched:
            self._final[t] = _trim_row_np(self._rot, self._adj, self._deg, t, self.m)
        self._nbr_t[touched] = torch.as_tensor(self._final[touched], device=self.device,
                                               dtype=torch.int32)
        self._entry = None  # the medoid moved; recomputed lazily by `index`
        if self._quant:
            dim = row.shape[0]
            self._rot_pad_t[v, :dim] = row_t
            row_pad = np.zeros((self._rot_pad_t.shape[1],), np.float32)
            row_pad[:dim] = row
            bmax = np.max(np.abs(row_pad).reshape(-1, self.scan_block_d), axis=1)
            if np.any(np.abs(row) > self._amax) or np.any(bmax > self._bamax):
                self._requantize()
            else:
                self._codes_t[v] = quantize(row_t[None], self._qscales_t)[0]
                self._codes_blk_t[v] = quantize_block(
                    self._rot_pad_t[v: v + 1], self._gscales_t, self.scan_block_d)[0]
                self._refresh_adj_rows(touched)
        self.ledger.upserts += 1
        self._bump()
        return v

    def delete(self, gid: int) -> bool:
        """Mark-delete: the row keeps routing (as in a rebuild of the
        concatenated corpus) but is tombstoned and excluded at search time."""
        self.ledger.applied += 1
        gid = int(gid)
        if not (0 <= gid < self.count) or gid in self._deleted:
            self.ledger.rejected += 1
            return False
        self._deleted.add(gid)
        self.ledger.deletes += 1
        self._bump()
        return True

    # ---- views -----------------------------------------------------------

    @property
    def live_count(self) -> int:
        return self.count - len(self._deleted)

    @property
    def tombstones(self) -> tuple:
        """Deleted ids as ``((base, count), ...)`` ranges, passed as both
        ``tombstones=`` (never expand) and ``exclude=`` (never return)."""
        return ids_to_ranges(self._deleted)

    @property
    def index(self) -> GraphIndex:
        """The GraphIndex over the written prefix of the slabs: views of the
        device slabs (no copy), equal array for array to ``build_graph``
        on the concatenated corpus."""
        if self._cache is not None and self._cache[0] == self._version:
            return self._cache[1]
        c = self.count
        if self._entry is None:
            self._entry = _medoid_entry_np(self._rot[:c])
        kw: dict = {}
        if self._quant:
            a = self.adj_block
            kw = dict(corpus_q=self._codes_t[:c], qscales=self._qscales_t,
                      adj_rot=self._adj_rot_t[: c * a],
                      adj_codes=self._adj_codes_t[: c * a],
                      adj_ids=self._adj_ids_t[: c * a], gscales=self._gscales_t,
                      adj_block=a, scan_block_d=self.scan_block_d)
        idx = GraphIndex(estimator=self.estimator, corpus_rot=self._rot_t[:c],
                         neighbors=self._nbr_t[:c], entry=int(self._entry), **kw)
        self._cache = (self._version, idx)
        return idx

    def search(self, queries, *, k: int = 10, **kwargs):
        """Fused beam search over the live graph: deleted rows are
        tombstoned out of expansion and seeding and excluded from results."""
        t = self.tombstones
        kwargs.setdefault("device", self.device)
        return search_graph_fused(self.index, queries, k=k, tombstones=t,
                                  exclude=t, **kwargs)

    # ---- snapshots -------------------------------------------------------

    def snapshot_arrays(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, extra) for ``CheckpointManager.save_named``: the mutable
        state except the estimator (the caller restores that) and the
        quantized slabs (derived state, re-encoded on restore)."""
        c = self.count
        arrays = {
            "adj": self._adj[:c],
            "corpus": self._corpus[:c],
            "deg": self._deg[:c],
            "deleted": np.asarray(sorted(self._deleted), np.int64),
            "final": self._final[:c],
        }
        extra = {"count": c, "m": self.m, "ef_construction": self.efc,
                 "capacity": self.capacity,
                 "entry": int(self._entry) if self._entry is not None else -1,
                 "ledger": dataclasses.asdict(self.ledger)}
        return arrays, extra

    @classmethod
    def from_snapshot(cls, arrays: dict, extra: dict, estimator: Estimator,
                      **kwargs) -> "MutableGraph":
        """A MutableGraph from :meth:`snapshot_arrays` output: the slabs are
        restored directly (no insertion replay), then the quantized
        mirrors re-derived (the same rows, refitted scales)."""
        c = int(extra["count"])
        self = cls(arrays["corpus"][: max(1, min(2, c))], m=extra["m"],
                   ef_construction=extra["ef_construction"],
                   capacity=extra["capacity"], estimator=estimator, **kwargs)
        dev = self.device
        rot_t = estimator.transform.apply_rows(as_tensor(arrays["corpus"], dev))
        self.count = c
        self._corpus[:c] = arrays["corpus"]
        self._rot[:c] = _host(rot_t)
        self._rot_t[:c] = rot_t
        self._adj[:c] = arrays["adj"]
        self._adj[c:] = -1
        self._deg[:c] = arrays["deg"]
        self._deg[c:] = 0
        self._final[:c] = arrays["final"]
        self._final[c:] = -1
        self._nbr_t[:] = torch.as_tensor(self._final, device=dev)
        self._deleted = set(int(i) for i in arrays["deleted"])
        self._entry = int(extra["entry"]) if int(extra["entry"]) >= 0 else None
        self.ledger = MutationLedger(**extra.get("ledger", {}))
        if self._quant:
            dim = rot_t.shape[1]
            self._rot_pad_t.zero_()
            self._rot_pad_t[:c, :dim] = rot_t
            self._codes_t[c:] = 0
            self._codes_blk_t[c:] = 0
            self._adj_rot_t.fill_(SENTINEL)
            self._adj_codes_t.zero_()
            self._adj_ids_t.fill_(-1)
            self._requantize()
            self.ledger.requantizes -= 1  # the restore's derivation, not a clip
        self._bump()
        return self


# ---------------------------------------------------------------------------
# Drift watchdog
# ---------------------------------------------------------------------------


def _stream(seed: int, tag: int, step: int) -> torch.Generator:
    """A CPU generator for one (seed, stream tag, step): disjoint streams
    for the checks and the recalibrations, each replayable."""
    state = np.random.SeedSequence([int(seed), int(tag), int(step)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


_CHECK_STREAM, _RECAL_STREAM = 0, 0x7EC4


class DriftWatchdog:
    """DADE staleness detector and recalibration swap.

    Keeps a reservoir sample (Vitter's algorithm R, numpy-seeded as the
    reference's, so the reservoir replays exactly) of the original-space
    live corpus.  ``check()`` measures the per-checkpoint false-prune rate
    on the reservoir (:func:`calibration.violation_rates`); calibration
    promises about ``p_s``, so when the worst non-final checkpoint exceeds
    ``fire_factor * p_s`` the table is stale and :meth:`maybe_recalibrate`
    refits it on the reservoir, swapping it in only if a paired parity proof
    passes: on the SAME pairs the new table's rates are back inside the
    band and no worse than the old table's.  The transform is never refit;
    the ``stale_transform`` chaos fault suppresses the swap.  Pairs are
    drawn from per-check ``torch.Generator`` streams, or given explicitly
    (``pairs=``, ``recal_pairs=``)."""

    def __init__(self, data, *, reservoir: int = 1024, p_s: float = 0.1,
                 fire_factor: float = 3.0, num_pairs: int = 2048, seed: int = 0):
        data = _host(data) if isinstance(data, torch.Tensor) else np.asarray(data, np.float32)
        self.p_s = float(p_s)
        self.fire_factor = float(fire_factor)
        self.num_pairs = int(num_pairs)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        r = min(int(reservoir), data.shape[0])
        sel = self._rng.choice(data.shape[0], size=r, replace=False)
        self._buf = data[np.sort(sel)].copy()
        self._seen = data.shape[0]
        self.checks = 0
        self.fired = 0
        self.recalibrations = 0
        self.suppressed = 0
        self.parity_failed = 0
        self.last_stat = 0.0

    def observe(self, vec) -> None:
        """Fold one upserted vector into the reservoir (algorithm R)."""
        self._seen += 1
        j = int(self._rng.integers(0, self._seen))
        if j < self._buf.shape[0]:
            self._buf[j] = _host(vec) if isinstance(vec, torch.Tensor) else np.asarray(
                vec, np.float32)

    def _rates(self, table, transform, pairs) -> np.ndarray:
        return _host(calib.violation_rates(table, transform, self._buf, pairs=pairs))

    def _pairs(self, tag: int):
        return calib.sample_pairs(self._buf.shape[0], self.num_pairs,
                                  _stream(self.seed, tag, self.checks))

    def check(self, estimator: Estimator, *, pairs=None) -> dict:
        """Measure staleness; returns a report (no side effects on the
        index).  ``stat`` is the worst non-final checkpoint's violation
        rate; ``fired`` when it leaves the ``fire_factor * p_s`` band."""
        self.checks += 1
        table = estimator.table
        if table.num_steps < 2:
            return {"stat": 0.0, "threshold": 0.0, "fired": False}
        if pairs is None:
            pairs = self._pairs(_CHECK_STREAM)
        rates = self._rates(table, estimator.transform, pairs)
        stat = float(rates[:-1].max())
        self.last_stat = stat
        thr = self.fire_factor * self.p_s
        fired = stat > thr
        if fired:
            self.fired += 1
        return {"stat": stat, "threshold": thr, "fired": fired, "_pairs": pairs}

    def maybe_recalibrate(self, holder: _MutableBase, *, pairs=None,
                          recal_pairs=None) -> dict:
        """Check; on fire, recalibrate on the reservoir and swap the
        holder's table in iff the paired parity proof passes.  Honours the
        ``stale_transform`` chaos fault (the swap is suppressed)."""
        est = holder.estimator
        report = self.check(est, pairs=pairs)
        pairs = report.pop("_pairs", None)
        report.update(swapped=False, suppressed=False, parity_ok=None)
        if not report["fired"]:
            return report
        if current_chaos().stale_transform_active():
            self.suppressed += 1
            report["suppressed"] = True
            return report
        table = est.table
        delta_d = int(table.dims[0])
        n_recal = max(self.num_pairs, 2048)
        if recal_pairs is None:
            recal_pairs = calib.sample_pairs(self._buf.shape[0], n_recal,
                                             _stream(self.seed, _RECAL_STREAM, self.checks))
        new_table = calib.calibrate(est.transform, self._buf, p_s=self.p_s,
                                    delta_d=delta_d, num_pairs=n_recal,
                                    pairs=recal_pairs)
        # The paired parity proof: the same pairs for both tables.
        old_rates = self._rates(table, est.transform, pairs)
        new_rates = self._rates(new_table, est.transform, pairs)
        worst_new = float(new_rates[:-1].max())
        parity = (worst_new <= self.fire_factor * self.p_s
                  and worst_new <= float(old_rates[:-1].max()))
        report["parity_ok"] = parity
        if not parity:
            self.parity_failed += 1
            return report
        holder.set_estimator(dataclasses.replace(est, table=new_table))
        self.recalibrations += 1
        report["swapped"] = True
        return report

    def as_metrics(self, prefix: str = "calib.drift") -> dict[str, float]:
        return {
            f"{prefix}.checks": float(self.checks),
            f"{prefix}.fired": float(self.fired),
            f"{prefix}.recalibrations": float(self.recalibrations),
            f"{prefix}.suppressed": float(self.suppressed),
            f"{prefix}.parity_failed": float(self.parity_failed),
            f"{prefix}.stat": float(self.last_stat),
        }
