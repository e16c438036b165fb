"""Warm-restart snapshots of built serving indexes (port of
``repro.checkpoint.index_io``), leaf for leaf the reference's: the same
leaf names and ``extra`` keys (``kind``, ``config``, ``estimator``,
``optional``, ``adj_block``, ``scan_block_d``), so a snapshot written by
either package loads in the other.

  * every leaf carries a sha256 digest: a corrupted slab fails the load
    with an ``IOError`` naming the leaf, and the server rebuilds instead of
    serving wrong neighbours;
  * a JSON config echo (corpus size and dim, DCO method, quantization,
    graph layout) is stored beside the arrays and compared on load: a
    snapshot built under other settings is refused (load returns
    ``None``) rather than trusted;
  * saves commit atomically (the manager's tmp directory and rename).

A bfloat16 adjacency slab is stored as float32 (numpy has no bfloat16; the
values are exact there) with ``adj_dtype`` in ``extra``, and restored as
bfloat16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.estimators import Estimator
from repro_torch.core.transforms import OrthogonalTransform
from repro_torch.index.graph import GraphIndex, GraphSlab, shard_graph_nodes
from repro_torch.quant.scalar import QuantConfig

__all__ = ["save_graph_index", "load_graph_index", "load_graph_slab",
           "save_estimator", "load_estimator"]

_STEP = 0  # one snapshot per directory

# Optional GraphIndex array fields, saved only when present; the list of
# those present travels in ``extra["optional"]``.
_OPTIONAL = ("corpus_q", "qscales", "adj_rot", "adj_codes", "adj_ids", "gscales")


def _pack_estimator(est: Estimator, out: dict[str, Any], prefix: str = "est.") -> dict:
    t, tb = est.transform, est.table
    out[prefix + "basis"] = t.basis
    out[prefix + "variances"] = t.variances
    out[prefix + "cum_variances"] = t.cum_variances
    out[prefix + "dims"] = tb.dims
    out[prefix + "eps"] = tb.eps
    out[prefix + "scale"] = tb.scale
    out[prefix + "eps_lo"] = tb.eps_lo
    return {"method": est.method,
            "quant": None if est.quant is None
            else {"bits": est.quant.bits, "slack": est.quant.slack}}


def _unpack_estimator(arrays: dict[str, np.ndarray], meta: dict, dev,
                      prefix: str = "est.") -> Estimator:
    t = (lambda name, dt: torch.as_tensor(arrays[prefix + name], dtype=dt, device=dev))
    quant = meta.get("quant")
    return Estimator(
        method=meta["method"],
        transform=OrthogonalTransform(basis=t("basis", torch.float32),
                                      variances=t("variances", torch.float32),
                                      cum_variances=t("cum_variances", torch.float32)),
        table=EpsilonTable(dims=t("dims", torch.int32), eps=t("eps", torch.float32),
                           scale=t("scale", torch.float32),
                           eps_lo=t("eps_lo", torch.float32)),
        quant=None if quant is None else QuantConfig(**quant))


def save_graph_index(directory: str, index: GraphIndex, *,
                     config: dict | None = None) -> None:
    """Snapshot a built GraphIndex and its estimator into ``directory``.
    ``config`` is a JSON build echo that :func:`load_graph_index` compares
    against the caller's expectation."""
    arrays: dict[str, Any] = {
        "corpus_rot": index.corpus_rot,
        "neighbors": index.neighbors,
        "entry": np.asarray(index.entry, np.int32),
    }
    est_meta = _pack_estimator(index.estimator, arrays)
    present = []
    for name in _OPTIONAL:
        leaf = getattr(index, name)
        if leaf is not None:
            arrays[name] = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
            present.append(name)
    extra = {
        "kind": "graph_index",
        "estimator": est_meta,
        "optional": present,
        "adj_block": index.adj_block,
        "scan_block_d": index.scan_block_d,
        "config": config or {},
    }
    if index.adj_rot is not None and index.adj_rot.dtype == torch.bfloat16:
        extra["adj_dtype"] = "bfloat16"
    CheckpointManager(directory, keep=1, async_save=False).save_named(
        _STEP, arrays, extra=extra)


def load_graph_index(directory: str, *, expect_config: dict | None = None,
                     device: str | torch.device = "cuda") -> GraphIndex | None:
    """The GraphIndex snapshotted in ``directory``, on ``device``, or
    ``None`` (no snapshot, or one whose config echo differs from
    ``expect_config``: rebuild).  A digest failure is not swallowed: it
    raises ``IOError`` naming the leaf, and the caller decides."""
    dev = resolve_device(device)
    mgr = CheckpointManager(directory, keep=1, async_save=False)
    if mgr.latest_step() is None:
        return None
    arrays, extra = mgr.restore_named(_STEP)
    if extra.get("kind") != "graph_index":
        return None
    if expect_config is not None and extra.get("config") != expect_config:
        return None
    est = _unpack_estimator(arrays, extra["estimator"], dev)
    opt = {name: (torch.as_tensor(arrays[name], device=dev)
                  if name in extra.get("optional", []) else None)
           for name in _OPTIONAL}
    if opt["adj_rot"] is not None and extra.get("adj_dtype") == "bfloat16":
        opt["adj_rot"] = opt["adj_rot"].to(torch.bfloat16)
    return GraphIndex(
        estimator=est,
        corpus_rot=torch.as_tensor(arrays["corpus_rot"], device=dev),
        neighbors=torch.as_tensor(arrays["neighbors"], dtype=torch.int32, device=dev),
        entry=int(arrays["entry"]),
        adj_block=int(extra.get("adj_block", 0)),
        scan_block_d=int(extra.get("scan_block_d", 0)),
        **opt)


def load_graph_slab(directory: str, *, shard: int, num_shards: int,
                    device: str | torch.device = "cuda") -> GraphSlab:
    """Shard ``shard`` of ``num_shards`` of the graph snapshotted in
    ``directory`` (``index.graph.shard_graph_nodes``), on ``device``: only
    its adjacency rows reach the device.  Every leaf read is digest-checked;
    a snapshot without the int8 layout is refused."""
    dev = resolve_device(device)
    mgr = CheckpointManager(directory, keep=1, async_save=False)
    if mgr.latest_step() is None:
        raise IOError(f"no graph snapshot in {directory}")
    est_names = {"est." + f for f in ("basis", "variances", "cum_variances", "dims",
                                      "eps", "scale", "eps_lo")}
    arrays, extra = mgr.restore_named(
        _STEP, only=est_names | {"adj_rot", "adj_codes", "adj_ids", "gscales"})
    if extra.get("kind") != "graph_index" or "adj_codes" not in extra.get("optional", []):
        raise IOError(f"{directory} holds no int8 graph index snapshot")
    a_block = int(extra["adj_block"])
    n = arrays["adj_ids"].shape[0] // a_block
    base, count = shard_graph_nodes(n, num_shards)[shard]
    rows = slice(base * a_block, (base + count) * a_block)
    rot = torch.as_tensor(arrays["adj_rot"][rows], device=dev)
    if extra.get("adj_dtype") == "bfloat16":
        rot = rot.to(torch.bfloat16)
    return GraphSlab(
        estimator=_unpack_estimator(arrays, extra["estimator"], dev), adj_rot=rot,
        adj_codes=torch.as_tensor(arrays["adj_codes"][rows], device=dev),
        adj_ids=torch.as_tensor(arrays["adj_ids"][rows], device=dev),
        gscales=torch.as_tensor(arrays["gscales"], device=dev), adj_block=a_block,
        scan_block_d=int(extra["scan_block_d"]), n_nodes=n, base=base)


def save_estimator(directory: str, est: Estimator, *,
                   config: dict | None = None) -> None:
    """Snapshot a calibrated estimator (the flat route's warm restart)."""
    arrays: dict[str, Any] = {}
    extra = {"kind": "estimator", "estimator": _pack_estimator(est, arrays),
             "config": config or {}}
    CheckpointManager(directory, keep=1, async_save=False).save_named(
        _STEP, arrays, extra=extra)


def load_estimator(directory: str, *, expect_config: dict | None = None,
                   device: str | torch.device = "cuda") -> Estimator | None:
    """The snapshotted estimator on ``device``, or ``None`` (absent, or a
    config echo that differs from ``expect_config``)."""
    dev = resolve_device(device)
    mgr = CheckpointManager(directory, keep=1, async_save=False)
    if mgr.latest_step() is None:
        return None
    arrays, extra = mgr.restore_named(_STEP)
    if extra.get("kind") != "estimator":
        return None
    if expect_config is not None and extra.get("config") != expect_config:
        return None
    return _unpack_estimator(arrays, extra["estimator"], dev)
