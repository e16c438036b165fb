"""Checkpoint manager (port of ``repro.checkpoint.manager``), in the
reference's on-disk layout, so a snapshot written by either package loads
in the other.

Layout per step::

    <dir>/step_000000123.tmp/         (written, fsync'd)
        tree.json                     (paths + leaf shape/dtype/sha256)
        leaf_00000.npy ...            (one file per leaf, on the host)
    <dir>/step_000000123/             (atomic rename: the commit)

  * atomic commit (rename): a dying writer never corrupts the latest step;
  * optional asynchronous save: a background thread writes while the
    caller goes on (the leaves are copied to the host before the hand-off);
  * a sha256 digest per leaf, checked on restore;
  * retention (keep the last N), and a sweep of torn step directories.

Trees are nested dicts (keys in sorted order), lists and tuples of tensors
or arrays, flattened in the reference's order with its path strings
(``['key']``, ``[0]``).  A bfloat16 leaf is stored as the reference stores
one: its raw bits as a 2-byte void array under a ``<V2`` header,
``"dtype": "bfloat16"`` in ``tree.json`` (numpy has no bfloat16; the bits
move through ``int16`` views, so no extension package is needed).

Over a rank mesh a tree's leaves are the rank's pieces, placed by a
parallel tree of ``distributed.sharding.Sharding`` (``shardings=``):
``save`` gathers each full leaf on every rank and rank 0 alone writes it,
in the layout above, so a checkpoint written by N ranks loads in one
process, on M ranks, and in the reference's manager; ``restore`` gives
each rank the piece its sharding names (elastic restore onto another
mesh).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "to_host"]


_BF16_BITS = np.dtype("V2")  # a bfloat16 leaf's raw bits, the reference's layout


def to_host(x) -> np.ndarray:
    """A leaf as a numpy array on the host; a tensor is always copied (an
    asynchronous save must not see later in-place updates), a bfloat16 one
    as its raw bits (a ``|V2`` array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)


def _save_leaf(f, arr: np.ndarray) -> None:
    """``np.save``, but bfloat16 bits under the reference's ``<V2`` header
    (the descriptor numpy writes for an extension bfloat16 dtype)."""
    if arr.dtype != _BF16_BITS:
        np.save(f, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    np.lib.format.write_array_header_1_0(f, header)
    f.write(np.ascontiguousarray(arr).tobytes())


def _to_tensor(arr: np.ndarray, device=None) -> torch.Tensor:
    """A loaded leaf as a tensor on ``device``; ``|V2`` bits as bfloat16."""
    if arr.dtype == _BF16_BITS:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def _flatten(tree, path=()):
    """(leaves, paths) of a nested dict/list/tuple in the reference's order:
    dict keys sorted, ``None`` an empty subtree."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [tree], ["/".join(path)]
    leaves, paths = [], []
    for key, sub in items:
        lv, ps = _flatten(sub, path + (key,))
        leaves += lv
        paths += ps
    return leaves, paths


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    return leaves.pop(0)


def _load_leaf(path: str, i: int, meta: dict, where: str, verify: bool) -> np.ndarray:
    arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
    if verify and hashlib.sha256(arr.tobytes()).hexdigest() != meta["leaves"][i]["sha256"]:
        raise IOError(f"checkpoint leaf {i} ({where}): digest mismatch "
                      f"(corrupt checkpoint)")
    return arr


def _placements_of(shardings, n: int) -> list:
    """The leaves of a ``Sharding`` tree, which must place ``n`` leaves."""
    placed, _ = _flatten(shardings)
    if len(placed) != n:
        raise ValueError(f"shardings place {len(placed)} leaves, the tree has {n}")
    return placed


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._errors: list[Exception] = []
        if async_save:
            self._q = queue.Queue(maxsize=2)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ---- save ------------------------------------------------------------

    def save(self, step: int, tree: Any, *, shardings: Any = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` (copied to the host now) and write it, on the
        background thread unless ``blocking``.  With ``shardings`` (a tree
        of ``Sharding`` parallel to ``tree``, over a rank mesh), every rank
        of the default group calls this: each full leaf is gathered from the
        ranks' pieces, and rank 0 alone writes."""
        leaves, paths = _flatten(tree)
        if shardings is not None:
            import torch.distributed as dist

            from repro_torch.distributed.collectives import gather_sharded_many

            placed = _placements_of(shardings, len(leaves))
            for mesh in {id(sh.mesh): sh.mesh for sh in placed}.values():
                at = [i for i, sh in enumerate(placed) if sh.mesh is mesh]
                full = gather_sharded_many([leaves[i] for i in at],
                                           [placed[i].spec for i in at], mesh)
                for i, x in zip(at, full):
                    leaves[i] = x
            if dist.get_rank() != 0:
                return
        host = [to_host(x) for x in leaves]
        if self._q is None or blocking:
            self._write(step, host, paths)
        else:
            self._q.put((step, host, paths))

    def wait(self) -> None:
        if self._q is not None:
            self._q.join()
        if self._errors:
            raise self._errors[0]

    def _drain(self) -> None:
        while True:
            step, leaves, paths = self._q.get()
            try:
                self._write(step, leaves, paths)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves: list, paths: list,
               extra: dict | None = None) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "paths": paths, "leaves": []}
        if extra:
            meta["extra"] = extra
        for i, leaf in enumerate(leaves):
            arr = np.asarray(leaf)
            with open(os.path.join(tmp, f"leaf_{i:05d}.npy"), "wb") as f:
                _save_leaf(f, arr)
                f.flush()
                os.fsync(f.fileno())
            meta["leaves"].append({
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            })
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        # A committed step always holds tree.json (the rename follows its
        # fsync), so a step directory without one is debris of an
        # interrupted GC: never a restore target, reclaimed here.
        for fn in os.listdir(self.dir):
            if re.fullmatch(r"step_(\d+)", fn) and not os.path.exists(
                    os.path.join(self.dir, fn, "tree.json")):
                shutil.rmtree(os.path.join(self.dir, fn), ignore_errors=True)

    # ---- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", fn)
            if m and os.path.exists(os.path.join(self.dir, fn, "tree.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, shardings: Any | None = None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like``: each leaf a tensor on the
        device of ``like``'s leaf there (the CPU for an array).  With
        ``shardings`` (a tree of ``Sharding`` parallel to ``like``, over this
        rank's mesh), each leaf is this rank's piece of the stored one;
        ``like``'s leaf then has the piece's shape or the full one."""
        from repro_torch.distributed.sharding import local_shape, local_slice

        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "tree.json")) as f:
            meta = json.load(f)
        like_leaves, _ = _flatten(like)
        if len(like_leaves) != len(meta["leaves"]):
            raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                             f"template has {len(like_leaves)}")
        paths = meta.get("paths", [])
        placed = (_placements_of(shardings, len(like_leaves)) if shardings is not None
                  else [None] * len(like_leaves))
        out = []
        for i, (tmpl, sh) in enumerate(zip(like_leaves, placed)):
            where = paths[i] if i < len(paths) else str(i)
            arr = _load_leaf(path, i, meta, where, verify)
            fits = [tuple(arr.shape)]
            if sh is not None:
                fits.append(local_shape(arr.shape, sh.spec, sh.mesh))
            if tuple(np.shape(tmpl)) not in fits:
                raise ValueError(
                    f"leaf {i}: ckpt shape {arr.shape} != template {np.shape(tmpl)}")
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else None
            if sh is None:
                out.append(_to_tensor(arr, dev))
            else:
                piece = local_slice(_to_tensor(arr), sh.spec, sh.mesh)
                out.append(piece.to(dev, copy=True).contiguous())
        return _unflatten(like, out)

    # ---- named artifacts (template-free restore) -------------------------

    def save_named(self, step: int, arrays: dict[str, Any], *,
                   extra: dict | None = None) -> None:
        """Save a flat ``{name: array}`` dict, synchronously.  The names
        travel in the step's metadata (sorted, the flattening order), so
        :meth:`restore_named` needs no template; ``extra`` carries small
        JSON config beside them."""
        names = sorted(arrays)
        meta = dict(extra or {})
        meta["names"] = names
        self._write(step, [to_host(arrays[k]) for k in names],
                    [f"[{k!r}]" for k in names], extra=meta)

    def restore_named(self, step: int, *, verify: bool = True,
                      only=None) -> tuple[dict[str, np.ndarray], dict]:
        """Load a :meth:`save_named` step -> ``(arrays, extra)``, numpy on
        the host (``only``: just those names).  A digest mismatch raises
        ``IOError`` naming the leaf."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "tree.json")) as f:
            meta = json.load(f)
        extra = dict(meta.get("extra", {}))
        names = extra.pop("names", None)
        if names is None or len(names) != len(meta["leaves"]):
            raise ValueError(f"step {step} was not written by save_named "
                             f"(names metadata missing or inconsistent)")
        return ({name: _load_leaf(path, i, meta, name, verify)
                 for i, name in enumerate(names) if only is None or name in only}, extra)
