"""The comparison that decides ``correct``, and the recall arithmetic.

Numbers compared (each against its limit in ``bench/checks/<cell>.json``):

* ``bad``: served answers, over every query the window served, that break
  their form: an id outside the corpus, an id twice in one answer, a
  distance that is not finite or not ascending.  Limit 0.
* ``unserved``: requests due in the window that never got their answer
  (shed, failed, or still queued after the close).  Limit 0.
* ``gap``: over a sample of served queries, the widest relative gap by
  which a served neighbour's exact distance lies beyond the exact k-th
  nearest distance: ``max (d(q, id) - d_k(q)) / d_k(q)``.
* ``dist_err``: over the same sample, the widest gap between a served
  distance and the exact distance of the id it came with, relative to the
  exact k-th distance.

Exact distances come from ``bench.reference``.  This module imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np

BIG = 1e30  # a non-finite reading, printed as a number


def form_faults(ids: np.ndarray, dists: np.ndarray, rows: int) -> int:
    """Answers (rows of ``ids`` / ``dists``, (Q, k)) that break their form."""
    if ids.size == 0:
        return 0
    bad = ((ids < 0) | (ids >= rows)).any(1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    bad |= ~np.isfinite(dists).all(1)
    with np.errstate(invalid="ignore"):
        bad |= (np.diff(dists, axis=1) < 0).any(1)
    return int(bad.sum())


def recall(served_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean over queries of |served ∩ exact| / k."""
    k = exact_ids.shape[1]
    hits = [len(np.intersect1d(a, b, assume_unique=False)) for a, b in zip(served_ids, exact_ids)]
    return float(np.mean(hits)) / k if hits else 0.0


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else BIG


def gaps(served_d: np.ndarray, own_d: np.ndarray, exact_d: np.ndarray) -> dict:
    """``gap`` and ``dist_err`` of a sample: served distances (S, k), the
    exact distances of the served ids (S, k) and the exact k nearest (S, k)."""
    if served_d.size == 0:
        return {"gap": BIG, "dist_err": BIG}
    dk = exact_d[:, -1:]
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.max((own_d - dk) / dk)
        err = np.max(np.abs(served_d.astype(np.float64) - own_d) / dk)
    return {"gap": _finite(gap), "dist_err": _finite(err)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
