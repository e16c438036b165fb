"""The plain reference: exact k-nearest-neighbour search by squared L2 over
the raw float32 vectors, in plain PyTorch, and the same search computed in
int8 (the control).

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the raw corpus (drawn again from the seed by
``bench.data``) and the raw queries that were served.  Float32 products
run with TF32 off; every distance it reports is recomputed by differences
in float64, so the expansion's cancellation does not reach the answer.
"""

from __future__ import annotations

import contextlib

import torch

EXTRA = 32  # candidates kept beyond k before the exact recompute
ROW_BLOCK = 1 << 17
QUERY_BLOCK = 256


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _sq_expansion(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)


def _candidates(rows, queries, keep, *, dequant=None):
    """(S, keep) ids of the smallest expansion distances, block by block."""
    best_d = best_i = None
    for s in range(0, rows.shape[0], ROW_BLOCK):
        x = rows[s:s + ROW_BLOCK]
        x = x.float() if dequant is None else dequant(x)
        d = _sq_expansion(queries, x)
        v, i = torch.topk(d, min(keep, x.shape[0]), dim=1, largest=False)
        i = i + s
        if best_d is not None:
            v, i = torch.cat([best_d, v], 1), torch.cat([best_i, i], 1)
            v, o = torch.topk(v, min(keep, v.shape[1]), dim=1, largest=False)
            i = torch.gather(i, 1, o)
        best_d, best_i = v, i
    return best_d, best_i


def distances(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(S, k) float64 exact distances of ``queries`` (S, D) to the rows
    ``ids`` (S, k); an id outside the corpus reads +inf."""
    n = rows.shape[0]
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    out = torch.empty(ids.shape, dtype=torch.float64, device=rows.device)
    for s in range(0, ids.shape[0], QUERY_BLOCK):
        x = rows[safe[s:s + QUERY_BLOCK]].double()
        q = queries[s:s + QUERY_BLOCK].double()
        out[s:s + QUERY_BLOCK] = torch.sqrt(((x - q[:, None, :]) ** 2).sum(-1))
    return torch.where(valid, out, torch.full_like(out, float("inf")))


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int):
    """(dists (S, k) float64 ascending, ids (S, k) int64): the exact k
    nearest rows of each query."""
    q = queries.to(rows.device, torch.float32)
    with _no_tf32():
        _, cand = _candidates(rows, q, k + EXTRA)
    d = distances(rows, q, cand)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(cand, 1, order)[:, :k]


class Int8Search:
    """The control: the reference's search with every vector held in int8,
    in the configuration's code format (one symmetric scale per block of
    ``block_d`` dims over the PCA-rotated corpus; the rotation fitted here
    on the first ``fit_rows`` rows).  Called as the program's step is:
    (B, D) raw float32 queries on the host -> (dists, ids) on the host."""

    def __init__(self, rows: torch.Tensor, *, block_d: int, k: int, fit_rows: int = 50000):
        self.k = k
        x = rows[:fit_rows].double()
        vals, vecs = torch.linalg.eigh(x.T @ x / x.shape[0])
        self.basis = vecs[:, torch.argsort(vals, descending=True)].float().contiguous()
        dim = rows.shape[1]
        nb = -(-dim // block_d)
        self.pad = nb * block_d - dim
        maxabs = torch.zeros(nb, device=rows.device)
        with _no_tf32():
            for s in range(0, rows.shape[0], ROW_BLOCK):
                r = self._rot(rows[s:s + ROW_BLOCK]).reshape(-1, nb, block_d)
                maxabs = torch.maximum(maxabs, r.abs().amax(dim=(0, 2)))
            self.scale = torch.repeat_interleave(torch.where(maxabs > 0, maxabs / 127.0,
                                                             torch.ones_like(maxabs)), block_d)
            self.codes = torch.empty((rows.shape[0], nb * block_d), dtype=torch.int8,
                                     device=rows.device)
            for s in range(0, rows.shape[0], ROW_BLOCK):
                self.codes[s:s + ROW_BLOCK] = self._code(self._rot(rows[s:s + ROW_BLOCK]))

    def _rot(self, x):
        return torch.nn.functional.pad(x.float() @ self.basis, (0, self.pad))

    def _code(self, x):
        return torch.clamp(torch.round(x / self.scale), -127, 127).to(torch.int8)

    def __call__(self, batch):
        q = torch.as_tensor(batch, device=self.codes.device)
        with _no_tf32():
            qd = self._code(self._rot(q)).float() * self.scale
            dq = lambda c: c.float() * self.scale  # noqa: E731
            _, cand = _candidates(self.codes, qd, self.k + EXTRA, dequant=dq)
            x = dq(self.codes[cand.reshape(-1)]).reshape(*cand.shape, -1)
            d = ((x - qd[:, None, :]) ** 2).sum(-1)
            d, order = torch.sort(d, dim=1, stable=True)
            ids = torch.gather(cand, 1, order)[:, :self.k]
            d = torch.sqrt(d[:, :self.k])
        return d.cpu().numpy(), ids.to(torch.int32).cpu().numpy()
