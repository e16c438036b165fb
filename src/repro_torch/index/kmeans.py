"""Lloyd k-means in PyTorch — the IVF coarse quantizer (port of
``repro.index.kmeans``).

k-means++ seeding on the full sample, a fixed iteration count, and
empty-cluster re-seeding to the farthest points.  The random draws come
from a CPU ``torch.Generator`` (the reference draws from ``jax.random``, so
the two builds agree in quality, not bit for bit).  Distances run in row
chunks, so the (N, k) matrix never exists whole.  Cluster sums are taken
in a fixed order on every device, so a build repeats bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.transforms import as_tensor

__all__ = ["kmeans", "assign"]


def assign(data: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 1 << 16):
    """(N,) nearest-centroid ids and (N,) squared distance to that centroid."""
    cn = torch.sum(centroids * centroids, dim=1)
    ids, dmin = [], []
    for lo in range(0, data.shape[0], chunk):
        x = data[lo:lo + chunk]
        d = torch.sum(x * x, dim=1, keepdim=True) + cn[None, :] - 2.0 * (x @ centroids.T)
        m, a = torch.min(d, dim=1)
        ids.append(a)
        dmin.append(m)
    return torch.cat(ids), torch.cat(dmin)


def _cluster_sums(x: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """(k, D) sums of the rows of each cluster, in row order.

    On CUDA ``index_add_`` sums with float atomics in no fixed order, so the
    centroids (and the buckets after them) would change in their last bits
    from run to run; ``index_put_(accumulate=True)`` sorts the rows by
    cluster and sums each cluster's rows in order there.  On the CPU
    ``index_add_`` already sums serially in row order.
    """
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return sums.index_add_(0, a, x)
    return sums.index_put_((a,), x, accumulate=True)


def _plus_plus_init(data: torch.Tensor, k: int, generator: torch.Generator):
    """k-means++ seeding; the running min distance is updated per new
    centroid instead of recomputing all (N, i) distances."""
    n = data.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64).to(data.device)
    first = torch.randint(0, n, (1,), generator=generator).to(data.device)
    xn = torch.sum(data * data, dim=1)
    cents = torch.empty((k, data.shape[1]), dtype=data.dtype, device=data.device)
    cents[0] = data[first[0]]
    dmin = torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)
    for i in range(1, k):
        c = cents[i - 1]
        d = torch.clamp_min(xn + torch.sum(c * c) - 2.0 * (data @ c), 0.0)
        dmin = torch.minimum(dmin, d)
        cdf = torch.cumsum(dmin.to(torch.float64), dim=0)
        total = torch.clamp_min(cdf[-1], 1e-30)
        nxt = torch.searchsorted(cdf, (u[i] * total).reshape(1), right=True)
        cents[i] = data[torch.clamp(nxt, max=n - 1)[0]]
    return cents


def kmeans(data, k: int, iters: int = 20, *,
           generator: torch.Generator | None = None,
           device: str | torch.device = "cuda"):
    """Returns (centroids (k, D), assignments (N,) int64)."""
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cents = _plus_plus_init(x, k, generator)
    for _ in range(iters):
        a, dmin = assign(x, cents)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        sums = _cluster_sums(x, a, k)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # Re-seed empties to the points farthest from their centroid.
        far = torch.argsort(dmin, descending=True)[:k]
        empty = counts == 0
        cents = torch.where(empty[:, None], x[far], new)
    return cents, assign(x, cents)[0]
