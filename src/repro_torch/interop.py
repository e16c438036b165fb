"""Carry state built by the reference package into the port.

Every function takes the reference's state as numpy arrays (callers apply
``np.asarray`` to the reference's objects) and returns the port's objects
on the requested device, so search parity can run on reference-built
artifacts: the reference's builds draw from random streams the port cannot
replay.  Nothing here imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.estimators import Estimator
from repro_torch.core.transforms import OrthogonalTransform
from repro_torch.index.ivf import IVFIndex
from repro_torch.quant.scalar import QuantConfig

__all__ = ["transform_from_arrays", "table_from_arrays", "estimator_from_arrays",
           "ivf_from_arrays"]


def _t(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def transform_from_arrays(basis, variances, cum_variances, *,
                          device="cuda") -> OrthogonalTransform:
    dev = resolve_device(device)
    return OrthogonalTransform(basis=_t(basis, dev, torch.float32),
                               variances=_t(variances, dev, torch.float32),
                               cum_variances=_t(cum_variances, dev, torch.float32))


def table_from_arrays(dims, eps, scale, eps_lo, *, device="cuda") -> EpsilonTable:
    dev = resolve_device(device)
    return EpsilonTable(dims=_t(dims, dev, torch.int32), eps=_t(eps, dev, torch.float32),
                        scale=_t(scale, dev, torch.float32),
                        eps_lo=_t(eps_lo, dev, torch.float32))


def estimator_from_arrays(method: str, transform: dict, table: dict, *,
                          quant: bool = False, device="cuda") -> Estimator:
    """``transform``: basis/variances/cum_variances arrays; ``table``:
    dims/eps/scale/eps_lo arrays."""
    return Estimator(method=method,
                     transform=transform_from_arrays(**transform, device=device),
                     table=table_from_arrays(**table, device=device),
                     quant=QuantConfig() if quant else None)


def ivf_from_arrays(estimator: Estimator, *, centroids, bucket_sizes, starts,
                    flat_rot, flat_codes, flat_ids, bscales, qbuckets, qscales,
                    max_bucket: int, scan_block_d: int, device="cuda") -> IVFIndex:
    """The reference's fused-layout ``IVFIndex`` arrays as the port's index.

    ``qbuckets`` (Nc, cap, D) — the reference's per-dimension codes in its
    padded bucket layout — are laid into the flat layout (row
    ``starts[c] + j`` holds bucket c's j-th code row), where the port's
    threshold seed reads them.
    """
    dev = resolve_device(device)
    sizes = np.asarray(bucket_sizes, np.int64)
    st = np.asarray(starts, np.int64)
    qb = np.asarray(qbuckets)
    seed_codes = np.zeros((np.asarray(flat_rot).shape[0], qb.shape[2]), np.int8)
    for c, size in enumerate(sizes):
        seed_codes[st[c]: st[c] + size] = qb[c, :size]
    return IVFIndex(
        estimator=estimator, centroids=_t(centroids, dev, torch.float32),
        bucket_sizes=_t(sizes, dev, torch.int32), starts=_t(st, dev, torch.int32),
        flat_rot=_t(flat_rot, dev, torch.float32),
        flat_codes=_t(flat_codes, dev, torch.int8),
        flat_ids=_t(flat_ids, dev, torch.int32), bscales=_t(bscales, dev, torch.float32),
        seed_codes=_t(seed_codes, dev, torch.int8),
        qscales=_t(qscales, dev, torch.float32),
        max_bucket=int(max_bucket), scan_block_d=int(scan_block_d))
