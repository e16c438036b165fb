"""Orthogonal transforms used by DCO estimators (port of
``repro.core.transforms``).

DADE derives ``W_D`` from the data second-moment matrix ``E[X X^T]`` (PCA,
Lemma 4); ADSampling uses a random orthogonal matrix (data-oblivious).
Both store the rotated corpus once; queries are rotated at query time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["OrthogonalTransform", "fit_pca", "fit_random_orthogonal",
           "identity_transform", "as_tensor", "orthogonality_error"]


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (numpy or tensor) as a contiguous tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class OrthogonalTransform:
    """An orthogonal basis of R^D plus per-direction variances.

    Attributes:
      basis: (D, D) float32; column k is direction w_k.
      variances: (D,) Var(w_k^T X) under the fitted data (descending for PCA).
      cum_variances: (D,) inclusive cumulative sum sigma^2(1, d).
    """

    basis: torch.Tensor
    variances: torch.Tensor
    cum_variances: torch.Tensor

    @property
    def dim(self) -> int:
        return self.basis.shape[0]

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate vectors: x (..., D) -> W^T x (..., D)."""
        return x @ self.basis

    def apply_rows(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`apply` with each row's result independent of the batch:
        x (N, D) @ basis, each output element summed over d = 0, 1, ... in
        that order with one rounded multiply and one rounded add per term.

        A matmul's summation order depends on its shape: on the CPU a
        one-row product (a gemv) rounds differently from the same row
        inside a batch, and cuBLAS picks its kernel by shape too.  Corpus
        rows that must equal their rotation inside any other batch — a
        mutable index's upsert against the rebuild of the whole corpus —
        rotate here: elementwise operations only, so a row's result depends
        on that row alone, and is the same on the CPU and on the card.
        2·D launches per call, whatever N."""
        basis = self.basis
        x = x.float()
        acc = x[:, 0:1] * basis[0]
        term = torch.empty_like(acc)
        for d in range(1, basis.shape[0]):
            torch.mul(x[:, d:d + 1], basis[d], out=term)
            acc.add_(term)
        return acc

    def scale(self, d) -> torch.Tensor:
        """Unbiased estimation scale sigma^2(1,D)/sigma^2(1,d) (Eq. 13);
        ``d`` is a 1-indexed dimension count (int or integer tensor)."""
        d = torch.as_tensor(d, device=self.device, dtype=torch.long)
        return self.cum_variances[-1] / self.cum_variances[d - 1]


def _finalize(basis: torch.Tensor, data: torch.Tensor) -> OrthogonalTransform:
    proj = data @ basis  # (N, D)
    variances = torch.mean(proj * proj, dim=0)
    cum = torch.cumsum(variances, dim=0)
    # Strictly positive cumulative variance so scale() is finite.
    cum = torch.clamp_min(cum, torch.finfo(cum.dtype).tiny)
    return OrthogonalTransform(basis=basis, variances=variances,
                               cum_variances=cum)


def fit_pca(data, *, center: bool = False,
            device: str | torch.device = "cuda") -> OrthogonalTransform:
    """Fit the DADE transform: eigenbasis of E[X X^T], descending eigenvalue.

    The second moment and its eigendecomposition run in float64 on
    ``device`` (one (D, D) solve); the basis is stored in float32.
    """
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    if center:
        x = x - torch.mean(x, dim=0, keepdim=True)
    x64 = x.to(torch.float64)
    second_moment = (x64.T @ x64) / x64.shape[0]
    eigvals, eigvecs = torch.linalg.eigh(second_moment)  # ascending
    order = torch.argsort(eigvals, descending=True)
    basis = eigvecs[:, order].to(torch.float32).contiguous()
    return _finalize(basis, x)


def random_orthogonal(generator: torch.Generator, dim: int,
                      device: torch.device) -> torch.Tensor:
    """Haar random orthogonal matrix via QR of a Gaussian (ADSampling)."""
    g = torch.randn((dim, dim), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(device=device, dtype=torch.float32).contiguous()


def fit_random_orthogonal(data, generator: torch.Generator, *,
                          device: str | torch.device = "cuda") -> OrthogonalTransform:
    """ADSampling's transform with empirical per-direction variances, so the
    same scale tables and calibration apply.  ``generator`` is a CPU
    ``torch.Generator``."""
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    return _finalize(random_orthogonal(generator, x.shape[1], dev), x)


def identity_transform(data, *, device: str | torch.device = "cuda") -> OrthogonalTransform:
    """No rotation (FDScanning operates in the original space)."""
    dev = resolve_device(device)
    x = as_tensor(data, dev)
    return _finalize(torch.eye(x.shape[1], dtype=torch.float32, device=dev), x)


def orthogonality_error(t: OrthogonalTransform) -> float:
    """max |W^T W - I|, a sanity metric of the tests and benchmarks."""
    w = t.basis
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return float(torch.max(torch.abs(w.T @ w - eye)))
