"""Deterministic synthetic vector data (numpy, seed-exact copies of
``repro.data.pipeline.synthetic_vectors`` / ``synthetic_queries`` /
``drifted_vectors``).

Anisotropic Gaussian-mixture corpora — the spectrum decay mirrors real
embedding sets (DEEP/GIST), which is the regime where DADE's PCA rotation
pays off.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_vectors", "synthetic_queries", "drifted_vectors"]


def synthetic_vectors(
    n: int, dim: int, *, seed: int = 0, n_modes: int = 16, decay: float = 0.05
) -> np.ndarray:
    """Gaussian mixture with exponentially decaying per-dim scales."""
    rng = np.random.default_rng(seed)
    scales = np.exp(-decay * np.arange(dim)).astype(np.float32)
    centers = rng.standard_normal((n_modes, dim)).astype(np.float32) * scales * 2
    mode = rng.integers(0, n_modes, n)
    x = rng.standard_normal((n, dim)).astype(np.float32) * scales
    # rotate so the informative directions are NOT axis-aligned (otherwise
    # identity == PCA and the data-aware claim is untestable)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (x + centers[mode]) @ q.astype(np.float32)


def synthetic_queries(n: int, dim: int, corpus: np.ndarray, *, seed: int = 1) -> np.ndarray:
    """Queries near corpus points (realistic ANN workload)."""
    rng = np.random.default_rng(seed)
    base = corpus[rng.integers(0, len(corpus), n)]
    jitter = rng.standard_normal((n, dim)).astype(np.float32)
    jitter *= 0.1 * np.std(corpus, axis=0, keepdims=True)
    return base + jitter


def drifted_vectors(transform, n: int, *, extra_decay: float = 0.08,
                    seed: int = 11) -> np.ndarray:
    """Distribution-drift stimulus of the churn drills: vectors whose energy
    profile in the fitted basis decays ``extra_decay`` faster than the
    corpus ``transform`` was fitted on (per-component scales
    ``sqrt(variances_d) * exp(-extra_decay * d)``, rotated back through the
    basis).  Under the stale epsilon table their partial estimates
    overshoot the calibrated profile, so the DADE screen over-prunes — what
    the drift watchdog detects and its recalibration repairs.  The basis
    and variances may be tensors on any device or numpy arrays."""
    rng = np.random.default_rng(seed)
    basis = _host(transform.basis)
    var = _host(transform.variances)
    dim = basis.shape[0]
    prof = np.sqrt(np.maximum(var, 0.0)) * np.exp(
        -extra_decay * np.arange(dim)).astype(np.float32)
    rot = rng.standard_normal((n, dim)).astype(np.float32) * prof
    return (rot @ basis.T).astype(np.float32)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
