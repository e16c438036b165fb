"""Deterministic synthetic data pipelines (numpy).

Vector data: seed-exact copies of ``repro.data.pipeline.synthetic_vectors``
/ ``synthetic_queries`` / ``drifted_vectors``; anisotropic Gaussian-mixture
corpora — the spectrum decay mirrors real embedding sets (DEEP/GIST), which
is the regime where DADE's PCA rotation pays off.

Token data: :class:`TokenPipeline`, the reference's distribution (a
Zipf-ish unigram stream with short-range repeats) drawn from numpy's
generator instead of ``jax.random``, whose streams cannot be replayed
outside JAX; parity tests feed the reference's batches as arrays.  A
data-parallel trainer's ranks all read the same global ``batch_at(step)``
and each takes its rows of every microbatch (:func:`microbatch_rows`), as
the reference's sharded batch splits: ``host`` names another dataset, not
a rank's part of this one.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "microbatch_rows", "synthetic_vectors", "synthetic_queries",
           "drifted_vectors"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Token batches, fully deterministic in (seed, step, host): a restarted
    job resumes on the exact batch it crashed on (the checkpoint stores
    only the step)."""

    vocab_size: int
    batch: int  # per-host batch
    seq: int
    seed: int = 0

    def batch_at(self, step: int, host: int = 0) -> dict[str, np.ndarray]:
        """``tokens`` and ``labels`` (batch, seq) int32 for (step, host):
        stateless, resumable; ``labels`` are ``tokens`` shifted by one."""
        rng = np.random.default_rng((self.seed, step, host))
        shape = (self.batch, self.seq + 1)
        # Zipf unigram via exponential quantization of a uniform.
        u = rng.uniform(1e-6, 1.0, shape).astype(np.float32)
        ranks = np.floor(np.exp(u * np.float32(np.log(self.vocab_size)))).astype(np.int32)
        toks = np.clip(ranks - 1, 0, self.vocab_size - 1)
        # short-range structure: each token repeats the previous with p=0.3
        rep = rng.random(shape) < 0.3
        toks = np.where(rep, np.roll(toks, 1, axis=1), toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def microbatch_rows(batch: dict, ga: int, index: int = 0, size: int = 1) -> list[dict]:
    """The ``ga`` microbatches of a global batch (each leaf's rows in ``ga``
    contiguous runs, the reference's reshape to (ga, B / ga)), each cut to
    the ``index``-th of ``size`` contiguous parts of its rows: data rank
    ``index``'s share of every microbatch.  The rows must divide."""
    rows = next(iter(batch.values())).shape[0]
    if rows % (ga * size):
        raise ValueError(f"a batch of {rows} rows does not split into {ga} microbatches "
                         f"of {size} equal parts")
    mb, part = rows // ga, rows // (ga * size)
    return [{k: v[i * mb + index * part:i * mb + (index + 1) * part] for k, v in batch.items()}
            for i in range(ga)]


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


def synthetic_queries(n: int, dim: int, corpus: np.ndarray, *, seed: int = 1,
                      spread: np.ndarray | None = None) -> np.ndarray:
    """Queries near corpus points (realistic ANN workload).  ``spread`` is
    ``np.std(corpus, axis=0, keepdims=True)``, given by a caller that draws
    many batches from one large corpus (each call otherwise reads it all:
    about a second at 2^20 x 256)."""
    rng = np.random.default_rng(seed)
    base = corpus[rng.integers(0, len(corpus), n)]
    jitter = rng.standard_normal((n, dim)).astype(np.float32)
    jitter *= 0.1 * (np.std(corpus, axis=0, keepdims=True) if spread is None else spread)
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
