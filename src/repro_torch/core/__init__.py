"""DADE core (the port of ``repro.core``): the reference's package-level names.

  transforms   — PCA (data-aware) / random orthogonal / identity.
  calibration  — empirical eps_d tables (hypothesis testing).
  estimators   — FDScanning / ADSampling / DADE bundles.
  dco          — batched block-incremental DCO screen.
  dco_host     — numpy compaction engine for host wall-clock QPS.
  topk         — wave-synchronous K-NN refinement.
"""

from __future__ import annotations

_EXPORTS = {
    "EpsilonTable": "repro_torch.core.calibration",
    "adsampling_table": "repro_torch.core.calibration",
    "calibrate": "repro_torch.core.calibration",
    "expansion_schedule": "repro_torch.core.calibration",
    "DCOResult": "repro_torch.core.dco",
    "dco_screen": "repro_torch.core.dco",
    "dco_screen_batch": "repro_torch.core.dco",
    "Estimator": "repro_torch.core.estimators",
    "build_estimator": "repro_torch.core.estimators",
    "KnnResult": "repro_torch.core.topk",
    "exact_knn": "repro_torch.core.topk",
    "knn_search_waves": "repro_torch.core.topk",
    "merge_topk": "repro_torch.core.topk",
    "OrthogonalTransform": "repro_torch.core.transforms",
    "fit_pca": "repro_torch.core.transforms",
    "fit_random_orthogonal": "repro_torch.core.transforms",
    "identity_transform": "repro_torch.core.transforms",
    "random_orthogonal": "repro_torch.core.transforms",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    # Imported on first use: the submodules import one another across
    # packages, so nothing is imported when the package is.
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
