"""Hand-written Hopper kernels for the DCO hot spot and their wrappers (the
port of ``repro.kernels``): the reference's package-level names, less
``min_block_q`` and ``on_tpu`` (TPU tile floors).

ops.py — the public wrappers (padding, and the plain version on CPU
tensors); ref.py — the plain PyTorch oracles.  Importing the package (or a
name of it) builds and loads no kernel: each is built at its first launch.
"""

from __future__ import annotations

_EXPORTS = {
    "EPS_DISABLED": "repro_torch.core.estimators",
    "EstimatorSpec": "repro_torch.core.estimators",
    "UnsupportedMethodError": "repro_torch.core.estimators",
    "kernel_spec": "repro_torch.core.estimators",
    "block_table": "repro_torch.kernels.ops",
    "dco_screen_kernel": "repro_torch.kernels.ops",
    "fused_fetch_totals": "repro_torch.kernels.ops",
    "ivf_scan_kernel": "repro_torch.kernels.ops",
    "graph_scan_kernel": "repro_torch.kernels.ops",
    "graph_vis_words": "repro_torch.kernels.ops",
    "unpack_vis": "repro_torch.kernels.ops",
    "quant_screen_kernel": "repro_torch.kernels.ops",
    "dade_dco_ref": "repro_torch.kernels.ref",
    "ivf_scan_ref": "repro_torch.kernels.ref",
    "graph_scan_ref": "repro_torch.kernels.ref",
    "quant_dco_ref": "repro_torch.kernels.ref",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    # Imported on first use: the submodules import one another across
    # packages, so nothing is imported when the package is.
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
