"""Quantized two-stage DCO subsystem (the port of ``repro.quant``): the
reference's package-level names.

scalar — symmetric int8 encoding of the rotated corpus with exact
  reconstruction / partial-distance bounds; screen — the two-stage screen
  (int8 lower-bound prefilter feeding the fp32 DADE screen); accounting —
  the byte accounting shared by the host engines and the fused-scan stats.
"""

from __future__ import annotations

_EXPORTS = {
    "QuantConfig": "repro_torch.quant.scalar",
    "QuantizedCorpus": "repro_torch.quant.scalar",
    "block_err_cum": "repro_torch.quant.scalar",
    "cum_err_sq": "repro_torch.quant.scalar",
    "fit_block_scales": "repro_torch.quant.scalar",
    "quantize_block": "repro_torch.quant.scalar",
    "quantize_queries_block": "repro_torch.quant.scalar",
    "dequantize": "repro_torch.quant.scalar",
    "fit_scales": "repro_torch.quant.scalar",
    "lower_bound_sq": "repro_torch.quant.scalar",
    "quantize": "repro_torch.quant.scalar",
    "quantize_corpus": "repro_torch.quant.scalar",
    "upper_bound_sq": "repro_torch.quant.scalar",
    "QuantScreenResult": "repro_torch.quant.screen",
    "Stage1Result": "repro_torch.quant.screen",
    "bytes_scanned": "repro_torch.quant.screen",
    "knn_search_quant_host": "repro_torch.quant.screen",
    "knn_search_waves_quant": "repro_torch.quant.screen",
    "quant_lb_screen": "repro_torch.quant.screen",
    "two_stage_screen": "repro_torch.quant.screen",
    "two_stage_screen_host": "repro_torch.quant.screen",
    "two_stage_bytes": "repro_torch.quant.accounting",
    "fetched_tile_bytes": "repro_torch.quant.accounting",
    "stage2_skip_rate": "repro_torch.quant.accounting",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    # Imported on first use: the submodules import one another across
    # packages, so nothing is imported when the package is.
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
