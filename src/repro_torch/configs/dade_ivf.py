"""The paper's own serving workload: a DADE-screened IVF/flat vector search
service (the port's copy of ``repro.configs.dade_ivf``; one card holds
``corpus_per_device`` rows)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    arch_id: str = "dade-ivf"
    corpus_per_device: int = 1 << 20   # 1M vectors per card
    dim: int = 256                     # DEEP dimensionality (paper Table 1)
    query_batch: int = 1024            # queries per search step
    k: int = 100
    delta_d: int = 64                  # kernel block width = Δd (4 checkpoints)
    wave: int = 8192
    p_s: float = 0.02                  # serving significance level
    dtype: str = "bfloat16"            # corpus rows stream as bf16
    quant: str = "int8"                # int8 per-block codes for stage 1
    refine_per_wave: int = 0           # unused by the fused route


CONFIG = ServiceConfig()


def reduced() -> ServiceConfig:
    return dataclasses.replace(
        CONFIG, corpus_per_device=4096, query_batch=16, k=10, wave=1024,
        delta_d=32)
