"""Config registry: one module per assigned architecture (+ the paper's own
DADE service config), the port's copy of ``repro.configs``."""
from __future__ import annotations

from repro_torch.configs import (
    codeqwen1p5_7b, dade_ivf, deepseek_coder_33b, gemma2_9b, gemma_2b,
    llama3p2_vision_11b, mamba2_130m, mixtral_8x7b, qwen2_moe_a2p7b,
    whisper_small, zamba2_1p2b,
)

__all__ = ["LM_ARCHS", "get_config", "reduced_config", "list_archs"]

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "whisper-small": whisper_small,
    "zamba2-1.2b": zamba2_1p2b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "codeqwen1.5-7b": codeqwen1p5_7b,
    "gemma-2b": gemma_2b,
    "gemma2-9b": gemma2_9b,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b,
    "llama-3.2-vision-11b": llama3p2_vision_11b,
    "dade-ivf": dade_ivf,
}

LM_ARCHS = [a for a in _MODULES if a != "dade-ivf"]


def get_config(arch_id: str):
    return _MODULES[arch_id].CONFIG


def reduced_config(arch_id: str):
    return _MODULES[arch_id].reduced()


def list_archs() -> list[str]:
    return list(_MODULES)
