"""Feed-forward blocks: gated (SiLU/GeGLU) and plain (whisper GELU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, Initializer, Params

__all__ = ["init_mlp", "mlp_fwd"]


def init_mlp(init: Initializer, cfg: ArchConfig, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.activation in ("silu", "geglu"):
        return Params(w_gate=init.dense((d, f), ("embed_fsdp", "ffn")),
                      w_up=init.dense((d, f), ("embed_fsdp", "ffn")),
                      w_down=init.dense((f, d), ("ffn", "embed_fsdp")))
    return Params(  # plain 2-layer (gelu)
        w_up=init.dense((d, f), ("embed_fsdp", "ffn")), b_up=init.zeros((f,), ("ffn",)),
        w_down=init.dense((f, d), ("ffn", "embed_fsdp")),
        b_down=init.zeros((d,), ("embed",)))


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # geglu and gelu alike


def mlp_fwd(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"] + p["b_up"])
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y
