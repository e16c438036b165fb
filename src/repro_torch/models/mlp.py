"""Feed-forward blocks: gated (SiLU/GeGLU) and plain (whisper GELU).

Over the model axis (``distributed.sharding.use_rules`` over a live mesh)
a rank holds the ``ffn`` columns of ``w_gate`` / ``w_up`` (and ``b_up``)
and the rows of ``w_down``: its input is gathered along the sequence, its
product with ``w_down`` is a partial sum, reduce-scattered onto the
residual's pieces, and ``b_down`` is added once, after the sum."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
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


def mlp_fwd(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
            act: int | None = None) -> torch.Tensor:
    """x: (B, S, D), this rank's piece (split along ``act`` over the model
    axis, or whole) -> y placed as the residual (``act_seq``)."""
    x = constrain(x, "batch", "seq", "embed", src=act)
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(cfg, x @ p["w_up"] + p["b_up"])
    y = constrain(h @ p["w_down"], "batch", "act_seq", "embed",
                  partial=p.split("w_down") is not None)
    if "b_down" in p:
        y = y + p["b_down"]
    return y
