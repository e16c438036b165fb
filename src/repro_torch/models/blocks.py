"""Transformer/SSM blocks and layer stacks.

The port of ``repro.models.blocks``.  The reference stacks N identical
blocks along a leading 'layers' axis and scans them; here a stack is an
``nn.ModuleList`` of blocks in the reference's execution order, and
``init_stack`` returns one such list per position of the repeating block
pattern (gemma2: one list of 21 local layers, then one of 21 global
layers, run one list after the other as the reference runs its stacks).

Over the model axis the residual stream between the sublayers is this
rank's piece (``act``: the dimension split along the sequence, Megatron's
sequence parallelism, or None where the divisibility rule keeps it whole,
as in decode); norms act on the pieces and each sublayer returns its output
placed as the residual.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ArchConfig, DataShare, Initializer, Params, layernorm,
                                       rmsnorm, split_axes, split_of)

__all__ = ["init_block", "block_train", "block_decode", "init_stack"]


def _init_norm(init: Initializer, cfg: ArchConfig, d: int | None = None) -> Params:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return Params(w=init.ones((d,), ("embed",)), b=init.zeros((d,), ("embed",)))
    return Params(w=init.ones((d,), ("embed",)))


def _norm(p, x, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], 1e-5)
    return rmsnorm(x, p["w"], cfg.rms_eps)


def init_block(init: Initializer, cfg: ArchConfig, kind: str) -> Params:
    """kind: dense | moe | mamba | enc | dec | cross (the reference's
    parameter names and init order)."""
    if kind == "mamba":
        return Params(norm=_init_norm(init, cfg), ssm=ssm_mod.init_ssm(init, cfg))
    p: dict = {}
    if kind in ("dense", "moe", "enc", "dec"):
        p["ln_attn"] = _init_norm(init, cfg)
        p["attn"] = attn.init_attention(init, cfg)
        p["ln_mlp"] = _init_norm(init, cfg)
        if kind == "moe":
            p["moe"] = moe_mod.init_moe(init, cfg)
        else:
            p["mlp"] = mlp_mod.init_mlp(init, cfg)
        if cfg.post_block_norm:  # gemma2 sandwich
            p["ln_attn_post"] = _init_norm(init, cfg)
            p["ln_mlp_post"] = _init_norm(init, cfg)
        if kind == "dec":  # whisper decoder: + cross attention
            p["ln_cross"] = _init_norm(init, cfg)
            p["cross"] = attn.init_attention(init, cfg, cross=True)
    elif kind == "cross":  # vlm gated cross-attention block
        p["ln_cross"] = _init_norm(init, cfg)
        p["cross"] = attn.init_attention(init, cfg, cross=True)
        p["gate_attn"] = init.zeros((1,), (None,))
        p["ln_mlp"] = _init_norm(init, cfg)
        p["mlp"] = mlp_mod.init_mlp(init, cfg)
        p["gate_mlp"] = init.zeros((1,), (None,))
    else:
        raise ValueError(kind)
    return Params(**p)


def block_train(p, x: torch.Tensor, cfg: ArchConfig, kind: str, *, window: int = 0,
                memory: attn.KVCache | None = None, collect_cache: bool = False,
                share: DataShare | None = None, act: int | None = None):
    """Returns (x', cache, aux_loss). cache is KV/SSM state for decode;
    ``share``: the batch is one data-parallel rank's (``moe.moe_fwd``);
    ``act``: the residual's split dimension over the model axis."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if kind == "mamba":
        y, cache = ssm_mod.ssm_train(p["ssm"], _norm(p["norm"], x, cfg), cfg, act=act)
        return x + y, cache, aux

    if kind == "cross":
        h = _norm(p["ln_cross"], x, cfg)
        y = attn.attn_cross(p["cross"], h, memory, cfg, act=act)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * y
        h2 = _norm(p["ln_mlp"], x, cfg)
        y2 = mlp_mod.mlp_fwd(p["mlp"], h2, cfg, act=act)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * y2, None, aux

    h = _norm(p["ln_attn"], x, cfg)
    y, kv = attn.attn_train(p["attn"], h, cfg, window=window, causal=kind != "enc", act=act)
    if cfg.post_block_norm:
        y = _norm(p["ln_attn_post"], y, cfg)
    x = x + y
    if collect_cache:
        cache = kv

    if kind == "dec":
        x = x + attn.attn_cross(p["cross"], _norm(p["ln_cross"], x, cfg), memory, cfg,
                                act=act)

    h2 = _norm(p["ln_mlp"], x, cfg)
    if kind == "moe":
        y2, aux = moe_mod.moe_fwd(p["moe"], h2, cfg, renorm=cfg.moe_renorm, share=share,
                                  act=act)
    else:
        y2 = mlp_mod.mlp_fwd(p["mlp"], h2, cfg, act=act)
    if cfg.post_block_norm:
        y2 = _norm(p["ln_mlp_post"], y2, cfg)
    return x + y2, cache, aux


def block_decode(p, x: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig,
                 kind: str, *, window: int = 0, memory: attn.KVCache | None = None):
    """One token x (B, 1, D), whole on every rank.  Returns (x', cache),
    ``cache`` updated in place."""
    if kind == "mamba":
        y, cache = ssm_mod.ssm_decode(p["ssm"], _norm(p["norm"], x, cfg), cache, cfg)
        return x + y, cache

    h = _norm(p["ln_attn"], x, cfg)
    y, cache = attn.attn_decode(p["attn"], h, cache, pos, cfg, window=window,
                                split=split_of(cache.k), axes=split_axes(cache.k))
    if cfg.post_block_norm:
        y = _norm(p["ln_attn_post"], y, cfg)
    x = x + y

    if kind == "dec":
        x = x + attn.attn_cross(p["cross"], _norm(p["ln_cross"], x, cfg), memory, cfg)

    h2 = _norm(p["ln_mlp"], x, cfg)
    if kind == "moe":
        y2, _ = moe_mod.moe_fwd(p["moe"], h2, cfg, renorm=cfg.moe_renorm)
    else:
        y2 = mlp_mod.mlp_fwd(p["mlp"], h2, cfg)
    if cfg.post_block_norm:
        y2 = _norm(p["ln_mlp_post"], y2, cfg)
    return x + y2, cache


def init_stack(init: Initializer, cfg: ArchConfig, kinds: tuple[str, ...],
               n_groups: int) -> nn.ModuleList:
    """n_groups repetitions of the block pattern ``kinds``: one
    ``ModuleList`` of n_groups blocks per kind (the reference's stacked
    segment, its leading 'layers' axis unrolled)."""
    return nn.ModuleList(
        nn.ModuleList(init_block(init, cfg, k) for _ in range(n_groups)) for k in kinds)
