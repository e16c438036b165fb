"""Shared model substrate: config schema, norms, RoPE, softcap, init.

The port's counterpart of ``repro.models.common``.  The reference's models
are functional pytrees; here the parameter tree is a tree of
``nn.Module`` nodes (:class:`Params`) holding ``nn.Parameter`` leaves under
the reference's names, in its ``(d_in, d_out)`` layout (``x @ W``), so a
reference tree moves into the port without transposes
(``repro_torch.interop.lm_from_arrays``).  Every parameter carries the
reference's logical sharding axes (``Initializer``: its ``logical_axes``,
collected by ``LM.param_axes``), from which ``distributed.sharding`` derives
each rank's placement.  The model learns its groups as the reference's
does: the data ranks from a :class:`DataShare` (its batch is one rank's
share of a batch split over them), the model axis from the rules in force
(``sharding.use_rules`` over a live mesh: ``sharding.comm_over``), under
which each ``Params`` node reads which of its parameters the rank holds in
pieces (:meth:`Params.split`) and the model code executes the reference's
``constrain`` sites.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import comm_over, current_rules, model_dim, rules_in

__all__ = ["ArchConfig", "Params", "Initializer", "DataShare", "rmsnorm", "layernorm",
           "rope", "softcap", "remat", "embed_lookup", "mark_split", "split_of", "split_axes"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One schema for every assigned architecture family (the reference's
    fields, names and defaults)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    attn_softcap: float = 0.0  # gemma2: 50.0
    final_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0  # 0 = full attention
    window_pattern: str = "none"  # none | all | alternate (gemma2)
    norm: str = "rmsnorm"  # rmsnorm | layernorm (whisper)
    post_block_norm: bool = False  # gemma2 sandwich norms
    activation: str = "silu"  # silu | geglu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: hidden *= sqrt(d_model)
    qk_norm: bool = False
    # pad q-heads per GQA group to this count (0 = off) and run attention
    # with a flat head axis (k/v repeated per group), as the reference does
    pad_heads_to: int = 0

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0  # routed expert width (qwen2moe: 1408)
    shared_d_ff: int = 0  # qwen2moe shared experts (4*1408)
    capacity_factor: float = 1.25
    # renormalise the top-k gates to sum to one (qwen2moe does not: the
    # reference decides it by arch id inside its blocks; here it is the
    # config's, the port's one field the reference's schema lacks)
    moe_renorm: bool = True

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2)
    attn_every: int = 0  # shared attention block cadence

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # stub frame embeddings

    # vlm (llama-3.2-vision)
    cross_every: int = 0  # self-layers per cross-attn block
    vision_seq: int = 1601
    vision_dim: int = 0  # 0 -> d_model (stub projects to d_model)

    # numerics / compile strategy
    dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1  # microbatches per step
    kv_cache_dtype: str = ""  # "" = param dtype; "int8" = quantized KV cache
    pad_experts_to: int = 0  # pad expert tables (never routed to)
    q_chunk: int = 512  # query-block size for chunked attention
    loss_chunk: int = 2048  # seq chunk for the streamed CE loss

    # shapes the launcher may exercise (informational)
    max_seq: int = 524288

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.hdim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hdim

    @property
    def vocab_padded(self) -> int:
        return (self.vocab_size + 255) // 256 * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_windows(self) -> list[int]:
        """Per-layer sliding window (0 = full)."""
        if self.window_pattern == "all":
            return [self.sliding_window] * self.num_layers
        if self.window_pattern == "alternate":
            # gemma2: even layers local (SWA), odd layers global.
            return [self.sliding_window if i % 2 == 0 else 0
                    for i in range(self.num_layers)]
        return [0] * self.num_layers


class Params(nn.Module):
    """A node of the parameter tree: parameters and sub-nodes under the
    reference's keys, read as ``p["wq"]`` and tested as ``"w_gate" in p``."""

    def __init__(self, **children):
        super().__init__()
        meta = {}
        for key, child in children.items():
            setattr(self, key, child)
            if isinstance(child, nn.Parameter):
                meta[key] = (child.logical_axes, tuple(child.shape))
        self._meta = meta  # each parameter's logical axes and whole shape

    def split(self, key: str) -> int | None:
        """The dimension of parameter ``key`` that this rank holds a piece
        of (split over the model axis by the rules in force), or None."""
        axes, shape = self._meta[key]
        return model_dim(axes, shape)

    def whole(self, key: str) -> torch.Tensor:
        """Parameter ``key`` whole: gathered over the model axis where this
        rank holds a piece (``collectives.gather_along``: its gradient
        reduce-scattered back onto the piece)."""
        from repro_torch.distributed.collectives import gather_along
        dim = self.split(key)
        return self[key] if dim is None else gather_along(self[key], dim, comm_over())

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---- primitives ------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    # gemma-style (1 + w) parameterization is folded into init (w ~ 1.0).
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh), positions: (..., S).

    The frequencies are ``exp(-log(theta) * i / half)``, the reference's
    formula (``theta ** (-i / half)`` rounds differently)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (its activations
    recomputed in the backward pass) where the reference applies
    ``jax.checkpoint``: ``cfg.remat`` set and gradients on.  The
    recomputation runs under the sharding rules of the forward pass (the
    card's backward runs on the autograd engine's own thread, which does
    not see them), so it repeats the same collectives in the same order on
    every rank."""
    if cfg.remat and torch.is_grad_enabled():
        rules = current_rules()
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), rules_in(rules)))
    return fn(*args)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, split: int | None):
    """Rows ``tokens`` of an embedding ``table``.  Where ``split`` is 0 the
    table is this rank's piece of the vocabulary rows: tokens outside it
    read zeros, so the result is this rank's partial sum of the lookup (one
    rank holds each token's row; the others add exact zeros)."""
    if split is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - comm_over().index * rows
    inside = (local >= 0) & (local < rows)
    h = F.embedding(torch.where(inside, local, 0), table)
    return h * inside[..., None].to(h.dtype)


def mark_split(t: torch.Tensor, dim: int | None,
               axes: tuple[str, ...] = ("model",)) -> torch.Tensor:
    """Record on a cache tensor the dimension this rank holds a piece of
    and the mesh axes it is split over (the model axis, alone or with
    others), read by :func:`split_of`; returns ``t``.  A decode cache's
    placement cannot be read off its shape alone (a local block of slots
    and a whole cache of the same length look alike)."""
    t._model_split, t._split_axes = dim, tuple(axes)
    return t


def split_of(t: torch.Tensor) -> int | None:
    """The dimension :func:`mark_split` recorded on ``t``: None without a
    model axis; a cache used under one must come from ``LM.init_caches`` or
    ``LM.prefill`` under the same rules."""
    if comm_over() is None:
        return None
    if not hasattr(t, "_model_split"):
        raise ValueError("a decode cache under a model axis must come from LM.init_caches "
                         "or LM.prefill under the same rules")
    return t._model_split


def split_axes(t: torch.Tensor) -> tuple[str, ...]:
    """The mesh axes :func:`mark_split` recorded on ``t``."""
    return getattr(t, "_split_axes", ("model",))


# ---- initialization --------------------------------------------------------


class Initializer:
    """Draws parameters from the reference's distributions on an explicit
    ``torch.Generator``: ``dense`` is normal x 1/sqrt(fan_in) (or x
    ``scale``), drawn in float32 and cast to ``dtype``; ``zeros`` and
    ``ones`` as named.  Each takes the parameter's logical axes (one name or
    None per dimension, the reference's), kept as its ``logical_axes``.  On
    ``device="meta"`` nothing is drawn or allocated (``generator`` may be
    None): the tree then carries shapes and dtypes only."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def _param(self, t: torch.Tensor, axes: tuple) -> nn.Parameter:
        if len(axes) != t.ndim:
            raise ValueError(f"logical axes {axes} do not match shape {tuple(t.shape)}")
        p = nn.Parameter(t, requires_grad=False)
        p.logical_axes = tuple(axes)
        return p

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def dense(self, shape: tuple[int, ...], axes: tuple,
              scale: float | None = None) -> nn.Parameter:
        if self.device.type == "meta":
            return self._param(self._empty(shape), axes)
        fan_in = shape[0] if len(shape) >= 2 else 1
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return self._param(w.mul_(std).to(self.dtype), axes)

    def zeros(self, shape: tuple[int, ...], axes: tuple) -> nn.Parameter:
        if self.device.type == "meta":
            return self._param(self._empty(shape), axes)
        return self._param(torch.zeros(shape, dtype=self.dtype, device=self.device), axes)

    def ones(self, shape: tuple[int, ...], axes: tuple) -> nn.Parameter:
        if self.device.type == "meta":
            return self._param(self._empty(shape), axes)
        return self._param(torch.ones(shape, dtype=self.dtype, device=self.device), axes)


class DataShare(NamedTuple):
    """This rank's share of a batch split row-wise over ``size``
    data-parallel ranks (the model axis, where there is one, is the rules'
    ``sharding.comm_over``): the loss is normalised by the global token count
    (``size`` x the rank's), the MoE load-balance loss takes the global
    fraction routed to each expert (``all_reduce`` sums its (E,) counts over
    the ranks) and this rank's mean probabilities, divided by ``size``; so
    each rank's loss is its additive share of the global loss, and summing
    the ranks' gradients gives the global gradient."""

    size: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]
