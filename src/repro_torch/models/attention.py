"""GQA/MQA attention: RoPE, sliding window, logit softcap, cross-attention,
decode against a KV cache.

Three entry points, as in ``repro.models.attention``:
  attn_train    full-sequence forward, query-chunked (a Python loop over
                ``q_chunk`` rows, so the (B, H, Sq, Skv) score tile never
                exceeds q_chunk rows; each chunk rematerialised in the
                backward pass where ``cfg.remat`` is set, as the
                reference's scan body is); also returns (k, v) for prefill.
  attn_decode   one new token against a fixed-size KV cache, which it
                updates IN PLACE (the port's one departure from the
                reference's functional update: a copy of the cache per
                token would cost more than the step).
  attn_cross    queries over a static memory (encoder output / vision).

Projections are ``@`` in the parameter dtype.  Where the reference asks
XLA for float32 products (``preferred_element_type``: the attention scores
and the probabilities against V) the port takes them with float32 output
too (:func:`_bmm_f32`), so bf16 scores are not rounded to bf16 before the
scale, softcap, mask and softmax.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.common import (ArchConfig, Initializer, Params, remat, rmsnorm,
                                       rope, softcap)

__all__ = ["KVCache", "QuantKVCache", "init_attention", "attn_train", "attn_decode",
           "attn_cross", "cross_memory"]

_NEG = -1e30  # the reference's mask value, in float32


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Hkv, Dh)
    v: torch.Tensor  # (B, S_cache, Hkv, Dh)


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) float32 scales."""

    k: torch.Tensor  # int8 (B, S_cache, Hkv, Dh)
    v: torch.Tensor  # int8
    k_scale: torch.Tensor  # f32 (B, S_cache, Hkv)
    v_scale: torch.Tensor  # f32


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 1, Hkv, Dh) -> (int8 values, (B, 1, Hkv) scales).

    ``torch.round`` rounds half to even, as ``jnp.round`` does; a code can
    still differ by one from the reference's where ``x / scale`` lies within
    rounding of a half (a near-tie)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def init_attention(init: Initializer, cfg: ArchConfig, *, cross: bool = False) -> Params:
    d, qkv, kvd = cfg.d_model, cfg.qkv_dim, cfg.kv_dim
    kv_in = d
    if cross and cfg.family == "vlm" and cfg.vision_dim:
        kv_in = cfg.vision_dim
    p = dict(wq=init.dense((d, qkv), ("embed_fsdp", "qkv")),
             wk=init.dense((kv_in, kvd), ("embed_fsdp", "qkv")),
             wv=init.dense((kv_in, kvd), ("embed_fsdp", "qkv")),
             wo=init.dense((qkv, d), ("qkv", "embed_fsdp")))
    if cfg.qk_norm:
        p["q_norm"] = init.ones((cfg.hdim,), ("head_dim",))
        p["k_norm"] = init.ones((cfg.hdim,), ("head_dim",))
    return Params(**p)


def _project_q(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    return (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hdim)


def _project_kv(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hdim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hdim)
    return k, v


def _scores_mask(qpos, kpos, *, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


class _BmmF32(torch.autograd.Function):
    """bf16 ``a @ b`` with a float32 result on the card (``bmm``'s
    ``out_dtype``, which has no derivative of its own).  The backward's two
    products take the cotangent rounded to the operands' dtype, with
    float32 accumulation: a default-precision product's rounding (the
    reference transposes into an f32 product; one in full f32 would run
    outside the tensor cores, since the port keeps TF32 off)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def _bmm_f32(a, b):
    """Batched ``a @ b`` with float32 output, the reference's
    ``preferred_element_type=jnp.float32``: bf16 operands go to one product
    that accumulates and returns float32 (``bmm``'s ``out_dtype`` on the
    card and on meta, :class:`_BmmF32`; widened operands on the CPU, whose
    products of bf16 values are exact in float32 all the same)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type != "cpu":  # the card, and a dry run of the card's ops on meta
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _heads_first(x):
    """(B, S, H, Dh) -> (B * H, S, Dh)."""
    b, s, h, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, dh)


def _sdpa(q, k, v, mask, cap: float):
    """q: (B,Sq,Hkv,G,Dh) k/v: (B,Skv,Hkv,Dh) mask: (Sq,Skv) or None."""
    b, sq, hkv, g, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qg = q.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * sq, dh)
    scores = _bmm_f32(qg, _heads_first(k).transpose(1, 2)).view(b, hkv, g, sq, -1) * scale
    scores = softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _bmm_f32(probs.to(v.dtype).view(b * hkv, g * sq, -1), _heads_first(v))
    return out.view(b, hkv, g, sq, dh).permute(0, 3, 1, 2, 4).to(q.dtype)


def _flat_sdpa(q, k, v, mask, cap: float):
    """Flat-head attention: q (B,Sq,Hp,Dh), k/v (B,Skv,Hp,Dh) pre-repeated."""
    b, sq, hp, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    scores = _bmm_f32(_heads_first(q), _heads_first(k).transpose(1, 2))
    scores = softcap(scores.view(b, hp, sq, -1) * scale, cap)
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _bmm_f32(probs.to(v.dtype).view(b * hp, sq, -1), _heads_first(v))
    return out.view(b, hp, sq, dh).permute(0, 2, 1, 3).to(q.dtype)


def _attn_flat_padded(p, q, k, v, positions, cfg: ArchConfig, *, window: int,
                      causal: bool):
    """Head-padded flat attention: q-heads padded per GQA group to
    ``cfg.pad_heads_to`` (zeros, dropped again at the end) and K/V repeated
    per group, then ``q_chunk`` query rows at a time."""
    b, s, h, dh = q.shape
    hkv = cfg.n_kv_heads
    g = h // hkv
    hp = cfg.pad_heads_to or h
    gp = hp // hkv
    if gp > g:
        qg = q.reshape(b, s, hkv, g, dh)
        qg = torch.nn.functional.pad(qg, (0, 0, 0, gp - g))
        q = qg.reshape(b, s, hp, dh)
    kf = torch.repeat_interleave(k, gp, dim=2)
    vf = torch.repeat_interleave(v, gp, dim=2)

    qc = cfg.q_chunk
    if s % qc != 0 or s <= qc:
        mask = _scores_mask(positions, positions, causal=causal, window=window)
        out = _flat_sdpa(q, kf, vf, mask, cfg.attn_softcap)
    else:
        def chunk(qi, pi):
            mask = _scores_mask(pi, positions, causal=causal, window=window)
            return _flat_sdpa(qi, kf, vf, mask, cfg.attn_softcap)

        out = torch.cat([remat(cfg, chunk, q[:, c0:c0 + qc], positions[c0:c0 + qc])
                         for c0 in range(0, s, qc)], dim=1)
    if gp > g:
        out = out.reshape(b, s, hkv, gp, dh)[:, :, :, :g, :]
    return out.reshape(b, s, h * dh)


def attn_train(p, x: torch.Tensor, cfg: ArchConfig, *, window: int = 0,
               causal: bool = True, positions: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, KVCache]:
    """x: (B, S, D) -> (y (B, S, D), the layer's (k, v) for prefill)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    out = _attn_flat_padded(p, q, k, v, positions, cfg, window=window, causal=causal)
    return out @ p["wo"], KVCache(k=k, v=v)


def attn_decode(p, x: torch.Tensor, cache: KVCache | QuantKVCache, pos: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0):
    """One token x (B, 1, D) at position ``pos`` (a 0-d integer tensor: the
    number of tokens already cached) against ``cache``, whose slot
    ``pos mod S_cache`` is overwritten IN PLACE.  Returns (y, cache) with
    the same cache tensors.  Nothing is read back to the host."""
    b = x.shape[0]
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    s_cache = cache.k.shape[1]

    q = _project_q(p, x, cfg)  # (B,1,H,Dh)
    k_new, v_new = _project_kv(p, x, cfg)  # (B,1,Hkv,Dh)
    if cfg.rope_theta > 0:
        ppos = pos.reshape(1)
        q = rope(q, ppos, cfg.rope_theta)
        k_new = rope(k_new, ppos, cfg.rope_theta)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k_new = rmsnorm(k_new, p["k_norm"], cfg.rms_eps)

    # Ring-buffer write (windowed caches wrap; full caches have pos < S).
    slot = torch.remainder(pos, s_cache).reshape(1)
    if isinstance(cache, QuantKVCache):
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache.k.index_copy_(1, slot, kq)
        cache.v.index_copy_(1, slot, vq)
        cache.k_scale.index_copy_(1, slot, ks)
        cache.v_scale.index_copy_(1, slot, vs)
        # dequantize at read
        k = (cache.k.float() * cache.k_scale[..., None]).to(x.dtype)
        v = (cache.v.float() * cache.v_scale[..., None]).to(x.dtype)
    else:
        cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
        k, v = cache.k, cache.v

    kpos = torch.arange(s_cache, device=x.device)
    # Valid = written positions; with wraparound every slot is valid once
    # pos >= s_cache.  (The reference's note: RoPE phases for wrapped slots
    # are stale by one window -- acceptable for the serving dry-run; exact
    # ring-RoPE is a serve-time detail orthogonal to sharding/roofline.)
    valid = torch.where(pos >= s_cache, torch.ones_like(kpos, dtype=torch.bool),
                        kpos <= slot)
    # the reference's inline grouped attention, op for op: _sdpa with a
    # one-row mask
    out = _sdpa(q.reshape(b, 1, hkv, g, cfg.hdim), k, v, valid[None, :], cfg.attn_softcap)
    return out.reshape(b, 1, cfg.qkv_dim) @ p["wo"], cache


def attn_cross(p, x: torch.Tensor, memory_kv: KVCache, cfg: ArchConfig) -> torch.Tensor:
    """Cross attention in flat-head layout, q-chunked, no RoPE and no mask."""
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    q = _project_q(p, x, cfg)
    kf = torch.repeat_interleave(memory_kv.k, g, dim=2)  # (B, M, H, Dh)
    vf = torch.repeat_interleave(memory_kv.v, g, dim=2)

    qc = cfg.q_chunk
    if s % qc != 0 or s <= qc:
        out = _flat_sdpa(q, kf, vf, None, 0.0)
    else:
        out = torch.cat([remat(cfg, _flat_sdpa, q[:, c0:c0 + qc], kf, vf, None, 0.0)
                         for c0 in range(0, s, qc)], dim=1)
    return out.reshape(b, s, cfg.qkv_dim) @ p["wo"]


def cross_memory(p, memory: torch.Tensor, cfg: ArchConfig) -> KVCache:
    """Precompute cross-attention K/V from encoder/vision states (B, M, Dm)."""
    b, m, _ = memory.shape
    k = (memory @ p["wk"]).reshape(b, m, cfg.n_kv_heads, cfg.hdim)
    v = (memory @ p["wv"]).reshape(b, m, cfg.n_kv_heads, cfg.hdim)
    return KVCache(k=k, v=v)
