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

Under ``distributed.sharding.use_rules`` over a live mesh each rank holds
its pieces of the projections (``qkv`` columns of ``wq``/``wk``/``wv``, the
rows of ``wo``) and the function executes the reference's ``constrain``
sites over the model axis: the normed residual is gathered along its
sequence, each rank attends with its heads (K/V heads gathered where the
divisibility rule keeps them whole, as gemma-2b's one KV head), and the
``wo`` partial sums are reduce-scattered back onto the residual's pieces.
Decode over a ``kv_seq``-split cache is flash-decoding: each rank owns a
contiguous block of slots, the ring-buffer write lands on its owner, and
the ranks' (max, sum, weighted values) combine in float32.

Projections are ``@`` in the parameter dtype.  Where the reference asks
XLA for float32 products (``preferred_element_type``: the attention scores
and the probabilities against V) the port takes them with float32 output
too (:func:`_bmm_f32`), so bf16 scores are not rounded to bf16 before the
scale, softcap, mask and softmax.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import comm_over, constrain
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


def _col(p, key: str) -> int | None:
    """2 where the product ``x @ p[key]`` of a (B, S, D) ``x`` holds a piece
    of its columns (the weight's last dimension split over the model
    axis), else None."""
    return 2 if p.split(key) == 1 else None


def _to_heads(t, n: int, cfg: ArchConfig, axis: str, src: int | None):
    """A (B, S, n * Dh) projection (columns split over the model axis where
    ``src`` is 2) as (B, S, heads, Dh), its heads placed by ``axis``'s rule:
    a piece whose split falls inside a head is gathered first."""
    comm = comm_over()
    if src is not None and n % comm.size:
        t, src = constrain(t, "batch", "seq", None, src=src), None
    b, s, _ = t.shape
    return constrain(t.reshape(b, s, -1, cfg.hdim), "batch", "seq", axis, "head_dim", src=src)


def _project_q(p, x, cfg: ArchConfig):
    src = _col(p, "wq")
    q = constrain(x @ p["wq"], "batch", "seq", "qkv", src=src)
    return _to_heads(q, cfg.n_heads, cfg, "heads", src)


def _project_kv(p, x, cfg: ArchConfig):
    k = _to_heads(x @ p["wk"], cfg.n_kv_heads, cfg, "kv_heads", _col(p, "wk"))
    v = _to_heads(x @ p["wv"], cfg.n_kv_heads, cfg, "kv_heads", _col(p, "wv"))
    return k, v


def _span(t, n: int) -> tuple[int, int]:
    """(first head, heads) of this rank's piece of an n-head tensor whose
    head axis is 2: all of them, or the rank's piece."""
    h = t.shape[2]
    return (0, n) if h == n else (comm_over().index * h, h)


def _output(p, out, heads: tuple[int, ...], cfg: ArchConfig, act: str):
    """``out @ wo`` placed by ``act``'s rule, from the attention output of
    the q heads ``heads`` (this rank's, in order: out (B, S, len(heads),
    Dh)).  Where they are the rank's piece of the ``qkv`` columns (or all
    of them), no collective is needed before ``wo``; otherwise the heads are
    placed in a zero (B, S, H, Dh) whose sum over the ranks is the whole
    output, and the sum is reduce-scattered onto the ``qkv`` pieces."""
    b, s = out.shape[:2]
    h = cfg.n_heads
    if len(heads) == h:
        o = constrain(out.reshape(b, s, cfg.qkv_dim), "batch", "seq", "qkv")
    else:
        comm = comm_over()
        n = h // comm.size
        if h % comm.size == 0 and heads == tuple(range(comm.index * n, comm.index * n + n)):
            o = out.reshape(b, s, -1)
        else:
            whole = out.new_zeros((b, s, h, cfg.hdim)).index_add(
                2, _index(heads, out.device), out)
            o = constrain(whole.reshape(b, s, cfg.qkv_dim), "batch", "seq", "qkv",
                          partial=True)
    split = o.shape[-1] != cfg.qkv_dim
    return constrain(o @ p["wo"], "batch", act, "embed", partial=split)


@functools.lru_cache(maxsize=256)
def _index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an index tensor on ``device``, made once: a layer's
    head indices are known on the host, and a copy to the card in every
    layer would wait for the stream."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _group_heads(q0: int, hq: int, g: int, k0: int) -> tuple[int, ...]:
    """For the q heads ``q0`` .. ``q0 + hq``, the index of each one's K/V
    head (``g`` q heads a group) within a piece whose first is ``k0``."""
    return tuple(j // g - k0 for j in range(q0, q0 + hq))


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


def _padded_heads(cfg: ArchConfig, q_span, kv_span, lo: int, n: int):
    """The flat padded heads ``lo`` .. ``lo + n`` of the reference's layout
    (q-heads padded per GQA group to ``cfg.pad_heads_to``): for each, the
    index of its q head within the rank's ``q_span`` (first, count), or
    ``count`` for a padding head (a zero head appended), and of its K/V
    head within ``kv_span``; and the positions of the real heads.  Raises
    where a needed head is not the rank's."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    g = h // hkv
    gp = (cfg.pad_heads_to or h) // hkv
    (q0, hq), (k0, hk) = q_span, kv_span
    qi, ki, keep = [], [], []
    for at, j in enumerate(range(lo, lo + n)):
        grp, slot = divmod(j, gp)
        if not k0 <= grp < k0 + hk:
            raise NotImplementedError(
                f"{cfg.arch_id}: padded heads {lo}..{lo + n - 1} need kv head {grp} outside "
                f"this rank's {k0}..{k0 + hk - 1}")
        ki.append(grp - k0)
        if slot < g:
            qh = grp * g + slot
            if not q0 <= qh < q0 + hq:
                raise NotImplementedError(
                    f"{cfg.arch_id}: padded heads {lo}..{lo + n - 1} need q head {qh} outside "
                    f"this rank's {q0}..{q0 + hq - 1}")
            qi.append(qh - q0)
            keep.append(at)
        else:
            qi.append(hq)
    return tuple(qi), tuple(ki), tuple(keep)


def _attn_flat_padded(p, q, k, v, positions, cfg: ArchConfig, *, window: int,
                      causal: bool):
    """Head-padded flat attention: q-heads padded per GQA group to
    ``cfg.pad_heads_to`` (zeros, dropped again at the end) and K/V repeated
    per group, then ``q_chunk`` query rows at a time; returns ``out @ wo``
    placed as the residual.  Over the model axis a rank computes its piece
    of the flat padded head axis."""
    b, s, _, dh = q.shape
    hp = cfg.pad_heads_to or cfg.n_heads
    comm = comm_over()
    lo, n = 0, hp
    if comm is not None:
        if hp % comm.size == 0:  # the flat head axis splits: this rank's piece
            n = hp // comm.size
            lo = comm.index * n
        else:  # the divisibility rule replicates the heads: every rank, all
            q = constrain(q, "batch", "seq", None, "head_dim",
                          src=_split_heads(q, cfg.n_heads))
            k = constrain(k, "batch", "seq", None, "head_dim",
                          src=_split_heads(k, cfg.n_kv_heads))
            v = constrain(v, "batch", "seq", None, "head_dim",
                          src=_split_heads(v, cfg.n_kv_heads))
    q_span = _span(q, cfg.n_heads)
    qi, ki, keep = _padded_heads(cfg, q_span, _span(k, cfg.n_kv_heads), lo, n)
    dev = q.device
    if qi == tuple(range(q.shape[2])):
        qf = q
    else:  # padded slots read the appended zero head, as the reference pads
        qf = torch.nn.functional.pad(q, (0, 0, 0, 1)).index_select(2, _index(qi, dev))
    if ki == tuple(range(k.shape[2])):
        kf, vf = k, v
    else:
        kf = k.index_select(2, _index(ki, dev))
        vf = v.index_select(2, _index(ki, dev))

    qc = cfg.q_chunk
    if s % qc != 0 or s <= qc:
        mask = _scores_mask(positions, positions, causal=causal, window=window)
        out = _flat_sdpa(qf, kf, vf, mask, cfg.attn_softcap)
    else:
        def chunk(q_rows, pi):
            mask = _scores_mask(pi, positions, causal=causal, window=window)
            return _flat_sdpa(q_rows, kf, vf, mask, cfg.attn_softcap)

        out = torch.cat([remat(cfg, chunk, qf[:, c0:c0 + qc], positions[c0:c0 + qc])
                         for c0 in range(0, s, qc)], dim=1)
    if len(keep) != n:
        out = out.index_select(2, _index(keep, dev))
    return _output(p, out, tuple(qi[j] + q_span[0] for j in keep), cfg, "act_seq")


def attn_train(p, x: torch.Tensor, cfg: ArchConfig, *, window: int = 0,
               causal: bool = True, positions: torch.Tensor | None = None,
               act: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """x: (B, S, D), this rank's piece of the normed residual (split along
    dimension ``act`` over the model axis, or whole) -> (y placed as the
    residual, the layer's (k, v) for prefill, this rank's heads)."""
    x = constrain(x, "batch", "seq", "embed", src=act)
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
    y = _attn_flat_padded(p, q, k, v, positions, cfg, window=window, causal=causal)
    return y, KVCache(k=k, v=v)


def _write(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor, mine) -> None:
    """``buf[:, slot] = new`` where ``mine`` (a 0-d bool tensor: the slot is
    this rank's; None: always), without reading anything back to the host."""
    if mine is not None:
        new = torch.where(mine, new, buf.index_select(1, slot))
    buf.index_copy_(1, slot, new)


def attn_decode(p, x: torch.Tensor, cache: KVCache | QuantKVCache, pos: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0, split: int | None = None,
                axes: tuple[str, ...] = ("model",)):
    """One token x (B, 1, D) at position ``pos`` (a 0-d integer tensor: the
    number of tokens already cached) against ``cache``, whose slot
    ``pos mod S_cache`` is overwritten IN PLACE.  Returns (y, cache) with
    the same cache tensors.  Nothing is read back to the host.

    ``split``: the dimension of the cache leaves (B, S, Hkv, Dh) that is
    split over the model axis (1: ``kv_seq``, flash-decoding, its blocks
    over the mesh ``axes``: the model axis, or with long_500k's rules the
    model and data axes together; 2: the K/V heads) or None (whole)."""
    b = x.shape[0]
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    flash = split == 1
    blocks = comm_over(axes) if flash else None  # the ranks owning the slot blocks
    s_local = cache.k.shape[1]
    s_cache = s_local * (blocks.size if flash else 1)

    q = _project_q(p, x, cfg)  # (B,1,H,Dh)
    k_new, v_new = _project_kv(p, x, cfg)  # (B,1,Hkv,Dh)
    if flash:  # every rank attends with every head over its block of slots
        q = constrain(q, "batch", "seq", None, "head_dim", src=_split_heads(q, cfg.n_heads))
        k_new = constrain(k_new, "batch", "seq", None, "head_dim",
                          src=_split_heads(k_new, hkv))
        v_new = constrain(v_new, "batch", "seq", None, "head_dim",
                          src=_split_heads(v_new, hkv))
    if cfg.rope_theta > 0:
        ppos = pos.reshape(1)
        q = rope(q, ppos, cfg.rope_theta)
        k_new = rope(k_new, ppos, cfg.rope_theta)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k_new = rmsnorm(k_new, p["k_norm"], cfg.rms_eps)

    # Ring-buffer write (windowed caches wrap; full caches have pos < S),
    # on the slot's owner only when the slots are split.
    slot = torch.remainder(pos, s_cache).reshape(1)
    first = blocks.index * s_local if flash else 0
    mine = None
    at = slot
    if flash:
        local = slot - first
        mine = ((local >= 0) & (local < s_local)).reshape(())
        at = torch.clamp(local, 0, s_local - 1)
    if isinstance(cache, QuantKVCache):
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        _write(cache.k, at, kq, mine)
        _write(cache.v, at, vq, mine)
        _write(cache.k_scale, at, ks, mine)
        _write(cache.v_scale, at, vs, mine)
        # dequantize at read
        k = (cache.k.float() * cache.k_scale[..., None]).to(x.dtype)
        v = (cache.v.float() * cache.v_scale[..., None]).to(x.dtype)
    else:
        _write(cache.k, at, k_new.to(cache.k.dtype), mine)
        _write(cache.v, at, v_new.to(cache.v.dtype), mine)
        k, v = cache.k, cache.v

    kpos = first + torch.arange(s_local, device=x.device)
    # Valid = written positions; with wraparound every slot is valid once
    # pos >= s_cache.  (The reference's note: RoPE phases for wrapped slots
    # are stale by one window -- acceptable for the serving dry-run; exact
    # ring-RoPE is a serve-time detail orthogonal to sharding/roofline.)
    valid = torch.where(pos >= s_cache, torch.ones_like(kpos, dtype=torch.bool),
                        kpos <= slot)
    if flash:
        out = _flash_decode(q.reshape(b, 1, hkv, g, cfg.hdim), k, v, valid, cfg, blocks)
        return _output(p, out.reshape(b, 1, cfg.n_heads, cfg.hdim),
                       tuple(range(cfg.n_heads)), cfg, "seq"), cache
    q0, hq = _span(q, cfg.n_heads)
    k0, hk = _span(k, hkv)
    if q0 % g == 0 and hq % g == 0 and k0 == q0 // g and hk == hq // g:
        # the reference's inline grouped attention, op for op: _sdpa with a
        # one-row mask
        out = _sdpa(q.reshape(b, 1, hq // g, g, cfg.hdim), k, v, valid[None, :],
                    cfg.attn_softcap)
    else:  # the rank's q heads share K/V heads with another rank's
        ki = _index(_group_heads(q0, hq, g, k0), x.device)
        out = _flat_sdpa(q, k.index_select(2, ki), v.index_select(2, ki), valid[None, :],
                         cfg.attn_softcap)
    return _output(p, out.reshape(b, 1, hq, cfg.hdim), tuple(range(q0, q0 + hq)), cfg,
                   "seq"), cache


def _split_heads(t, n: int) -> int | None:
    """2 where ``t``'s head axis holds a piece of its n heads, else None."""
    return None if t.shape[2] == n else 2


def _flash_decode(qg, k, v, valid, cfg: ArchConfig, comm):
    """Grouped one-row attention of every head (qg (B, 1, Hkv, G, Dh)) over
    this rank's block of cache slots (k/v (B, S_local, Hkv, Dh), ``valid``
    (S_local,)), the blocks combined over the model ranks: the global max
    of the scores, then the sums of exp(score - max) and of their products
    with V, added in float32, and their quotient."""
    b, _, hkv, g, dh = qg.shape
    scale = 1.0 / math.sqrt(dh)
    qf = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g, dh)
    scores = _bmm_f32(qf, _heads_first(k).transpose(1, 2)).view(b, hkv, g, -1) * scale
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid[None, None, None], scores, _NEG)
    m = comm.maximum(torch.amax(scores, dim=-1, keepdim=True))
    e = torch.exp(scores - m)
    num = _bmm_f32(e.to(v.dtype).view(b * hkv, g, -1), _heads_first(v)).view(b, hkv, g, dh)
    both = comm.reduce(torch.cat([num, e.sum(dim=-1, keepdim=True)], dim=-1))
    out = both[..., :dh] / both[..., dh:]
    return out.permute(0, 1, 2, 3).reshape(b, 1, hkv * g, dh).to(qg.dtype)


def attn_cross(p, x: torch.Tensor, memory_kv: KVCache, cfg: ArchConfig, *,
               act: int | None = None) -> torch.Tensor:
    """Cross attention in flat-head layout, q-chunked, no RoPE and no mask;
    ``x`` is placed as ``attn_train``'s, the output as the residual."""
    x = constrain(x, "batch", "seq", "embed", src=act)
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    q = _project_q(p, x, cfg)
    q0, hq = _span(q, cfg.n_heads)
    k0, _ = _span(memory_kv.k, cfg.n_kv_heads)
    ki = _index(_group_heads(q0, hq, g, k0), x.device)
    kf = memory_kv.k.index_select(2, ki)  # (B, M, H, Dh): K/V repeated per group
    vf = memory_kv.v.index_select(2, ki)

    qc = cfg.q_chunk
    if s % qc != 0 or s <= qc:
        out = _flat_sdpa(q, kf, vf, None, 0.0)
    else:
        out = torch.cat([remat(cfg, _flat_sdpa, q[:, c0:c0 + qc], kf, vf, None, 0.0)
                         for c0 in range(0, s, qc)], dim=1)
    return _output(p, out, tuple(range(q0, q0 + hq)), cfg, "act_seq")


def cross_memory(p, memory: torch.Tensor, cfg: ArchConfig) -> KVCache:
    """Precompute cross-attention K/V from encoder/vision states (B, M, Dm)
    (whole on every rank), this rank's K/V heads where they split."""
    k = _to_heads(memory @ p["wk"], cfg.n_kv_heads, cfg, "kv_heads", _col(p, "wk"))
    v = _to_heads(memory @ p["wv"], cfg.n_kv_heads, cfg, "kv_heads", _col(p, "wv"))
    return KVCache(k=k, v=v)
