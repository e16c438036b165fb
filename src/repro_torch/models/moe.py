"""Mixture-of-Experts with gather-based dispatch (no dense all-experts pass).

The port of ``repro.models.moe``.  Tokens are routed top-k, sorted by
expert and packed into fixed-capacity expert buckets per batch row;
capacity overflow drops the pair (GShard semantics).  The top-k is a
stable descending sort, never ``torch.topk``: ``jax.lax.top_k`` breaks ties
by the lower index and so does a stable sort, while ``torch.topk``'s tie
order is undefined.  The bucket scatter writes disjoint slots
(``scatter_add_``; dropped pairs add zeros into slot 0); the combine sums
each token's k contributions with ``index_put_(accumulate=True)``, which
is deterministic on the card where ``index_add_`` uses atomics.

Over the model axis every rank routes the whole sequence (the reference
gathers it: ``moe.py:73``), so the router, the capacity and the buckets
are the global ones; the experts' weights are the rank's pieces:
``expert_ffn`` columns (TP-in-expert, the default rules) or whole experts
(the EP variant, ``{"expert": ("model",)}``, E padded to the axis by
``cfg.pad_experts_to``).  Either way a rank's expert outputs are partial
sums of the combine (another rank's experts add exact zeros), which is
reduce-scattered onto the residual's pieces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import comm_over, constrain
from repro_torch.models.common import ArchConfig, DataShare, Initializer, Params
from repro_torch.models.mlp import init_mlp, mlp_fwd

__all__ = ["init_moe", "moe_fwd"]


def init_moe(init: Initializer, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    e = cfg.pad_experts_to or cfg.num_experts  # padded experts are never routed to
    f = cfg.moe_d_ff or cfg.d_ff
    p = dict(router=init.dense((d, cfg.num_experts), ("embed", "expert"), scale=0.02),
             w_gate=init.dense((e, d, f), ("expert", "embed_fsdp", "expert_ffn")),
             w_up=init.dense((e, d, f), ("expert", "embed_fsdp", "expert_ffn")),
             w_down=init.dense((e, f, d), ("expert", "expert_ffn", "embed_fsdp")))
    if cfg.shared_d_ff:
        p["shared"] = init_mlp(init, cfg, d_ff=cfg.shared_d_ff)
        p["shared_gate"] = init.dense((d, 1), ("embed", None), scale=0.02)
    return Params(**p)


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    cap = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig, *, renorm: bool = True,
            share: DataShare | None = None, act: int | None = None):
    """x: (B, S, D) -> (y, aux_loss).  Dispatch is per batch row; capacity
    is per (row, expert): S·k·cf/E slots.  With ``share`` (the B rows are one
    data-parallel rank's) the load-balance loss takes the fraction routed to
    each expert over every rank's rows (the counts summed across the ranks,
    no gradient through them) and this rank's mean probabilities: the
    ranks' values then average to the global batch's.  ``x`` is placed
    as ``mlp.mlp_fwd``'s, and so is the output."""
    x = constrain(x, "batch", "seq", "embed", src=act)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    e_pad = cfg.pad_experts_to or e
    dev = x.device

    logits = (x @ p["router"]).float()  # (B, S, E): the EP rules split its columns
    logits = constrain(logits, "batch", "seq", None,
                       src=None if p.split("router") is None else 2)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = top_vals[..., :k], top_idx[..., :k]  # (B, S, k)
    if renorm:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Load-balance loss: E * sum_e (fraction routed to e) * (mean prob of e).
    # bincount's integers, summed by scatter_add_ (bincount's output size
    # depends on the data, so it has no meta kernel)
    flat = eidx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    n_rows = b
    if share is not None:
        counts = share.all_reduce(counts)
        n_rows = b * share.size
    frac = counts / (n_rows * s)
    pbar = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac * pbar)

    # ---- pack (token, slot) pairs into per-row expert buckets -----------
    cap = _capacity(cfg, s)
    sk = s * k
    fe = eidx.reshape(b, sk)  # expert of each (token, slot) pair
    fgate = gate_vals.reshape(b, sk).to(x.dtype)
    ftok = torch.arange(s, device=dev).repeat_interleave(k)[None, :].expand(b, sk)

    order = torch.argsort(fe, dim=1, stable=True)
    se = torch.gather(fe, 1, order)
    stok = torch.gather(ftok, 1, order)
    sgate = torch.gather(fgate, 1, order)
    seg_start = torch.searchsorted(se, se, side="left")
    rank = torch.arange(sk, device=dev)[None, :] - seg_start
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, 0)

    gathered = torch.gather(x, 1, stok[..., None].expand(b, sk, d))
    gathered = torch.where(keep[..., None], gathered, 0).to(x.dtype)  # (B, sk, D)
    expert_in = torch.zeros((b, e_pad * cap, d), dtype=x.dtype, device=dev)
    expert_in.scatter_add_(1, slot[..., None].expand(b, sk, d), gathered)
    expert_in = constrain(expert_in.reshape(b, e_pad, cap, d),
                          "batch", "expert", "expert_cap", "embed")

    h = torch.einsum("becd,edf->becf", expert_in, p["w_gate"])
    u = torch.einsum("becd,edf->becf", expert_in, p["w_up"])
    h = F.silu(h) * u
    y_e = torch.einsum("becf,efd->becd", h, p["w_down"])
    if y_e.shape[1] != e_pad:  # EP: this rank's experts, the others' zero
        e_loc = y_e.shape[1]
        at = e_loc * comm_over().index
        y_e = F.pad(y_e, (0, 0, 0, 0, at, e_pad - at - e_loc))
    y_e = y_e.reshape(b, e_pad * cap, d)

    contrib = torch.gather(y_e, 1, slot[..., None].expand(b, sk, d))
    contrib = contrib * (sgate * keep.to(x.dtype))[..., None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, sk)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    out.index_put_((rows, stok), contrib, accumulate=True)
    out = constrain(out, "batch", "act_seq", "embed", partial=p.split("w_gate") is not None)

    if "shared" in p:
        sg = torch.sigmoid((x @ p["shared_gate"]).float()).to(x.dtype)
        out = out + constrain(sg, "batch", "act_seq", None) * mlp_fwd(p["shared"], x, cfg)
    return out, aux
