"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

The port of ``repro.models.ssm``.  Prefill uses the chunked SSD algorithm:
within a chunk the output is an attention-like masked product; across
chunks a Python loop passes the (H, P, N) state (the reference's
``lax.scan``).  Decode is the O(1) recurrent update, made IN PLACE on the
cache.

Layout: x (B, L, H, P) with H = d_inner/head_dim heads, P = head_dim,
N = ssm_state, single B/C group (n_groups=1, as mamba2-130m).

Over the model axis the reference splits ``in_proj``'s concatenated
z/x/B/C/dt columns at ``inner`` pieces, which are not their boundaries:
a rank gathers the projection whole (the conv weights too: they are
tiny), then works on its SSM heads (``ssm_heads``: their z, x and dt
channels; B and C whole), normalises over the whole ``d_inner`` with the
sum of squares reduced over the ranks, and multiplies by its rows of
``out_proj``, a partial sum reduce-scattered onto the residual's pieces.
Where the divisibility rule keeps the heads whole, every rank computes
them all and multiplies its ``inner`` piece by its rows.  The decode
state is split by heads (or, where they stay whole, along ``ssm_state``:
the read-out then summed over the ranks), the rolling conv window by
``inner`` channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import reduce_all
from repro_torch.distributed.sharding import comm_over, constrain
from repro_torch.models.common import ArchConfig, Initializer, Params, rmsnorm, split_of

__all__ = ["SSMCache", "conv_dim", "init_ssm", "ssm_train", "ssm_decode"]


class SSMCache(NamedTuple):
    state: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor  # (B, W-1, conv_dim) rolling conv window


def conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm(init: Initializer, cfg: ArchConfig) -> Params:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h  # z, x, B, C, dt
    return Params(
        in_proj=init.dense((d, proj_out), ("embed_fsdp", "inner")),
        conv_w=init.dense((cfg.ssm_conv, conv_dim(cfg)), (None, "inner"), scale=0.5),
        conv_b=init.zeros((conv_dim(cfg),), ("inner",)),
        A_log=init.zeros((h,), ("ssm_heads",)),
        D=init.ones((h,), ("ssm_heads",)),
        dt_bias=init.zeros((h,), ("ssm_heads",)),
        norm_w=init.ones((di,), ("inner",)),
        out_proj=init.dense((di, d), ("inner", "embed_fsdp")))


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]  # (…, H)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: (B, L, C), w: (W, C)."""
    width, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):  # the reference's unrolled shifts, in its order
        out = out + pad[:, i:i + length, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _ssd_chunked(xh, dt, a, bmat, cmat, cfg: ArchConfig):
    """Chunked SSD scan.

    xh: (B, L, H, P); dt: (B, L, H); a: (H,) negative decay rates;
    bmat/cmat: (B, L, N).  Returns (y (B,L,H,P), final_state (B,H,P,N)).
    """
    bsz, l0, h, p = xh.shape
    n = bmat.shape[-1]
    kc = cfg.ssm_chunk
    # pad to a chunk multiple: dt=0 on pads => decay 1, contribution 0
    # (exact -- padded steps are identities on the state).
    pad = (-l0) % kc
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    l = l0 + pad
    c = l // kc

    xc = xh.reshape(bsz, c, kc, h, p)
    dtc = dt.reshape(bsz, c, kc, h)
    bc = bmat.reshape(bsz, c, kc, n)
    cc = cmat.reshape(bsz, c, kc, n)

    da = dtc * a[None, None, None, :]  # (B,C,K,H) negative
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative decay exponent

    # Intra-chunk (quadratic, masked):
    # Y[i] += sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    mask = torch.tril(torch.ones((kc, kc), dtype=torch.bool, device=xh.device))
    mask5 = mask[None, None, :, :, None]
    # The exponent is masked BEFORE the exp: above the diagonal cum_i - cum_j
    # is positive and overflows to inf once a chunk's decay passes ~88, and
    # the reference's exp-then-where then back-propagates 0 * inf = NaN
    # (mamba2-130m at its 256-token chunks).  The forward values are the
    # reference's; the gradient equals it wherever the reference's is finite.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,i,j,H)
    decay = torch.exp(torch.where(mask5, diff, -torch.inf))
    w_ij = torch.where(mask5, cb[..., None] * decay, 0.0)
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w_ij, dtc, xc)

    # Chunk end-states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,C,K,H)
    sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_end * dtc, bc, xc)

    # Sequential inter-chunk state pass (the incoming state of each chunk).
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,C,H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    states_in = []
    for ci in range(c):
        states_in.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + sc[:, ci]
    states_in = torch.stack(states_in, dim=1)  # (B,C,H,P,N)

    # Inter-chunk: Y[i] += (C_i . state_in) * exp(cum_i)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc, states_in, torch.exp(cum))

    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l0]
    return y, state


class _Heads(NamedTuple):
    """The SSM heads a rank computes: ``first`` .. ``first + count``, and
    whether they are its piece of a split (else all of them)."""

    first: int
    count: int
    split: bool


def _heads(p, cfg: ArchConfig) -> _Heads:
    if p.split("A_log") is None:
        return _Heads(0, cfg.ssm_heads, False)
    comm = comm_over()
    n = cfg.ssm_heads // comm.size
    return _Heads(comm.index * n, n, True)


def _channels(cfg: ArchConfig, hs: _Heads, device) -> torch.Tensor:
    """The conv channels of the heads ``hs``: their x channels, then B, C."""
    di, pd = cfg.d_inner, cfg.ssm_head_dim
    x = torch.arange(hs.first * pd, (hs.first + hs.count) * pd, device=device)
    return torch.cat([x, torch.arange(di, di + 2 * cfg.ssm_state, device=device)])


def _proj(p, x, cfg: ArchConfig, hs: _Heads):
    """``x @ in_proj`` whole on every rank, split into (z, xBC, dt) of the
    heads ``hs``, and the whole raw xBC (every conv channel)."""
    src = 2 if p.split("in_proj") == 1 else None
    zxbcdt = constrain(x @ p["in_proj"], "batch", "seq", "inner", src=src)
    zxbcdt = constrain(zxbcdt, "batch", "seq", None, src=src)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    if hs.count == cfg.ssm_heads:
        return z, xbc, dt, xbc
    pd = cfg.ssm_head_dim
    sl = slice(hs.first * pd, (hs.first + hs.count) * pd)
    return (z[..., sl], xbc.index_select(-1, _channels(cfg, hs, x.device)),
            dt[..., hs.first:hs.first + hs.count], xbc)


def _conv_params(p, cfg: ArchConfig, hs: _Heads):
    """(conv_w, conv_b) of the heads ``hs``' channels."""
    w, b = p.whole("conv_w"), p.whole("conv_b")
    if hs.count == cfg.ssm_heads:
        return w, b
    ch = _channels(cfg, hs, w.device)
    return w.index_select(1, ch), b.index_select(0, ch)


def _gated_out(p, y, z, cfg: ArchConfig, hs: _Heads, act: str):
    """rmsnorm(y * silu(z)) over the whole d_inner, times ``out_proj``,
    placed by ``act``."""
    g = y * F.silu(z)
    if hs.split:  # the rank's channels: the mean square reduced over the ranks
        gf = g.float()
        ms = reduce_all(torch.sum(gf * gf, dim=-1, keepdim=True), comm_over()) / cfg.d_inner
        g = (gf * torch.rsqrt(ms + cfg.rms_eps) * p["norm_w"].float()).to(g.dtype)
    else:
        g = rmsnorm(g, p.whole("norm_w"), cfg.rms_eps)
        if p.split("out_proj") is not None:  # every head here, the rank's rows there
            g = constrain(g, *(("batch", "seq", "inner")[3 - g.ndim:]))
    split = p.split("out_proj") is not None
    out = g @ p["out_proj"]
    if out.ndim == 2:
        return constrain(out, "batch", "embed", partial=split)
    return constrain(out, "batch", act, "embed", partial=split)


def ssm_train(p, x: torch.Tensor, cfg: ArchConfig, *, act: int | None = None,
              ) -> tuple[torch.Tensor, SSMCache]:
    """x: (B, L, D), placed as ``mlp.mlp_fwd``'s -> (y placed as the
    residual, cache for decode continuation: this rank's heads' state, the
    whole raw conv tail)."""
    x = constrain(x, "batch", "seq", "embed", src=act)
    bsz, l, _ = x.shape
    n, pd = cfg.ssm_state, cfg.ssm_head_dim
    hs = _heads(p, cfg)
    dl = hs.count * pd

    z, xbc_raw, dt_raw, raw = _proj(p, x, cfg, hs)
    conv_w, conv_b = _conv_params(p, cfg, hs)
    xbc = _causal_conv(xbc_raw, conv_w, conv_b)
    xh = xbc[..., :dl].reshape(bsz, l, hs.count, pd)
    bmat = xbc[..., dl:dl + n]
    cmat = xbc[..., dl + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())

    y, state = _ssd_chunked(xh.float(), dt, a, bmat.float(), cmat.float(), cfg)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(bsz, l, dl).to(x.dtype)
    out = _gated_out(p, y, z, cfg, hs, "act_seq")

    # decode continuation needs the last W-1 RAW (pre-activation) conv
    # inputs -- a zeroed window silently corrupts the first decoded tokens.
    conv_tail = raw[:, -(cfg.ssm_conv - 1):, :].to(x.dtype)
    return out, SSMCache(state=state.float(), conv=conv_tail)


def ssm_decode(p, x: torch.Tensor, cache: SSMCache, cfg: ArchConfig,
               ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update, x: (B, 1, D) whole; ``cache`` (this
    rank's heads of the state, its ``inner`` piece of the conv window) is
    updated IN PLACE and returned."""
    bsz = x.shape[0]
    n, pd = cfg.ssm_state, cfg.ssm_head_dim
    hs = _heads(p, cfg)
    dl = hs.count * pd

    z, xbc_new, dt_raw, raw = _proj(p, x, cfg, hs)  # (B, 1, ...)
    z, xbc_new, dt_raw = z[:, 0], xbc_new[:, 0], dt_raw[:, 0]
    conv_split = split_of(cache.conv)
    conv = cache.conv if conv_split is None else constrain(cache.conv, "batch", None, None,
                                                           src=conv_split)
    if hs.count != cfg.ssm_heads:
        conv_sel = conv.index_select(-1, _channels(cfg, hs, x.device))
    else:
        conv_sel = conv
    conv_w, conv_b = _conv_params(p, cfg, hs)

    # rolling conv window: (B, W-1, C) + new row
    win = torch.cat([conv_sel, xbc_new[:, None, :].to(conv.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", win.float(), conv_w.float())
    xbc = F.silu(conv_out + conv_b.float())

    xh = xbc[:, :dl].reshape(bsz, hs.count, pd)
    bvec = xbc[:, dl:dl + n]
    cvec = xbc[:, dl + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a[None, :])  # (B, H)

    n_split = split_of(cache.state) == 3  # the state split along ssm_state
    if n_split:  # this rank's piece of N: the read-out summed over the ranks
        bvec, cvec = comm_over().piece(bvec, 1), comm_over().piece(cvec, 1)
    new_state = cache.state * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh.float(), bvec)
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec)
    if n_split:
        y = comm_over().reduce(y)
    y = y + xh.float() * p["D"].float()[None, :, None]
    y = y.reshape(bsz, dl).to(x.dtype)
    out = _gated_out(p, y, z, cfg, hs, "seq")[:, None, :]
    cache.state.copy_(new_state)
    if hs.count == cfg.ssm_heads and conv_split is None:
        cache.conv.copy_(win[:, 1:, :])
    else:  # the window of every channel, this rank's piece kept
        full = torch.cat([conv, raw.to(conv.dtype)], dim=1)[:, 1:, :]
        cache.conv.copy_(constrain(full, "batch", None, "inner"))
    return out, cache
