"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

The port of ``repro.models.ssm``.  Prefill uses the chunked SSD algorithm:
within a chunk the output is an attention-like masked product; across
chunks a Python loop passes the (H, P, N) state (the reference's
``lax.scan``).  Decode is the O(1) recurrent update, made IN PLACE on the
cache.

Layout: x (B, L, H, P) with H = d_inner/head_dim heads, P = head_dim,
N = ssm_state, single B/C group (n_groups=1, as mamba2-130m).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, Initializer, Params, rmsnorm

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


def ssm_train(p, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, SSMCache]:
    """x: (B, L, D) -> (y (B, L, D), cache for decode continuation)."""
    bsz, l, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xh = xbc[..., :di].reshape(bsz, l, h, pd)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())

    y, state = _ssd_chunked(xh.float(), dt, a, bmat.float(), cmat.float(), cfg)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(bsz, l, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.rms_eps)
    out = y @ p["out_proj"]

    # decode continuation needs the last W-1 RAW (pre-activation) conv
    # inputs -- a zeroed window silently corrupts the first decoded tokens.
    conv_tail = xbc_raw[:, -(cfg.ssm_conv - 1):, :].to(x.dtype)
    return out, SSMCache(state=state.float(), conv=conv_tail)


def ssm_decode(p, x: torch.Tensor, cache: SSMCache, cfg: ArchConfig,
               ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update, x: (B, 1, D); ``cache`` is updated IN
    PLACE and returned."""
    bsz = x.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x[:, 0, :] @ p["in_proj"]  # (B, proj)
    z, xbc_new, dt_raw = _split_proj(cfg, zxbcdt)

    # rolling conv window: (B, W-1, C) + new row
    win = torch.cat([cache.conv, xbc_new[:, None, :].to(cache.conv.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", win.float(), p["conv_w"].float())
    xbc = F.silu(conv_out + p["conv_b"].float())

    xh = xbc[:, :di].reshape(bsz, h, pd)
    bvec = xbc[:, di:di + n]
    cvec = xbc[:, di + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a[None, :])  # (B, H)

    new_state = cache.state * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh.float(), bvec)
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec)
    y = y + xh.float() * p["D"].float()[None, :, None]
    y = y.reshape(bsz, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.rms_eps)
    out = (y @ p["out_proj"])[:, None, :]
    cache.state.copy_(new_state)
    cache.conv.copy_(win[:, 1:, :])
    return out, cache
