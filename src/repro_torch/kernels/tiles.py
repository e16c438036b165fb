"""Per-tile DCO stage helpers in plain PyTorch (port of
``repro.kernels.tiles``).

The same arithmetic lives in ``csrc/tiles.cuh`` for the CUDA kernel; these
are its plain versions, used by the oracle ``ref.ivf_scan_ref``.  Every
helper accepts leading batch dimensions (``(..., BQ, BC)`` tiles), so the
oracle can screen all query tiles of a step at once.

Exactness notes:

  * stage 1's int8 products run as float32 matmuls of the codes: every
    partial sum is an integer of magnitude < ``block_d * 127**2`` < 2**24,
    so the float32 result is the exact int32 dot in any summation order,
    on the CPU and on the card alike (the card must not use TF32 here);
  * square roots are taken in float64 and rounded once to float32, which
    is the correctly rounded float32 root (PyTorch's float32 ``sqrt`` on
    the CPU can be one unit in the last place off, XLA's and CUDA's
    ``sqrtf`` are not);
  * stage 2's fp32 norms and dot products are summed one dimension at a
    time, in order, each product and each sum rounded to float32 (no fused
    multiply-add), which is the CUDA kernel's order: the two agree bit for
    bit, and with other implementations (the reference's matmul) to fp32
    rounding.
"""

from __future__ import annotations

import torch

__all__ = [
    "mxu_block_sq", "lb_penalized", "dade_threshold",
    "stage1_tile", "stage2_slab", "stage2_need", "stage2_tile",
    "merge_topk_tile", "dup_mask",
]


def mxu_block_sq(qb: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(..., BQ, BC) clamped squared partial distance of one dim-block,
    ``max(qn + cn - 2 q·cᵀ, 0)`` in float32, the sums taken dimension by
    dimension in order (see the module docstring)."""
    qn = torch.zeros(qb.shape[:-1] + (1,), dtype=torch.float32, device=qb.device)
    cn = torch.zeros(cb.shape[:-2] + (1, cb.shape[-2]), dtype=torch.float32,
                     device=cb.device)
    dot = torch.zeros(qb.shape[:-1] + (cb.shape[-2],), dtype=torch.float32,
                      device=qb.device)
    for d in range(qb.shape[-1]):
        qd = qb[..., d:d + 1]  # (..., BQ, 1)
        cd = cb[..., d].unsqueeze(-2)  # (..., 1, BC)
        qn = qn + qd * qd
        cn = cn + cd * cd
        dot = dot + qd * cd
    return torch.clamp_min(qn + cn - 2.0 * dot, 0.0)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (see the module docstring)."""
    return torch.sqrt(x.double()).float()


def lb_penalized(psum, eband, scale, *, slack: float):
    """Scaled sound lower bound ``max(0, sqrt(psum) - eband)^2 (1-slack) scale``."""
    root = torch.clamp_min(sqrt_rn(psum) - eband, 0.0)
    return root * root * (1.0 - slack) * scale


def dade_threshold(eps, rsq):
    """The DADE hypothesis-test rejection threshold ``(1+eps)^2 * r^2``."""
    t = 1.0 + eps
    return t * t * rsq


def stage1_tile(qcodes, qscales, ccodes, bscales, eps, scale, rsq,
                *, block_d: int, slack: float):
    """int8×int8 lower-bound prefilter over (..., BQ, BC) tiles.

    Args:
      qcodes (..., BQ, D) int8, qscales (..., BQ, S) f32 query block scales,
      ccodes (..., BC, D) int8, bscales (S,) corpus block scales,
      eps/scale (S,) blocked table, rsq (..., BQ, 1) frozen thresholds.
    Returns (active (..., BQ, BC) bool, d8 (..., BQ, BC) f32 int8 dims
    consumed per row).
    """
    s_count = qcodes.shape[-1] // block_d
    qf = qcodes.float()
    cf = ccodes.float()
    shape = qcodes.shape[:-1] + (ccodes.shape[-2],)
    psum = torch.zeros(shape, dtype=torch.float32, device=qcodes.device)
    active = torch.ones(shape, dtype=torch.bool, device=qcodes.device)
    d8 = torch.zeros(shape, dtype=torch.float32, device=qcodes.device)
    ec2 = torch.zeros((), dtype=torch.float32, device=qcodes.device)
    eq2 = torch.zeros(qscales.shape[:-1] + (1,), dtype=torch.float32,
                      device=qcodes.device)
    for s in range(s_count):
        sl = slice(s * block_d, (s + 1) * block_d)
        qc = qf[..., sl]
        cc = cf[..., sl]
        dot_i = qc @ cc.transpose(-1, -2)  # exact integers (see module doc)
        t_q = qscales[..., s:s + 1]  # (..., BQ, 1)
        s_b = bscales[s]
        qn_i = torch.sum(qc * qc, dim=-1, keepdim=True)
        cn_i = torch.sum(cc * cc, dim=-1).unsqueeze(-2)
        qn = qn_i * (t_q * t_q)
        cn = cn_i * (s_b * s_b)
        dotf = dot_i * (t_q * s_b)
        psum = psum + torch.clamp_min(qn + cn - 2.0 * dotf, 0.0)
        # Cumulative error bands: corpus (scalar) + query (per row).
        hb = s_b * 0.5
        hq = t_q * 0.5
        ec2 = ec2 + block_d * (hb * hb)
        eq2 = eq2 + block_d * (hq * hq)
        eband = sqrt_rn(ec2) + sqrt_rn(eq2)
        d8 = d8 + torch.where(active, float(block_d), 0.0)
        lb = lb_penalized(psum, eband, scale[s], slack=slack)
        thresh = dade_threshold(eps[s], rsq)
        # The lower bound never exceeds the exact partial distance, so
        # rejecting is sound at every checkpoint, the last included.
        active = active & ~(lb > thresh)
    return active, d8


def stage2_slab(psum, active, qb, cb, eps_s, scale_s, rsq,
                *, block_d: int, is_last: bool):
    """One dim-slab step of the blocked fp32 DADE re-screen.
    Returns (psum, active, d32_increment)."""
    psum = psum + mxu_block_sq(qb, cb)
    d32_inc = torch.where(active, float(block_d), 0.0)
    est = psum * scale_s
    reject = active & (est > dade_threshold(eps_s, rsq))
    if is_last:
        reject = torch.zeros_like(reject)
    return psum, active & ~reject, d32_inc


def stage2_need(active, valid):
    """Demand-paging decision per tile (leading dims kept): fetch iff any
    *valid* candidate is still active."""
    return (active & valid).flatten(-2).any(dim=-1)


def stage2_tile(q, c, eps, scale, rsq, active0, valid, *, block_d: int):
    """Blocked fp32 DADE screen of the stage-1 survivors of (..., BQ, BC)
    tiles; a whole-tile replay of the kernel's demand-paged slab loop.

    Returns (exact_sq, passed, d32, slabs (...) f32 — the (BC, block_d)
    slabs a paging kernel ships per tile)."""
    s_count = q.shape[-1] // block_d
    psum = torch.zeros(active0.shape, dtype=torch.float32, device=q.device)
    active = active0
    d32 = torch.zeros(active0.shape, dtype=torch.float32, device=q.device)
    slabs = torch.zeros(active0.shape[:-2], dtype=torch.float32, device=q.device)
    for s in range(s_count):
        sl = slice(s * block_d, (s + 1) * block_d)
        slabs = slabs + stage2_need(active, valid).float()
        # Upcast per block: the serving corpus streams as bf16.
        qb = q[..., sl].float()
        cb = c[..., sl].float()
        psum, active, d32_inc = stage2_slab(
            psum, active, qb, cb, eps[s], scale[s], rsq,
            block_d=block_d, is_last=s == s_count - 1)
        d32 = d32 + d32_inc
    passed = active & (psum <= rsq)
    return psum, passed, d32, slabs


def merge_topk_tile(top_sq, top_ids, new_sq, new_ids, *, k: int):
    """Merge (..., BQ, BC) candidates into the running (..., BQ, K) top-K.

    A stable sort of ``[window, tile]`` by distance: ties keep the lowest
    column, the current window before the new tile — the order of the
    reference's K-step min-extract.  Entries at inf carry id -1.
    ``new_sq`` must already be inf for rows that must not enter.
    """
    all_sq = torch.cat([top_sq, new_sq], dim=-1)
    all_ids = torch.cat([top_ids, new_ids.expand(new_sq.shape)], dim=-1)
    srt, idx = torch.sort(all_sq, dim=-1, stable=True)
    sq = srt[..., :k]
    ids = torch.gather(all_ids, -1, idx[..., :k])
    ids = torch.where(torch.isinf(sq), torch.full_like(ids, -1), ids)
    return sq, ids


def dup_mask(new_ids, top_ids, *, k: int):
    """(..., BQ, BC) bool — candidate id already present in the running
    top-K (``new_ids`` (..., 1, BC), ``top_ids`` (..., BQ, K))."""
    top = top_ids[..., :k].unsqueeze(-1)  # (..., BQ, K, 1)
    hit = (new_ids.unsqueeze(-2) == top) & (top >= 0)
    return hit.any(dim=-2)
