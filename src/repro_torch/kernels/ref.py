"""Plain-PyTorch oracle of the fused IVF wave scan (port of
``repro.kernels.ref.ivf_scan_ref``) — the plain version of the CUDA kernel
in ``csrc/ivf_scan.cu``.

It replays the kernel's walk with the helpers of ``tiles.py`` and models
its memory behaviour exactly:

  * steps with offset -1 are skipped (no fetch, no screen, no stats);
  * a real step whose offset equals the last *issued* offset re-uses the
    resident int8 tile, even across -1 gap steps (``s1_tiles_fetched``
    counts fresh offsets only);
  * fp slabs are fetched per ``tiles.stage2_need``
    (``s2_slabs_fetched``), and a tile with no valid stage-1 survivor runs
    no stage 2 and no merge.

Query tiles are independent, so the walk runs all of them together, one
step at a time: step ``s`` screens every query tile whose offset at ``s``
is real.  The offset table is read on the host once; no other value leaves
the device, so the walk runs asynchronously on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tiles import (
    dup_mask, merge_topk_tile, stage1_tile, stage2_tile,
)

__all__ = ["ivf_scan_ref", "STATS_COLS"]

# stats columns: semantic dims-consumed accounting (0-3) + fetch counters
# (4-5, tile-level, broadcast to every query row of the tile).
STATS_COLS = (
    "int8_dims",        # 0: int8 dims consumed (retirement checkpoints)
    "fp32_dims",        # 1: fp dims consumed by stage-2 survivors
    "rows_scanned",     # 2: valid candidate rows screened
    "rows_passed",      # 3: rows surviving the full screen
    "s2_slabs_fetched",  # 4: fp (BC, block_d) slabs fetched
    "s1_tiles_fetched",  # 5: int8 tiles fetched (fresh real offsets)
)


def ivf_scan_ref(
    tile_offs: torch.Tensor,  # (q_tiles, P, cap_tiles) int per-step offsets
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    r0_sq: torch.Tensor,  # (Q,) f32
    top0_sq: torch.Tensor,  # (Q, K) f32 seeded window (inf = empty)
    top0_ids: torch.Tensor,  # (Q, K) int32 seeded ids (-1 = empty)
    flat_codes: torch.Tensor,  # (N_pad, D) int8
    flat_rot: torch.Tensor,  # (N_pad, D) f32 or bf16
    flat_ids: torch.Tensor,  # (N_pad,) int32
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32
    scale: torch.Tensor,  # (S,) f32
    *,
    k: int,
    block_q: int,
    block_c: int,
    block_d: int,
    cap_tiles: int,
    slack: float = 1e-4,
    return_trace: bool = False,
):
    """Returns (top_sq (Q, K) f32, top_ids (Q, K) int32, stats (Q, 6) f32);
    with ``return_trace`` also a list of per-(tile, probe, ctile) records of
    the real steps (frozen r², scanned window, stage masks and the fetch
    decisions ``alive``/``fetched``/``fresh``/``slabs``), ordered by
    (tile, probe, ctile)."""
    dev = q_rot.device
    qn, dim = q_rot.shape
    qt = qn // block_q
    steps = tile_offs.shape[1] * cap_tiles
    offs = tile_offs.reshape(qt, steps).cpu().numpy().astype(np.int64)
    n_tiles = flat_codes.shape[0] // block_c
    codes_t = flat_codes.reshape(n_tiles, block_c, dim)
    rows_t = flat_rot.reshape(n_tiles, block_c, dim)
    ids_t = flat_ids.reshape(n_tiles, block_c).to(torch.int32)

    qc_t = qcodes.reshape(qt, block_q, dim)
    q_t = q_rot.float().reshape(qt, block_q, dim)
    qs_t = qscales.float().reshape(qt, block_q, -1)
    t_sq = top0_sq.float().reshape(qt, block_q, k).clone()
    t_ids = top0_ids.to(torch.int32).reshape(qt, block_q, k).clone()
    rsq = r0_sq.float().reshape(qt, block_q, 1).clone()
    st = torch.zeros((qt, block_q, 6), dtype=torch.float32, device=dev)
    last = np.full((qt,), -1, np.int64)  # last issued offset per tile
    offs_dev = torch.as_tensor(offs, device=dev)
    last_dev = torch.full((qt,), -1, dtype=torch.int64, device=dev)
    all_tiles = torch.arange(qt, device=dev)
    trace = []

    for s in range(steps):
        off = offs[:, s]
        tiles = np.nonzero(off >= 0)[0]
        if tiles.size == 0:
            continue  # gap step everywhere: nothing ships
        fresh = off[tiles] != last[tiles]
        last[tiles] = off[tiles]
        # Tile indices stay on the device when every tile is real (the
        # serving walk), so no step waits on a host copy.
        ti = all_tiles if tiles.size == qt else torch.as_tensor(tiles, device=dev)
        oi = offs_dev[ti, s]
        s1f = (oi != last_dev[ti]).float()
        last_dev[ti] = oi
        ids = ids_t[oi].unsqueeze(-2)  # (R, 1, BC)
        valid = ids >= 0
        validf = valid.float()
        rsq_frozen = rsq[ti]
        active8, d8 = stage1_tile(
            qc_t[ti], qs_t[ti], codes_t[oi], bscales, eps, scale, rsq_frozen,
            block_d=block_d, slack=slack)
        d8_sum = torch.sum(d8 * validf, dim=-1, keepdim=True)  # (R, BQ, 1)
        nvalid = torch.sum(validf, dim=-1, keepdim=True).expand_as(d8_sum)
        zero = torch.zeros_like(d8_sum)
        s1f = s1f.reshape(-1, 1, 1).expand_as(d8_sum)
        add = torch.cat([d8_sum, zero, nvalid, zero, zero, s1f], dim=-1)

        alive_n = torch.sum(active8 & valid, dim=(-2, -1))  # (R,)
        alive = alive_n > 0
        # Stage 2 and the merge run for every tile of the step and are
        # kept only where the tile has a valid stage-1 survivor: a tile
        # without one ships no fp slab (its stage-2 terms are all zero) and
        # leaves the window and r² untouched.
        exact_sq, passed, d32, slabs = stage2_tile(
            q_t[ti], rows_t[oi], eps, scale, rsq_frozen, active8, valid,
            block_d=block_d)
        ok = passed & valid
        d32_sum = torch.sum(d32 * validf, dim=-1, keepdim=True)
        npass = torch.sum(ok.float(), dim=-1, keepdim=True)
        slabs_col = slabs.reshape(-1, 1, 1).expand_as(d32_sum)
        add2 = torch.cat([zero, d32_sum, zero, npass, slabs_col, zero], dim=-1)
        st[ti] += add + torch.where(alive.reshape(-1, 1, 1), add2,
                                    torch.zeros_like(add2))

        w_sq, w_ids = t_sq[ti], t_ids[ti]
        dup = dup_mask(ids, w_ids, k=k)
        new_sq = torch.where(ok & ~dup, exact_sq,
                             torch.full_like(exact_sq, float("inf")))
        m_sq, m_ids = merge_topk_tile(w_sq, w_ids, new_sq, ids, k=k)
        keep = alive.reshape(-1, 1, 1)
        m_sq = torch.where(keep, m_sq, w_sq)
        t_sq[ti] = m_sq
        t_ids[ti] = torch.where(keep, m_ids, w_ids)
        rsq[ti] = torch.where(keep, torch.minimum(rsq_frozen, m_sq[..., k - 1:k]),
                              rsq_frozen)

        if return_trace:
            for r, i in enumerate(tiles.tolist()):
                a = bool(alive[r])
                trace.append(dict(
                    tile=i, probe=s // cap_tiles, ctile=s % cap_tiles,
                    row_start=int(off[i]) * block_c, ids=ids[r, 0],
                    rsq=rsq_frozen[r, :, 0], active8=active8[r],
                    valid=valid[r, 0], alive=int(alive_n[r]), fetched=a,
                    fresh=bool(fresh[r]), slabs=float(slabs[r]) if a else 0.0,
                    passed=passed[r] if a else torch.zeros_like(active8[r]),
                    exact_sq=exact_sq[r] if a else None))

    trace.sort(key=lambda rec: (rec["tile"], rec["probe"], rec["ctile"]))
    out = (t_sq.reshape(qn, k), t_ids.reshape(qn, k), st.reshape(qn, 6))
    if return_trace:
        return out + (trace,)
    return out
