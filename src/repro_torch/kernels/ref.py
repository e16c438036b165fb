"""Plain-PyTorch oracles of the CUDA kernels: the flat DCO screens
``dade_dco_ref``, ``quant_dco_ref`` and ``l2_scan_ref`` (ports of
``repro.kernels.ref.dade_dco_ref``/``quant_dco_ref`` and of the l2 scan's
contract) for ``csrc/dade_dco.cu``, ``csrc/quant_dco.cu`` and
``csrc/l2_scan.cu``, and the fused scans ``ivf_scan_ref`` and
``graph_scan_ref`` (ports of ``repro.kernels.ref``'s) for
``csrc/ivf_scan.cu`` and ``csrc/graph_scan.cu``'s one-wave kernel, and the
whole single-shard graph walk ``graph_walk_ref`` (``graph_scan_ref`` waves
with the frontier picked between them by ``select_wave_ref``, the tensor
form of ``repro.index.graph._select_wave``) for its persistent walk kernel.

The flat screens walk the dimension blocks in order over all (Q, N) pairs
at once, with ``tiles.mxu_block_sq``'s per-dimension sums: a pair retires
at its first rejecting checkpoint (or the last one), which is the value the
kernel's tile-granular early exit leaves, so kernel and plain version agree
bit for bit whatever tile the kernel runs.

The fused scans replay the kernels' shared walk (``csrc/scan_walk.cuh``) with the
helpers of ``tiles.py`` and model its memory behaviour exactly:

  * steps with offset -1 are skipped (no fetch, no screen, no stats);
  * a real step whose offset equals the last *issued* offset re-uses the
    resident int8 tile, even across -1 gap steps (``s1_tiles_fetched``
    counts fresh offsets only);
  * fp slabs are fetched per ``tiles.stage2_need``
    (``s2_slabs_fetched``), and a tile with no valid stage-1 survivor runs
    no stage 2 and no merge;
  * after a merge r² tightens to the window's ``thresh_col`` entry (the
    K-th for the IVF scan), unless the graph wave freezes it
    (``tighten=False``).

Query tiles are independent, so the walk runs all of them together, one
step at a time: step ``s`` screens every query tile whose offset at ``s``
is real.  The offset table is read on the host once; no other value leaves
the device, so the walk runs asynchronously on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tiles import (
    dade_threshold, dup_mask, lb_penalized, merge_topk_tile, mxu_block_sq,
    stage1_tile, stage2_tile,
)

__all__ = ["dade_dco_ref", "quant_dco_ref", "l2_scan_ref", "ivf_scan_ref",
           "graph_scan_ref", "select_wave_ref", "graph_walk_ref", "STATS_COLS"]


def _blocks(q, c, s_count, block_d):
    """Yield ``(s, block_sq (Q, N))`` for the dimension blocks in order."""
    dim = q.shape[1]
    if dim % block_d or (s_count is not None and s_count != dim // block_d):
        raise ValueError(f"D={dim} must be {s_count} blocks of {block_d}")
    for s in range(dim // block_d):
        sl = slice(s * block_d, (s + 1) * block_d)
        yield s, mxu_block_sq(q[:, sl].float(), c[:, sl].float())


def dade_dco_ref(q_rot, cands_rot, eps, scale, r_sq, *, block_d: int = 128):
    """Algorithm 1 as a blocked fp32 screen of every (query, candidate) pair.

    A pair retires rejected at the first non-final checkpoint where
    ``psum·scale_s > (1+eps_s)²r²``, else exact at the last one.  Returns
    (est_sq (Q, N) f32 at retirement, passed (Q, N) int32 = never rejected
    and est <= r², dims_used (Q, N) int32)."""
    s_count = eps.shape[0]
    rsq = r_sq.float()[:, None]
    shape = (q_rot.shape[0], cands_rot.shape[0])
    dev = q_rot.device
    psum = torch.zeros(shape, dtype=torch.float32, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    est = torch.zeros(shape, dtype=torch.float32, device=dev)
    dims = torch.zeros(shape, dtype=torch.int32, device=dev)
    for s, bsq in _blocks(q_rot, cands_rot, s_count, block_d):
        psum = psum + bsq
        e = psum * scale[s]
        if s == s_count - 1:  # the exact terminal retire: no rejection
            retire = active
        else:
            retire = active & (e > dade_threshold(eps[s], rsq))
        est = torch.where(retire, e, est)
        dims = torch.where(retire, (s + 1) * block_d, dims)
        active = active & ~retire
    passed = (dims == s_count * block_d) & (est <= rsq)
    return est, passed.to(torch.int32), dims


def quant_dco_ref(q_rot, codes, scales, eps, scale, ecum, r_sq, *,
                  block_d: int = 128, slack: float = 1e-4):
    """The int8 lower-bound prefilter over per-dimension codes.

    Codes dequantize as ``code·scales[d]``; a pair retires pruned at the
    first checkpoint, the last included, where ``lb_penalized(psum,
    ecum_s, scale_s) > (1+eps_s)²r²``.  Returns (lb_sq (Q, N) f32 at
    retirement, pruned (Q, N) int32, lb_dims (Q, N) int32)."""
    s_count = eps.shape[0]
    rsq = r_sq.float()[:, None]
    cf = codes.float() * scales.float()[None, :]
    shape = (q_rot.shape[0], codes.shape[0])
    dev = q_rot.device
    psum = torch.zeros(shape, dtype=torch.float32, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    pruned = torch.zeros(shape, dtype=torch.bool, device=dev)
    lb = torch.zeros(shape, dtype=torch.float32, device=dev)
    dims = torch.zeros(shape, dtype=torch.int32, device=dev)
    for s, bsq in _blocks(q_rot, cf, s_count, block_d):
        psum = psum + bsq
        e = lb_penalized(psum, ecum[s], scale[s], slack=slack)
        reject = active & (e > dade_threshold(eps[s], rsq))
        retire = active if s == s_count - 1 else reject
        lb = torch.where(retire, e, lb)
        dims = torch.where(retire, (s + 1) * block_d, dims)
        pruned = pruned | reject
        active = active & ~retire
    return lb, pruned.to(torch.int32), dims


def l2_scan_ref(q_rot, cands_rot, *, block_d: int = 128):
    """Exact squared L2 distances (Q, N) f32 over the full D: the sum over
    dimension blocks of ``max(qn + cn - 2 q·cᵀ, 0)``."""
    out = torch.zeros((q_rot.shape[0], cands_rot.shape[0]), dtype=torch.float32,
                      device=q_rot.device)
    for _, bsq in _blocks(q_rot, cands_rot, None, block_d):
        out = out + bsq
    return out


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


def _walk(offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids, codes, rows,
          ids, bscales, eps, scale, *, k, thresh_col, tighten, block_q,
          block_c, block_d, slack, return_trace):
    """The walk of every query tile over its row of ``offs`` ((q_tiles,
    steps) int64 numpy, -1 = gap step).  Returns (top_sq (Q, K), top_ids
    (Q, K), stats (Q, 6), trace) with trace records keyed by (tile, step)."""
    dev = q_rot.device
    qn, dim = q_rot.shape
    qt, steps = offs.shape
    n_tiles = codes.shape[0] // block_c
    codes_t = codes.reshape(n_tiles, block_c, dim)
    rows_t = rows.reshape(n_tiles, block_c, dim)
    ids_t = ids.reshape(n_tiles, block_c).to(torch.int32)

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
        ids_s = ids_t[oi].unsqueeze(-2)  # (R, 1, BC)
        valid = ids_s >= 0
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
        dup = dup_mask(ids_s, w_ids, k=k)
        new_sq = torch.where(ok & ~dup, exact_sq,
                             torch.full_like(exact_sq, float("inf")))
        m_sq, m_ids = merge_topk_tile(w_sq, w_ids, new_sq, ids_s, k=k)
        keep = alive.reshape(-1, 1, 1)
        m_sq = torch.where(keep, m_sq, w_sq)
        t_sq[ti] = m_sq
        t_ids[ti] = torch.where(keep, m_ids, w_ids)
        if tighten:
            rsq[ti] = torch.where(
                keep, torch.minimum(rsq_frozen, m_sq[..., thresh_col:thresh_col + 1]),
                rsq_frozen)

        if return_trace:
            for r, i in enumerate(tiles.tolist()):
                a = bool(alive[r])
                trace.append(dict(
                    tile=i, step=s, row_start=int(off[i]) * block_c,
                    ids=ids_s[r, 0], rsq=rsq_frozen[r, :, 0], active8=active8[r],
                    valid=valid[r, 0], alive=int(alive_n[r]), fetched=a,
                    fresh=bool(fresh[r]), slabs=float(slabs[r]) if a else 0.0,
                    passed=passed[r] if a else torch.zeros_like(active8[r]),
                    exact_sq=exact_sq[r] if a else None))

    trace.sort(key=lambda rec: (rec["tile"], rec["step"]))
    return t_sq.reshape(qn, k), t_ids.reshape(qn, k), st.reshape(qn, 6), trace


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
    qt = q_rot.shape[0] // block_q
    offs = tile_offs.reshape(qt, -1).cpu().numpy().astype(np.int64)
    *out, trace = _walk(
        offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids, flat_codes,
        flat_rot, flat_ids, bscales, eps, scale, k=k, thresh_col=k - 1,
        tighten=True, block_q=block_q, block_c=block_c, block_d=block_d,
        slack=slack, return_trace=return_trace)
    if not return_trace:
        return tuple(out)
    for rec in trace:
        s = rec.pop("step")
        rec.update(probe=s // cap_tiles, ctile=s % cap_tiles)
    return tuple(out) + (trace,)


def graph_scan_ref(
    step_offs: torch.Tensor,  # (q_tiles, steps) int per-step tile offsets
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    top0_sq: torch.Tensor,  # (Q, EF) f32 beam window carried across waves
    top0_ids: torch.Tensor,  # (Q, EF) int32
    r0_sq: torch.Tensor,  # (Q,) f32
    vis0: torch.Tensor,  # (q_tiles, W) int32 packed visited bitmap carried in
    adj_codes: torch.Tensor,  # (N_adj, D) int8 adjacency-flat
    adj_rot: torch.Tensor,  # (N_adj, D) f32 or bf16
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32
    scale: torch.Tensor,  # (S,) f32
    vis_base: int = 0,
    *,
    ef: int,
    thresh_col: int | None = None,
    block_q: int,
    block_c: int,
    block_d: int,
    slack: float = 1e-4,
    tighten: bool = True,
    return_trace: bool = False,
):
    """One wave of the graph beam scan: the walk seeded from the window,
    r² and visited bitmap the previous wave returned.  Every real step sets
    bit ``vis_base + off`` of its tile's bitmap row (bit 31 of a word is
    its sign bit).

    Returns (top_sq (Q, EF) f32, top_ids (Q, EF) int32, stats (Q, 6) f32,
    vis (q_tiles, W) int32); with ``return_trace`` also per-(tile, step)
    records of the real steps, as ``ivf_scan_ref``'s plus ``marked`` (the
    global node whose bit the step set), ordered by (tile, step)."""
    if thresh_col is None:
        thresh_col = ef - 1
    offs = step_offs.cpu().numpy().astype(np.int64)
    *out, trace = _walk(
        offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids, adj_codes,
        adj_rot, adj_ids, bscales, eps, scale, k=ef, thresh_col=thresh_col,
        tighten=tighten, block_q=block_q, block_c=block_c, block_d=block_d,
        slack=slack, return_trace=return_trace)
    vis = vis0.cpu().numpy().astype(np.int32).copy()
    tile, step = np.nonzero(offs >= 0)
    node = offs[tile, step] + int(vis_base)
    np.bitwise_or.at(vis.view(np.uint32), (tile, node // 32),
                     np.left_shift(np.uint32(1), (node % 32).astype(np.uint32)))
    out.append(torch.as_tensor(vis, device=vis0.device))
    if not return_trace:
        return tuple(out)
    for rec in trace:
        rec["marked"] = rec["row_start"] // block_c + int(vis_base)
    return tuple(out) + (trace,)


def select_wave_ref(top_sq, top_ids, vis, route_sq, *, block_q: int, qn: int,
                    expand: int, ef: int):
    """One wave's frontier, the reference's ``_select_wave`` in tensor form.

    Per query row ``r < qn`` (pad rows pick nothing), the first ``expand``
    entries of its sorted window that are not yet expanded in its tile's
    packed bitmap ``vis`` (q_tiles, W), scanning in window order and
    stopping at the first entry whose id is < 0, whose distance is not
    finite or exceeds ``route_sq[r]``; expanded entries are skipped without
    using up the budget.  Per tile, the picks of its queries in query order,
    a node that an earlier query of the tile already proposed used up the
    later query's budget but is not listed again.  Returns the
    (q_tiles, block_q * expand) int32 step table, -1 padded (an all -1 row:
    the tile has converged)."""
    qp = top_sq.shape[0]
    q_tiles = qp // block_q
    dev = top_sq.device
    sq = top_sq[:, :ef].float()
    ids = top_ids[:, :ef].to(torch.int64)
    stop = (ids < 0) | ~torch.isfinite(sq) | (sq > route_sq.float()[:, None])
    open_ = torch.cumsum(stop.to(torch.int32), dim=1) == 0  # before the first stop
    node = ids.clamp_min(0)
    rows = torch.arange(qp, device=dev)
    words = vis.to(torch.int32)[(rows // block_q)[:, None], node >> 5]
    expanded = ((words >> (node & 31).to(torch.int32)) & 1) != 0
    qual = open_ & ~expanded & (rows < qn)[:, None]
    pick = qual & (torch.cumsum(qual.to(torch.int32), dim=1) <= expand)
    # Each row's picks in window order, compacted into `expand` slots.
    order = torch.argsort((~pick).to(torch.int8), dim=1, stable=True)[:, :expand]
    cand = torch.where(torch.gather(pick, 1, order), torch.gather(ids, 1, order),
                       torch.full_like(order, -1))
    cand = torch.nn.functional.pad(cand, (0, expand - cand.shape[1]), value=-1)
    # Per tile, in query order: keep the first proposal of each node.
    lst = cand.reshape(q_tiles, block_q * expand)
    width = lst.shape[1]
    earlier = torch.tril(torch.ones((width, width), dtype=torch.bool, device=dev), -1)
    dup = ((lst[:, :, None] == lst[:, None, :]) & earlier).any(dim=2)
    keep = (lst >= 0) & ~dup
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = torch.where(torch.gather(keep, 1, order), torch.gather(lst, 1, order),
                      torch.full_like(lst, -1))
    return out.to(torch.int32)


def graph_walk_ref(
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    top0_sq: torch.Tensor,  # (Q, EF) f32 seeded window (the entry point)
    top0_ids: torch.Tensor,  # (Q, EF) int32
    seed_sq: torch.Tensor,  # (Q,) f32 threshold floor (inf: none; 0: pad rows)
    vis0: torch.Tensor,  # (q_tiles, W) int32 packed visited bitmap
    adj_codes: torch.Tensor,  # (N_adj, D) int8 adjacency-flat
    adj_rot: torch.Tensor,  # (N_adj, D) f32 or bf16
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32
    scale: torch.Tensor,  # (S,) f32
    *,
    entry: int,
    qn: int,
    ef: int,
    thresh_col: int,
    expand: int,
    max_waves: int,
    route_mult: float,
    block_q: int,
    block_c: int,
    block_d: int,
    slack: float = 1e-4,
):
    """The single-shard graph walk: up to ``max_waves`` waves of
    ``graph_scan_ref``, each from r² = min(seed, window[thresh_col]) per
    query, the first the entry point alone, every later one the frontier
    ``select_wave_ref`` picks with the gate r² · ``route_mult`` (fp32).  A
    tile whose frontier is empty has converged: its window, r² and bitmap
    no longer change, so it runs no later wave; the walk ends when every
    tile has.

    Returns (top_sq (Q, EF) f32, top_ids (Q, EF) int32, stats (max_waves,
    Q, 6) f32 — each wave's ``STATS_COLS``, zero where a tile ran no wave,
    vis (q_tiles, W) int32, waves (q_tiles,) int32 — the waves each tile
    ran)."""
    qp = q_rot.shape[0]
    q_tiles = qp // block_q
    dev = q_rot.device
    top_sq, top_ids, vis = top0_sq.float(), top0_ids.to(torch.int32), vis0
    seed = seed_sq.float()
    mult = torch.tensor(route_mult, dtype=torch.float32, device=dev)
    stats = torch.zeros((max_waves, qp, len(STATS_COLS)), dtype=torch.float32,
                        device=dev)
    waves = torch.zeros((q_tiles,), dtype=torch.int32, device=dev)
    for w in range(max_waves):
        r0 = torch.minimum(seed, top_sq[:, thresh_col])
        if w == 0:
            offs = torch.full((q_tiles, 1), int(entry), dtype=torch.int32, device=dev)
        else:
            offs = select_wave_ref(top_sq, top_ids, vis, r0 * mult, block_q=block_q,
                                   qn=qn, expand=expand, ef=ef)
        live = (offs >= 0).any(dim=1)
        if not bool(live.any()):
            break
        waves += live.to(torch.int32)
        top_sq, top_ids, stats[w], vis = graph_scan_ref(
            offs, qcodes, q_rot, qscales, top_sq, top_ids, r0, vis, adj_codes,
            adj_rot, adj_ids, bscales, eps, scale, 0, ef=ef, thresh_col=thresh_col,
            block_q=block_q, block_c=block_c, block_d=block_d, slack=slack)
    return top_sq, top_ids, stats, vis, waves
