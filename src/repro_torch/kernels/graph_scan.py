"""Fused graph beam scan: build, binding and launch of the CUDA kernels.

``graph_scan_kernel_call`` is the port of the Pallas kernel
``repro.kernels.graph_scan.graph_scan_kernel_call``: one launch screens one
frontier wave of the batched graph walk for every query tile, resuming the
beam window, r² and packed visited bitmap the previous wave returned.
``graph_walk_kernel_call`` runs the whole single-shard walk in one launch,
each query tile's CTA picking its own frontier between waves (the
reference's ``index.graph._select_wave``) on the card.  Each runs where its
tensors live: on CUDA tensors it launches its hand-written kernel in
``csrc/graph_scan.cu`` (``sm_90a``); on CPU tensors it runs its plain
version, ``ref.graph_scan_ref`` or ``ref.graph_walk_ref``.  There is no
fallback between the two: a CUDA call that cannot launch raises.

The kernel is built at first use with ``nvcc`` (``_build``) into
``build/`` beside this file and bound with ``ctypes``.  Nothing
CUDA-specific happens at import time.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import MAX_SMEM_BYTES
from repro_torch.kernels.ref import STATS_COLS, graph_scan_ref, graph_walk_ref

__all__ = ["graph_scan_kernel_call", "graph_walk_kernel_call", "build",
           "library_path", "STATS_COLS", "KERNEL_TILE", "MAX_EXPAND"]

_SOURCES = ("graph_scan.cu", "scan_walk.cuh", "tiles.cuh")
# (block_q, block_c) of the CUDA kernel: 8 queries (the mma's n) by one
# 32-row neighbour block (two m16 fragments); the plain version takes any.
KERNEL_TILE = (8, 32)
# Picks per query and wave the walk kernel holds, and the static shared
# memory of its step lists (csrc/graph_scan.cu's list_s, picks_s, npick_s
# and nlist_s).
MAX_EXPAND = 16
_WALK_LIST_BYTES = 4 * (2 * KERNEL_TILE[0] * MAX_EXPAND + KERNEL_TILE[0] + 1)


def library_path() -> Path:
    """Where the built library lives: ``build/graph_scan-<hash>.so``."""
    return _build.library_path("graph_scan", _SOURCES)


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _build.build("graph_scan", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_scan_launch.argtypes = (
        [i] + [p] * 10 + [i] + [p] * 8 + [i] * 9 + [ctypes.c_float, p])
    lib.graph_scan_launch.restype = i
    lib.graph_walk_launch.argtypes = (
        [i] + [p] * 9 + [i] + [p] * 9 + [i] * 10 + [ctypes.c_float] * 2 + [p])
    lib.graph_walk_launch.restype = i
    lib.graph_scan_smem_bytes.argtypes = [i] * 5
    lib.graph_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_shapes(step_offs, qcodes, q_rot, qscales, top0_sq, top0_ids, vis0,
                  adj_codes, adj_rot, bscales, eps, *, ef, thresh_col,
                  block_q, block_c, block_d):
    qn, dim = q_rot.shape
    n_adj = adj_rot.shape[0]
    s_count = dim // block_d
    if not 0 <= thresh_col < ef:
        raise ValueError(f"thresh_col must be in [0, ef), got {thresh_col}")
    if qn % block_q or n_adj % block_c or dim % block_d:
        raise ValueError(f"shapes must be padded: Q={qn}%{block_q}, "
                         f"N={n_adj}%{block_c}, D={dim}%{block_d}")
    if adj_codes.dtype != torch.int8 or qcodes.dtype != torch.int8:
        raise ValueError("codes must be int8")
    if eps.shape[0] != s_count or bscales.shape[0] != s_count:
        raise ValueError(f"table/scales must have {s_count} block steps")
    if qscales.shape != (qn, s_count):
        raise ValueError(f"qscales is {tuple(qscales.shape)}, need ({qn}, {s_count})")
    if not 1 <= ef <= 128:
        raise ValueError(f"ef must be in [1, 128], got {ef}")
    if top0_sq.shape != (qn, ef) or top0_ids.shape != (qn, ef):
        raise ValueError(f"beam window is {tuple(top0_sq.shape)}/"
                         f"{tuple(top0_ids.shape)}, need ({qn}, {ef})")
    q_tiles = qn // block_q
    if step_offs.dim() != 2 or step_offs.shape[0] != q_tiles:
        raise ValueError(f"step_offs is {tuple(step_offs.shape)}, need "
                         f"({q_tiles}, steps)")
    if vis0.dim() != 2 or vis0.shape[0] != q_tiles or vis0.dtype != torch.int32:
        raise ValueError(f"visited bitmap is {tuple(vis0.shape)} {vis0.dtype}, "
                         f"need ({q_tiles}, words) int32")


def graph_scan_kernel_call(
    step_offs: torch.Tensor,  # (q_tiles, steps) int per-step tile offsets
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    top0_sq: torch.Tensor,  # (Q, EF) f32 beam window carried across waves
    top0_ids: torch.Tensor,  # (Q, EF) int32
    r0_sq: torch.Tensor,  # (Q,) f32 thresholds carried across waves
    vis0: torch.Tensor,  # (q_tiles, W) int32 packed visited bitmap carried in
    adj_codes: torch.Tensor,  # (N_adj, D) int8 adjacency-flat
    adj_rot: torch.Tensor,  # (N_adj, D) f32 or bf16 adjacency-flat
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32 blocked table
    scale: torch.Tensor,  # (S,) f32
    vis_base: int = 0,  # global node id of local tile 0
    *,
    ef: int,
    thresh_col: int | None = None,
    block_q: int = KERNEL_TILE[0],
    block_c: int = KERNEL_TILE[1],
    block_d: int = 128,
    slack: float = 1e-4,
    tighten: bool = True,
):
    """Launch one beam-scan wave on pre-padded inputs (the wrapper
    ``ops.graph_scan_kernel`` owns padding, quantization and the bitmap's
    sizing).  ``tighten=False`` freezes the screen threshold at ``r0_sq``
    for the whole launch.

    Returns (top_sq (Q, EF) f32 ascending, top_ids (Q, EF) int32, stats
    (Q, 6) f32 — see ``STATS_COLS``, vis (q_tiles, W) int32).  Every launch
    of the CUDA kernel adds one to ``graph_scan_kernel_call.launches``; the
    CPU path does not.
    """
    if thresh_col is None:
        thresh_col = ef - 1
    _check_shapes(step_offs, qcodes, q_rot, qscales, top0_sq, top0_ids, vis0,
                  adj_codes, adj_rot, bscales, eps, ef=ef, thresh_col=thresh_col,
                  block_q=block_q, block_c=block_c, block_d=block_d)
    tensors = (step_offs, qcodes, q_rot, qscales, top0_sq, top0_ids, r0_sq, vis0,
               adj_codes, adj_rot, adj_ids, bscales, eps, scale)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"graph_scan inputs span devices {sorted(map(str, devices))}")
    (dev,) = devices
    kw = dict(ef=ef, thresh_col=thresh_col, block_q=block_q, block_c=block_c,
              block_d=block_d, slack=slack, tighten=tighten)
    if dev.type == "cpu":
        return graph_scan_ref(*tensors, int(vis_base), **kw)
    if dev.type != "cuda":
        raise ValueError(f"graph_scan runs on cuda or cpu tensors, got {dev}")
    return _launch(*tensors, int(vis_base), **kw)


graph_scan_kernel_call.launches = 0


def _launch(step_offs, qcodes, q_rot, qscales, top0_sq, top0_ids, r0_sq, vis0,
            adj_codes, adj_rot, adj_ids, bscales, eps, scale, vis_base, *, ef,
            thresh_col, block_q, block_c, block_d, slack, tighten):
    qn, dim = q_rot.shape
    if (block_q, block_c) != KERNEL_TILE:
        raise ValueError(f"the CUDA kernel runs (block_q, block_c) = {KERNEL_TILE} "
                         f"tiles (8 queries by one 32-row neighbour block), got "
                         f"({block_q}, {block_c})")
    if block_d % 32:
        raise ValueError(f"the CUDA kernel's int8 products run 32 dims at a time: "
                         f"block_d={block_d} must be a multiple of 32")
    if adj_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adj_rot must be float32 or bfloat16, got {adj_rot.dtype}")
    lib = _lib()
    smem = lib.graph_scan_smem_bytes(dim, dim // block_d, ef, block_d,
                                     adj_rot.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"graph_scan needs {smem} B of shared memory per block "
                         f"at these shapes; the card offers {MAX_SMEM_BYTES}")
    q_tiles, words = vis0.shape
    ins = dict(
        offs=step_offs.to(torch.int32).contiguous(),
        qcodes=qcodes.contiguous(), q=q_rot.float().contiguous(),
        qscales=qscales.float().contiguous(), r0=r0_sq.float().contiguous(),
        top0_sq=top0_sq.float().contiguous(),
        top0_ids=top0_ids.to(torch.int32).contiguous(),
        vis0=vis0.contiguous(), codes=adj_codes.contiguous(),
        rows=adj_rot.contiguous(), ids=adj_ids.to(torch.int32).contiguous(),
        bscales=bscales.float().contiguous(), eps=eps.float().contiguous(),
        scale=scale.float().contiguous())
    for name in ("codes", "rows", "ids"):
        if ins[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for cp.async")
    top_sq = torch.empty((qn, ef), dtype=torch.float32, device=q_rot.device)
    top_ids = torch.empty((qn, ef), dtype=torch.int32, device=q_rot.device)
    stats = torch.empty((qn, len(STATS_COLS)), dtype=torch.float32,
                        device=q_rot.device)
    vis = torch.empty_like(ins["vis0"])
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    err = lib.graph_scan_launch(
        q_rot.device.index or 0, ins["offs"].data_ptr(), ins["qcodes"].data_ptr(),
        ins["q"].data_ptr(), ins["qscales"].data_ptr(), ins["r0"].data_ptr(),
        ins["top0_sq"].data_ptr(), ins["top0_ids"].data_ptr(),
        ins["vis0"].data_ptr(), ins["codes"].data_ptr(), ins["rows"].data_ptr(),
        int(ins["rows"].dtype == torch.bfloat16), ins["ids"].data_ptr(),
        ins["bscales"].data_ptr(), ins["eps"].data_ptr(), ins["scale"].data_ptr(),
        top_sq.data_ptr(), top_ids.data_ptr(), stats.data_ptr(), vis.data_ptr(),
        q_tiles, ins["offs"].shape[1], dim, ef, block_d, thresh_col, int(tighten),
        words, vis_base, float(1.0 - slack), stream)
    if err != 0:
        raise RuntimeError(f"graph_scan launch failed: cudaError {err}")
    graph_scan_kernel_call.launches += 1
    return top_sq, top_ids, stats, vis


def graph_walk_kernel_call(
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    top0_sq: torch.Tensor,  # (Q, EF) f32 seeded window
    top0_ids: torch.Tensor,  # (Q, EF) int32
    seed_sq: torch.Tensor,  # (Q,) f32 threshold floor (inf: none, 0: pad rows)
    vis0: torch.Tensor,  # (q_tiles, W) int32 packed visited bitmap
    adj_codes: torch.Tensor,  # (N_adj, D) int8 adjacency-flat
    adj_rot: torch.Tensor,  # (N_adj, D) f32 or bf16 adjacency-flat
    adj_ids: torch.Tensor,  # (N_adj,) int32, -1 per-block padding
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32 blocked table
    scale: torch.Tensor,  # (S,) f32
    *,
    entry: int,
    qn: int,
    ef: int,
    thresh_col: int,
    expand: int,
    max_waves: int,
    route_mult: float = 1.0,
    block_q: int = KERNEL_TILE[0],
    block_c: int = KERNEL_TILE[1],
    block_d: int = 128,
    slack: float = 1e-4,
):
    """The whole single-shard beam walk on pre-padded inputs (the wrapper
    ``ops.graph_walk_inputs`` owns padding, quantization and the bitmap's
    sizing): ``ref.graph_walk_ref``'s contract, in one launch on CUDA
    tensors.

    Returns (top_sq (Q, EF) f32 ascending, top_ids (Q, EF) int32, stats
    (max_waves, Q, 6) f32 — each wave's ``STATS_COLS``, zero after a tile's
    last wave, vis (q_tiles, W) int32, waves (q_tiles,) int32 — the waves
    each tile ran).  Every launch of the CUDA kernel adds one to
    ``graph_walk_kernel_call.launches``; the CPU path does not.
    """
    step0 = torch.zeros((q_rot.shape[0] // block_q, 1), dtype=torch.int32)
    _check_shapes(step0, qcodes, q_rot, qscales, top0_sq, top0_ids, vis0,
                  adj_codes, adj_rot, bscales, eps, ef=ef, thresh_col=thresh_col,
                  block_q=block_q, block_c=block_c, block_d=block_d)
    if not 0 <= entry < adj_rot.shape[0] // block_c:
        raise ValueError(f"entry {entry} is not a node of the adjacency slab")
    if not 0 <= qn <= q_rot.shape[0] or max_waves < 0 or expand < 1:
        raise ValueError(f"need 0 <= qn <= Q, max_waves >= 0, expand >= 1; got "
                         f"qn={qn} max_waves={max_waves} expand={expand}")
    tensors = (qcodes, q_rot, qscales, top0_sq, top0_ids, seed_sq, vis0,
               adj_codes, adj_rot, adj_ids, bscales, eps, scale)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"graph_walk inputs span devices {sorted(map(str, devices))}")
    (dev,) = devices
    kw = dict(entry=int(entry), qn=int(qn), ef=ef, thresh_col=thresh_col,
              expand=expand, max_waves=max_waves, route_mult=float(route_mult),
              block_q=block_q, block_c=block_c, block_d=block_d, slack=slack)
    if dev.type == "cpu":
        return graph_walk_ref(*tensors, **kw)
    if dev.type != "cuda":
        raise ValueError(f"graph_walk runs on cuda or cpu tensors, got {dev}")
    return _launch_walk(*tensors, **kw)


graph_walk_kernel_call.launches = 0


def _launch_walk(qcodes, q_rot, qscales, top0_sq, top0_ids, seed_sq, vis0,
                 adj_codes, adj_rot, adj_ids, bscales, eps, scale, *, entry, qn,
                 ef, thresh_col, expand, max_waves, route_mult, block_q, block_c,
                 block_d, slack):
    qp, dim = q_rot.shape
    if (block_q, block_c) != KERNEL_TILE:
        raise ValueError(f"the CUDA kernel runs (block_q, block_c) = {KERNEL_TILE} "
                         f"tiles (8 queries by one 32-row neighbour block), got "
                         f"({block_q}, {block_c})")
    if block_d % 32:
        raise ValueError(f"the CUDA kernel's int8 products run 32 dims at a time: "
                         f"block_d={block_d} must be a multiple of 32")
    if expand > MAX_EXPAND:
        raise ValueError(f"the CUDA walk holds expand <= {MAX_EXPAND}, got {expand}")
    if adj_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adj_rot must be float32 or bfloat16, got {adj_rot.dtype}")
    lib = _lib()
    smem = lib.graph_scan_smem_bytes(dim, dim // block_d, ef, block_d,
                                     adj_rot.element_size())
    if smem + _WALK_LIST_BYTES > MAX_SMEM_BYTES:
        raise ValueError(f"graph_walk needs {smem} B of shared memory per block "
                         f"at these shapes; the card offers {MAX_SMEM_BYTES}")
    q_tiles, words = vis0.shape
    ins = dict(
        qcodes=qcodes.contiguous(), q=q_rot.float().contiguous(),
        qscales=qscales.float().contiguous(), seed=seed_sq.float().contiguous(),
        top0_sq=top0_sq.float().contiguous(),
        top0_ids=top0_ids.to(torch.int32).contiguous(),
        vis0=vis0.to(torch.int32).contiguous(), codes=adj_codes.contiguous(),
        rows=adj_rot.contiguous(), ids=adj_ids.to(torch.int32).contiguous(),
        bscales=bscales.float().contiguous(), eps=eps.float().contiguous(),
        scale=scale.float().contiguous())
    for name in ("codes", "rows", "ids"):
        if ins[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for cp.async")
    out = dict(
        top_sq=torch.empty((qp, ef), dtype=torch.float32, device=q_rot.device),
        top_ids=torch.empty((qp, ef), dtype=torch.int32, device=q_rot.device),
        stats=torch.empty((max_waves, qp, len(STATS_COLS)), dtype=torch.float32,
                          device=q_rot.device),
        vis=torch.empty_like(ins["vis0"]),
        waves=torch.empty((q_tiles,), dtype=torch.int32, device=q_rot.device))
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    err = lib.graph_walk_launch(
        q_rot.device.index or 0, *(ins[n].data_ptr() for n in (
            "qcodes", "q", "qscales", "seed", "top0_sq", "top0_ids", "vis0",
            "codes", "rows")),
        int(ins["rows"].dtype == torch.bfloat16),
        *(t.data_ptr() for t in (ins["ids"], ins["bscales"], ins["eps"], ins["scale"],
                                 out["top_sq"], out["top_ids"], out["stats"],
                                 out["vis"], out["waves"])),
        q_tiles, qn, dim, ef, block_d, thresh_col, words, entry, expand, max_waves,
        float(route_mult), float(1.0 - slack), stream)
    if err != 0:
        raise RuntimeError(f"graph_walk launch failed: cudaError {err}")
    graph_walk_kernel_call.launches += 1
    return out["top_sq"], out["top_ids"], out["stats"], out["vis"], out["waves"]
