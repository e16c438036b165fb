"""Fused IVF wave scan: build, binding and launch of the CUDA kernel.

``ivf_scan_kernel_call`` is the port of the Pallas kernel
``repro.kernels.ivf_scan.ivf_scan_kernel_call``.  It runs where its tensors
live: on CUDA tensors it launches the hand-written kernel in
``csrc/ivf_scan.cu`` (``sm_90a``); on CPU tensors it runs the plain oracle
``ref.ivf_scan_ref``.  There is no fallback between the two: a CUDA call
that cannot launch raises.

``segments=G`` cuts the step table into G contiguous wave-aligned runs,
walks each from the same r0 with an empty window (one CTA per (segment,
query tile), all in the one launch, or all in the one plain call) and
merges the G windows as the reference's ``hierarchical_topk`` does on a
G-shard mesh: the (Q, G·K) concatenation in segment order, ascending, ties
to the lower position; the counters sum over segments.

The kernel is built at first use with ``nvcc`` (``_build``) into
``build/`` beside this file, keyed by a hash of its sources and flags, and
bound with ``ctypes``.  A timing build of the same walk
(``csrc/ivf_scan_clocks.cu``), which only :func:`ivf_scan_phase_clocks`
loads, stamps each phase of a step with the SM's clock.  Nothing
CUDA-specific happens at import time.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import STATS_COLS, ivf_scan_ref

__all__ = ["ivf_scan_kernel_call", "ivf_scan_plain", "ivf_scan_phase_clocks", "build",
           "build_clocks", "library_path", "split_segments", "merge_segments",
           "merge_windows",
           "smem_bytes",
           "STATS_COLS", "PHASES", "MAX_SMEM_BYTES", "KERNEL_TILE",
           "KERNEL_BLOCK_QS"]

_SOURCES = ("ivf_scan.cu", "scan_walk.cuh", "tiles.cuh")
_CLOCK_SOURCES = ("ivf_scan_clocks.cu",) + _SOURCES
# The phases the timing build stamps, in the order of its side buffer
# (scan_walk.cuh's Phase list).
PHASES = ("tile_wait", "stage1_first", "stage1_rest", "slab_wait", "stage2",
          "dup_scan", "merge", "other")
# Query-tile widths the CUDA kernel holds (1 or 2 m16n8k32 n-tiles per
# warp), each by 128 candidates (16 per warp); the plain version takes any
# tile.  KERNEL_TILE is the flat serving route's (16 queries: the fastest
# width at the serving shape on an H100, two CTAs to an SM); 8 is the IVF
# search's, whose probe routing is per query tile.
KERNEL_BLOCK_QS = (8, 16)
KERNEL_TILE = (16, 128)
# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def library_path() -> Path:
    """Where the built library lives: ``build/ivf_scan-<hash>.so``, the hash
    covering the sources and the compiler flags."""
    return _build.library_path("ivf_scan", _SOURCES)


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _build.build("ivf_scan", _SOURCES)


def build_clocks() -> tuple[Path, str]:
    """Compile the timing build if its library is missing (as :func:`build`)."""
    return _build.build("ivf_scan_clocks", _CLOCK_SOURCES)


@functools.cache
def _lib(clocks: bool = False) -> ctypes.CDLL:
    path, _ = build_clocks() if clocks else build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ivf_scan_launch.argtypes = [i] + [p] * 8 + [p, i] + [p] * 8 + [i] * 6 + [
        ctypes.c_float, p]
    lib.ivf_scan_launch.restype = i
    lib.ivf_scan_smem_bytes.argtypes = [i] * 6
    lib.ivf_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(*, dim: int, block_d: int, k: int, row_bytes: int, block_q: int) -> int:
    """Dynamic shared memory one CTA of the CUDA kernel needs (bytes)."""
    return _lib().ivf_scan_smem_bytes(dim, dim // block_d, k, block_d, row_bytes, block_q)


def _check_shapes(tile_offs, qcodes, q_rot, qscales, flat_codes, flat_rot,
                  bscales, eps, *, k, block_q, block_c, block_d, cap_tiles):
    qn, dim = q_rot.shape
    n_pad = flat_rot.shape[0]
    s_count = dim // block_d
    if qn % block_q or n_pad % block_c or dim % block_d:
        raise ValueError(f"shapes must be padded: Q={qn}%{block_q}, "
                         f"N={n_pad}%{block_c}, D={dim}%{block_d}")
    if flat_codes.dtype != torch.int8 or qcodes.dtype != torch.int8:
        raise ValueError("codes must be int8")
    if eps.shape[0] != s_count or bscales.shape[0] != s_count:
        raise ValueError(f"table/scales must have {s_count} block steps")
    if qscales.shape != (qn, s_count):
        raise ValueError(f"qscales is {tuple(qscales.shape)}, need ({qn}, {s_count})")
    if not 1 <= k <= 128:
        raise ValueError(f"k must be in [1, 128], got {k}")
    q_tiles = qn // block_q
    if tile_offs.dim() != 3 or (tile_offs.shape[0], tile_offs.shape[2]) != (q_tiles, cap_tiles):
        raise ValueError(f"tile_offs is {tuple(tile_offs.shape)}, need "
                         f"({q_tiles}, P, {cap_tiles})")


def split_segments(tile_offs: torch.Tensor, segments: int) -> torch.Tensor:
    """(q_tiles, P, cap) step table -> (segments * q_tiles, ceil(P / G),
    cap): segment g walks waves [g·L, (g+1)·L) of every query tile (the
    last run padded with -1 gap waves), row g·q_tiles + t."""
    q_tiles, waves, cap = tile_offs.shape
    per = -(-waves // segments)
    pad = per * segments - waves
    offs = torch.cat([tile_offs, tile_offs.new_full((q_tiles, pad, cap), -1)], 1)
    return offs.reshape(q_tiles, segments, per, cap).transpose(0, 1).reshape(
        segments * q_tiles, per, cap)


def merge_windows(g_sq, g_ids, k: int):
    """(A, Q, K') windows -> (Q, k): the (Q, A·K') concatenation in window
    order sorted ascending, ties to the lower position (``lax.top_k``'s
    order), cut to k.  One rule for the segments of a launch and for the
    ranks of a mesh (``distributed.collectives.hierarchical_topk``)."""
    a, qn, kk = g_sq.shape
    sq = g_sq.transpose(0, 1).reshape(qn, a * kk)
    ids = g_ids.transpose(0, 1).reshape(qn, a * kk)
    sq, order = torch.sort(sq, dim=1, stable=True)
    return sq[:, :k].contiguous(), torch.gather(ids, 1, order[:, :k])


def merge_segments(top_sq, top_ids, stats, segments: int, k: int):
    """The windows of ``segments`` walks ((G·Q, K), segment-major) merged as
    the reference's ``hierarchical_topk`` (:func:`merge_windows`); the
    counters summed over segments (in float64, then rounded once)."""
    qn = top_sq.shape[0] // segments
    sq, ids = merge_windows(top_sq.reshape(segments, qn, k),
                            top_ids.reshape(segments, qn, k), k)
    st = stats.reshape(segments, qn, -1).double().sum(0).float()
    return sq, ids, st


def ivf_scan_kernel_call(
    tile_offs: torch.Tensor,  # (q_tiles, P, cap_tiles) int per-step offsets
    qcodes: torch.Tensor,  # (Q, D) int8
    q_rot: torch.Tensor,  # (Q, D) f32
    qscales: torch.Tensor,  # (Q, S) f32
    r0_sq: torch.Tensor,  # (Q,) f32
    top0_sq: torch.Tensor,  # (Q, K) f32 seeded window (inf = empty)
    top0_ids: torch.Tensor,  # (Q, K) int32 seeded ids (-1 = empty)
    flat_codes: torch.Tensor,  # (N_pad, D) int8 cluster-contiguous
    flat_rot: torch.Tensor,  # (N_pad, D) f32 or bf16
    flat_ids: torch.Tensor,  # (N_pad,) int32, -1 tail padding
    bscales: torch.Tensor,  # (S,) f32
    eps: torch.Tensor,  # (S,) f32 blocked table
    scale: torch.Tensor,  # (S,) f32
    *,
    k: int,
    block_d: int,
    block_q: int = KERNEL_TILE[0],
    block_c: int = KERNEL_TILE[1],
    cap_tiles: int = 1,
    slack: float = 1e-4,
    segments: int = 1,
):
    """Run the fused IVF wave scan on pre-padded inputs, its step table
    walked as ``segments`` runs (see the module docstring; 1 = one walk).

    Returns (top_sq (Q, K) f32 ascending, top_ids (Q, K) int32, stats
    (Q, 6) f32 — see ``STATS_COLS``).  Every launch of the CUDA kernel adds
    one to ``ivf_scan_kernel_call.launches``; the CPU path does not.
    """
    return _run(tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
                flat_codes, flat_rot, flat_ids, bscales, eps, scale, k=k,
                block_d=block_d, block_q=block_q, block_c=block_c,
                cap_tiles=cap_tiles, slack=slack, segments=segments, engine="kernel")


ivf_scan_kernel_call.launches = 0


def ivf_scan_plain(*args, **kwargs):
    """:func:`ivf_scan_kernel_call`'s plain version on tensors of any device:
    ``ref.ivf_scan_ref`` with the same segment split and merge."""
    return _run(*args, engine="plain", **kwargs)


def ivf_scan_phase_clocks(*args, **kwargs):
    """:func:`ivf_scan_kernel_call` through the timing build, on CUDA
    tensors; returns its three outputs and the (segments·q_tiles, 8) int64
    cycles each CTA spent in each of ``PHASES``.  Not counted as a launch."""
    return _run(*args, engine="clocks", **kwargs)


def _run(tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
         flat_codes, flat_rot, flat_ids, bscales, eps, scale, *, k, block_d,
         block_q=KERNEL_TILE[0], block_c=KERNEL_TILE[1], cap_tiles=1,
         slack=1e-4, segments=1, engine):
    _check_shapes(tile_offs, qcodes, q_rot, qscales, flat_codes, flat_rot,
                  bscales, eps, k=k, block_q=block_q, block_c=block_c,
                  block_d=block_d, cap_tiles=cap_tiles)
    tensors = (tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
               flat_codes, flat_rot, flat_ids, bscales, eps, scale)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ivf_scan inputs span devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu") or (engine == "clocks" and dev.type != "cuda"):
        raise ValueError(f"ivf_scan runs on cuda or cpu tensors (its timing "
                         f"build on cuda), got {dev}")
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if segments > 1:
        if bool((top0_ids >= 0).any()):
            raise ValueError("a split walk starts every segment from an empty "
                             "window: top0 must be empty (inf, -1)")
        rep = lambda t: t.repeat((segments,) + (1,) * (t.dim() - 1))  # noqa: E731
        tensors = (split_segments(tile_offs, segments), *map(rep, tensors[1:7]),
                   *tensors[7:])
    kw = dict(k=k, block_q=block_q, block_c=block_c, block_d=block_d,
              cap_tiles=cap_tiles, slack=slack)
    if dev.type == "cpu" or engine == "plain":
        out = ivf_scan_ref(*tensors, **kw)
    else:
        out = _launch(*tensors, clocks=engine == "clocks", **kw)
    if segments > 1:
        out = merge_segments(*out[:3], segments, k) + tuple(out[3:])
    return out


def _launch(tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
            flat_codes, flat_rot, flat_ids, bscales, eps, scale, *, k,
            block_q, block_c, block_d, cap_tiles, slack, clocks):
    qn, dim = q_rot.shape
    if block_q not in KERNEL_BLOCK_QS or block_c != KERNEL_TILE[1]:
        raise ValueError(f"the CUDA kernel runs query tiles of {KERNEL_BLOCK_QS} "
                         f"by {KERNEL_TILE[1]} candidates (m16n8k32 products), "
                         f"got ({block_q}, {block_c})")
    if block_d % 32:
        raise ValueError(f"the CUDA kernel's int8 products run 32 dims at a time: "
                         f"block_d={block_d} must be a multiple of 32")
    if flat_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flat_rot must be float32 or bfloat16, got {flat_rot.dtype}")
    lib = _lib(clocks)
    smem = smem_bytes(dim=dim, block_d=block_d, k=k, row_bytes=flat_rot.element_size(),
                      block_q=block_q)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ivf_scan needs {smem} B of shared memory per block "
                         f"at these shapes; the card offers {MAX_SMEM_BYTES}")
    q_tiles = qn // block_q
    offs = tile_offs.to(torch.int32).reshape(q_tiles, -1).contiguous()
    ins = dict(
        qcodes=qcodes.contiguous(), q=q_rot.float().contiguous(),
        qscales=qscales.float().contiguous(), r0=r0_sq.float().contiguous(),
        top0_sq=top0_sq.float().contiguous(),
        top0_ids=top0_ids.to(torch.int32).contiguous(),
        codes=flat_codes.contiguous(), rows=flat_rot.contiguous(),
        ids=flat_ids.to(torch.int32).contiguous(),
        bscales=bscales.float().contiguous(), eps=eps.float().contiguous(),
        scale=scale.float().contiguous())
    for name in ("qcodes", "codes", "rows", "ids"):
        if ins[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for cp.async")
    top_sq = torch.empty((qn, k), dtype=torch.float32, device=q_rot.device)
    top_ids = torch.empty((qn, k), dtype=torch.int32, device=q_rot.device)
    stats = torch.empty((qn, len(STATS_COLS)), dtype=torch.float32,
                        device=q_rot.device)
    clk = (torch.zeros((q_tiles, len(PHASES)), dtype=torch.int64, device=q_rot.device)
           if clocks else None)
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    err = lib.ivf_scan_launch(
        q_rot.device.index or 0, offs.data_ptr(), ins["qcodes"].data_ptr(),
        ins["q"].data_ptr(), ins["qscales"].data_ptr(), ins["r0"].data_ptr(),
        ins["top0_sq"].data_ptr(), ins["top0_ids"].data_ptr(),
        ins["codes"].data_ptr(), ins["rows"].data_ptr(),
        int(ins["rows"].dtype == torch.bfloat16), ins["ids"].data_ptr(),
        ins["bscales"].data_ptr(), ins["eps"].data_ptr(), ins["scale"].data_ptr(),
        top_sq.data_ptr(), top_ids.data_ptr(), stats.data_ptr(),
        None if clk is None else clk.data_ptr(),
        q_tiles, offs.shape[1], dim, k, block_d, block_q, float(1.0 - slack), stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan launch failed: cudaError {err}")
    if clocks:
        return top_sq, top_ids, stats, clk
    ivf_scan_kernel_call.launches += 1
    return top_sq, top_ids, stats
