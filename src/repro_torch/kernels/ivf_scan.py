"""Fused IVF wave scan: build, binding and launch of the CUDA kernel.

``ivf_scan_kernel_call`` is the port of the Pallas kernel
``repro.kernels.ivf_scan.ivf_scan_kernel_call``.  It runs where its tensors
live: on CUDA tensors it launches the hand-written kernel in
``csrc/ivf_scan.cu`` (``sm_90a``); on CPU tensors it runs the plain oracle
``ref.ivf_scan_ref``.  There is no fallback between the two: a CUDA call
that cannot launch raises.

The kernel is built at first use with ``nvcc`` (``_build``) into
``build/`` beside this file, keyed by a hash of its sources and flags, and
bound with ``ctypes``.  Nothing CUDA-specific happens at import time.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import STATS_COLS, ivf_scan_ref

__all__ = ["ivf_scan_kernel_call", "build", "library_path", "STATS_COLS",
           "MAX_SMEM_BYTES", "KERNEL_TILE"]

_SOURCES = ("ivf_scan.cu", "scan_walk.cuh", "tiles.cuh")
# (block_q, block_c) of the CUDA kernel: 8 queries (the mma's n) by 128
# candidates (16 per warp); the plain version takes any tile.
KERNEL_TILE = (8, 128)
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


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ivf_scan_launch.argtypes = [i] + [p] * 8 + [p, i] + [p] * 7 + [i] * 5 + [
        ctypes.c_float, p]
    lib.ivf_scan_launch.restype = i
    lib.ivf_scan_smem_bytes.argtypes = [i] * 4
    lib.ivf_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


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
):
    """Run the fused IVF wave scan on pre-padded inputs.

    Returns (top_sq (Q, K) f32 ascending, top_ids (Q, K) int32, stats
    (Q, 6) f32 — see ``STATS_COLS``).  Every launch of the CUDA kernel adds
    one to ``ivf_scan_kernel_call.launches``; the CPU path does not.
    """
    _check_shapes(tile_offs, qcodes, q_rot, qscales, flat_codes, flat_rot,
                  bscales, eps, k=k, block_q=block_q, block_c=block_c,
                  block_d=block_d, cap_tiles=cap_tiles)
    tensors = (tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
               flat_codes, flat_rot, flat_ids, bscales, eps, scale)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ivf_scan inputs span devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return ivf_scan_ref(*tensors, k=k, block_q=block_q, block_c=block_c,
                            block_d=block_d, cap_tiles=cap_tiles, slack=slack)
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan runs on cuda or cpu tensors, got {dev}")
    return _launch(*tensors, k=k, block_q=block_q, block_c=block_c,
                   block_d=block_d, cap_tiles=cap_tiles, slack=slack)


ivf_scan_kernel_call.launches = 0


def _launch(tile_offs, qcodes, q_rot, qscales, r0_sq, top0_sq, top0_ids,
            flat_codes, flat_rot, flat_ids, bscales, eps, scale, *, k,
            block_q, block_c, block_d, cap_tiles, slack):
    qn, dim = q_rot.shape
    if (block_q, block_c) != KERNEL_TILE:
        raise ValueError(f"the CUDA kernel runs (block_q, block_c) = {KERNEL_TILE} "
                         f"tiles (one m16n8k32 product per warp), got "
                         f"({block_q}, {block_c})")
    if block_d % 32:
        raise ValueError(f"the CUDA kernel's int8 products run 32 dims at a time: "
                         f"block_d={block_d} must be a multiple of 32")
    if flat_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flat_rot must be float32 or bfloat16, got {flat_rot.dtype}")
    lib = _lib()
    smem = lib.ivf_scan_smem_bytes(dim, dim // block_d, k, block_d)
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
    for name in ("qcodes", "codes"):
        if ins[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for cp.async")
    top_sq = torch.empty((qn, k), dtype=torch.float32, device=q_rot.device)
    top_ids = torch.empty((qn, k), dtype=torch.int32, device=q_rot.device)
    stats = torch.empty((qn, len(STATS_COLS)), dtype=torch.float32,
                        device=q_rot.device)
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    err = lib.ivf_scan_launch(
        q_rot.device.index or 0, offs.data_ptr(), ins["qcodes"].data_ptr(),
        ins["q"].data_ptr(), ins["qscales"].data_ptr(), ins["r0"].data_ptr(),
        ins["top0_sq"].data_ptr(), ins["top0_ids"].data_ptr(),
        ins["codes"].data_ptr(), ins["rows"].data_ptr(),
        int(ins["rows"].dtype == torch.bfloat16), ins["ids"].data_ptr(),
        ins["bscales"].data_ptr(), ins["eps"].data_ptr(), ins["scale"].data_ptr(),
        top_sq.data_ptr(), top_ids.data_ptr(), stats.data_ptr(),
        q_tiles, offs.shape[1], dim, k, block_d, float(1.0 - slack), stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan launch failed: cudaError {err}")
    ivf_scan_kernel_call.launches += 1
    return top_sq, top_ids, stats
