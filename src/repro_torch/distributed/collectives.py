"""Collectives of multi-device serving (the port of the serving part of
``repro.distributed.collectives``, over ``torch.distributed``).

  * ``all_gather``, ``broadcast``, ``all_reduce``, ``send`` / ``recv`` —
    the group's calls on tensors where they live.  A gloo group moves
    host memory only (handed a CUDA tensor, its transport fails), so over
    gloo a CUDA tensor is copied to the host, sent, and copied back:
    ``staged`` says when that happens, and the serving report names it.
  * ``hierarchical_topk`` — the tree merge of per-rank top-k windows:
    all-gather along each mesh dimension in turn and re-select k after each
    hop, so a hop carries (Q, K) per rank, not the whole mesh's windows;
  * ``quantize_int8`` / ``dequantize_int8`` — the per-tensor int8 codec of
    the reference's compressed gradient all-reduce.

The reference's ``compressed_grad_allreduce`` serves data-parallel
training, the multi-device half the port has not reached (ROADMAP queue 1
item 8b-ii).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.ivf_scan import merge_windows

__all__ = ["quantize_int8", "dequantize_int8", "staged", "all_gather", "broadcast",
           "all_reduce", "send", "recv", "hierarchical_topk"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes of ``x`` and their scale."""
    scale = torch.max(torch.abs(x.float())) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def staged(x: torch.Tensor, group=None) -> bool:
    """True when ``group``'s calls on ``x`` go through the host: a CUDA
    tensor on a gloo group."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group sends it: contiguous, bf16 as its int16 bits."""
    x = x.contiguous()
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(A, *x.shape): every rank's ``x`` in ``group``, in group-rank order,
    on ``x``'s device."""
    host = staged(x, group)
    src = x.contiguous().cpu() if host else x.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    g = torch.stack(out)
    return g.to(x.device) if host else g


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` replaced by rank ``src``'s, in place; returns ``x``."""
    if staged(x, group):
        h = x.cpu()
        dist.broadcast(h, src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src, group=group)
    return x


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op``, in place; returns ``x``."""
    if staged(x, group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def send(x: torch.Tensor, dst: int) -> None:
    w = _wire(x)
    dist.send(w.cpu() if staged(x) else w, dst)


def recv(x: torch.Tensor, src: int) -> torch.Tensor:
    """Receive into ``x`` (contiguous) from ``src``; returns ``x``."""
    w = _wire(x)
    if staged(x):
        h = torch.empty_like(w, device="cpu")
        dist.recv(h, src)
        w.copy_(h)
    else:
        dist.recv(w, src)
    return x


def hierarchical_topk(local_sq: torch.Tensor, local_ids: torch.Tensor, mesh, dims,
                      k: int):
    """Merge per-rank (Q, K) top-k windows (ascending squared distances and
    their global ids) along the mesh dimensions ``dims``, one at a time: each
    hop all-gathers the (A, Q, K) windows of the dimension's group and
    re-selects k with ``ivf_scan.merge_windows`` (ties to the lower rank,
    then the lower column), the rule the segments of one launch merge by.
    Every rank returns the same (Q, k) window."""
    sq, ids = local_sq, local_ids
    for d in dims:
        group = mesh.get_group(d)
        sq, ids = merge_windows(all_gather(sq, group), all_gather(ids, group), k)
    return sq, ids
