"""Collectives of multi-device serving and training (the port of
``repro.distributed.collectives``, over ``torch.distributed``).

  * ``all_gather``, ``broadcast``, ``all_reduce``, ``send`` / ``recv`` —
    the group's calls on tensors where they live, each counted by an open
    ``launch.op_census`` census under XLA's kind names (its output bytes;
    a send / recv pair once, at the sender).  A gloo group moves
    host memory only (handed a CUDA tensor, its transport fails), so over
    gloo a CUDA tensor is copied to the host, sent, and copied back:
    ``staged`` says when that happens, and the serving report names it.
  * ``hierarchical_topk`` — the tree merge of per-rank top-k windows:
    all-gather along each mesh dimension in turn and re-select k after each
    hop, so a hop carries (Q, K) per rank, not the whole mesh's windows;
  * ``quantize_int8`` / ``dequantize_int8`` — the per-tensor int8 codec;
  * ``compressed_grad_allreduce`` — the int8 error-feedback all-reduce of
    ``--grad-compress`` (1-bit-Adam-family): each rank quantizes its
    ``g + e`` to int8 with a per-tensor scale, the int32 sum of the codes
    and the mean of the scales cross the group, and the quantization
    residual stays on the rank as the next step's ``e``;
  * ``gather_sharded`` / ``gather_sharded_many`` — the full tensors of
    which each rank holds the pieces ``distributed.sharding`` specs name
    (the ZeRO parameter all-gather of the data-parallel train step, and a
    checkpoint's gather), the latter packing every leaf split over one
    mesh axis into one all-gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_axis_sizes
from repro_torch.kernels.ivf_scan import merge_windows
from repro_torch.launch.op_census import report_collective

__all__ = ["Stripes", "group_size", "quantize_int8", "dequantize_int8", "staged", "all_gather",
           "broadcast",
           "all_reduce", "send", "recv", "hierarchical_topk", "compressed_grad_allreduce",
           "gather_sharded", "gather_sharded_many"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes of ``x`` and their scale.  Every
    division is a true one on either device: on the card a Python-number
    divisor becomes a product by its reciprocal, so divisors are tensors."""
    scale = torch.max(torch.abs(x.float())) / _divisor(127.0, x) + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def _divisor(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class Stripes(tuple):
    """One set of ranks' process group opened several times.  Given as the
    ``group`` of :func:`all_gather` or :func:`all_reduce`, a 1-D buffer is
    cut into one slice per group and the slices' collectives run at once,
    their transfers overlapping: with four, gloo moves about twice the
    bytes a second that one group moves.  Every rank of the default group
    builds it (``of``), in the same order."""

    @classmethod
    def of(cls, group=None, n: int = 4) -> "Stripes":
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        return cls(dist.new_group(ranks) for _ in range(n))


def _one(group):
    """A plain group for ``group`` (the first of :class:`Stripes`)."""
    return group[0] if isinstance(group, Stripes) else group


def group_size(group=None) -> int:
    """The ranks in ``group``; 1 without a process group (one process)."""
    return dist.get_world_size(_one(group)) if dist.is_initialized() else 1


def _striped(x: torch.Tensor, group) -> bool:
    return isinstance(group, Stripes) and x.dim() == 1 and x.is_contiguous()


def staged(x: torch.Tensor, group=None) -> bool:
    """True when ``group``'s calls on ``x`` go through the host: a CUDA
    tensor on a gloo group."""
    return x.device.type == "cuda" and dist.get_backend(_one(group)) == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group sends it: contiguous, bf16 as its int16 bits."""
    x = x.contiguous()
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(A, *x.shape): every rank's ``x`` in ``group``, in group-rank order,
    on ``x``'s device."""
    host = staged(x, group)
    src = x.contiguous().cpu() if host else x.contiguous()
    n = group_size(group)
    g = torch.empty((n, *src.shape), dtype=src.dtype, device=src.device)
    if _striped(src, group):  # each slice's collective writes into its columns of g
        works, at = [], 0
        for part, grp in zip(src.chunk(len(group)), group):
            outs = [g[a, at:at + part.numel()] for a in range(n)]
            works.append(dist.all_gather(outs, part, group=grp, async_op=True))
            at += part.numel()
        for w in works:
            w.wait()
    else:
        dist.all_gather(list(g.unbind(0)), src, group=_one(group))
    report_collective("all-gather", g.numel() * g.element_size())
    return g.to(x.device) if host else g


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` replaced by rank ``src``'s, in place; returns ``x``."""
    report_collective("collective-broadcast", x.numel() * x.element_size())
    if staged(x, group):
        h = x.cpu()
        dist.broadcast(h, src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src, group=group)
    return x


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op``, in place; returns ``x``."""
    report_collective("all-reduce", x.numel() * x.element_size())
    host = staged(x, group)
    h = x.cpu() if host else x
    if _striped(h, group):
        for w in [dist.all_reduce(p, op=op, group=g, async_op=True)
                  for p, g in zip(h.chunk(len(group)), group)]:
            w.wait()
    else:
        dist.all_reduce(h, op=op, group=_one(group))
    if host:
        x.copy_(h)
    return x


def send(x: torch.Tensor, dst: int) -> None:
    report_collective("collective-permute", x.numel() * x.element_size())
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


def compressed_grad_allreduce(grads: dict, error_buf: dict, group=None) -> tuple[dict, dict]:
    """The reference's int8 error-feedback all-reduce over ``group``, op
    for op: per leaf ``g + e`` in float32, its int8 codes and scale
    (``quantize_int8``), ``new_e = (g + e) - dequant`` kept on the rank, the
    codes summed as int32 and the scales averaged over the group, and
    ``summed * mean_scale / n``.  Returns ({name: mean gradient},
    {name: new error feedback}), float32.

    Called, as in the reference's ``--grad-compress`` step, on the reduced
    gradient every rank holds alike, so each rank's codes are equal and the
    sum is n x them.  All leaves' codes travel in one int32 all-reduce and
    their scales in one float32 all-reduce (elementwise sums: the packing
    changes no value).  Without a process group (one process) n is 1."""
    n = group_size(group)
    codes, scales, new_e = [], [], {}
    for name, g in grads.items():
        g = g.float() + error_buf[name]
        q, scale = quantize_int8(g)
        new_e[name] = g - dequantize_int8(q, scale)
        codes.append(q.reshape(-1).to(torch.int32))
        scales.append(scale.reshape(1))
    summed, scale_sum = torch.cat(codes), torch.cat(scales)
    if n > 1:
        all_reduce(summed, group=group)
        all_reduce(scale_sum, group=group)
    n_t = _divisor(float(n), summed)
    mean_scale = scale_sum / n_t
    mean, at = {}, 0
    for i, (name, g) in enumerate(grads.items()):
        part = summed[at:at + g.numel()].reshape(g.shape)
        mean[name] = part.float() * mean_scale[i] / n_t
        at += g.numel()
    return mean, new_e


def gather_sharded(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor of which ``local`` is this rank's piece under ``spec``
    over ``mesh`` (a ``DeviceMesh``; ``sharding.local_slice`` cuts the
    pieces): along each sharded dimension, an all-gather over each of its
    mesh axes, the innermost first, concatenated in group-rank order.
    bfloat16 crosses as its bytes (gloo's all-gather takes no 16-bit
    integers), the last dimension doubled.  Every rank of the mesh calls
    it."""
    sizes = mesh_axis_sizes(mesh)
    bits = local.dtype == torch.bfloat16
    x = local.contiguous().view(torch.uint8) if bits else local
    for dim, part in enumerate(spec):
        for name in reversed(part or ()):
            if sizes[name] > 1:
                x = torch.cat(tuple(all_gather(x, mesh.get_group(name))), dim=dim)
    return x.view(torch.bfloat16) if bits else x


def gather_sharded_many(pieces: list, specs: list, mesh, groups: dict | None = None) -> list:
    """:func:`gather_sharded` of each of ``pieces`` under ``specs[i]``, with
    one all-gather for all the leaves split along one dimension over one
    mesh axis: their bytes packed into one buffer (each rank's pieces of a
    leaf have one shape), the gathered buffer cut back into leaves and each
    leaf's pieces concatenated in group-rank order.  Any other split is
    gathered leaf by leaf; an unsplit leaf is returned as it is.
    ``groups`` ({mesh axis: group or :class:`Stripes`}) replaces the mesh's
    own group of an axis for the packed all-gather."""
    sizes = mesh_axis_sizes(mesh)
    out = list(pieces)
    packed: dict = {}  # mesh axis -> [(leaf index, its split dimension)]
    for i, spec in enumerate(specs):
        split = [(dim, nm) for dim, part in enumerate(spec) for nm in (part or ())
                 if sizes[nm] > 1]
        if len(split) == 1:
            packed.setdefault(split[0][1], []).append((i, split[0][0]))
        elif split:
            out[i] = gather_sharded(pieces[i], spec, mesh)
    for name, leaves in packed.items():
        raw = [pieces[i].contiguous().reshape(-1).view(torch.uint8) for i, _ in leaves]
        group = (groups or {}).get(name) or mesh.get_group(name)
        got = all_gather(torch.cat(raw), group)  # (A, total bytes)
        at = 0
        for (i, dim), r in zip(leaves, raw):
            p = pieces[i]
            parts = [got[a, at:at + r.numel()].view(p.dtype).reshape(p.shape)
                     for a in range(got.shape[0])]
            out[i] = torch.cat(parts, dim=dim)
            at += r.numel()
    return out
