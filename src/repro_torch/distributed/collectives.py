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
  * ``AxisComm`` and ``gather_along`` / ``reduce_scatter_along`` /
    ``reduce_all`` / ``split_along`` — the tensor-parallel collectives over
    one mesh axis, each a ``torch.autograd.Function`` (below);
  * ``gather_sharded`` / ``gather_sharded_many`` — the full tensors of
    which each rank holds the pieces ``distributed.sharding`` specs name
    (the ZeRO parameter all-gather of the data-parallel train step, and a
    checkpoint's gather), the latter packing every leaf split over one
    mesh axis into one all-gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

import collections
import contextlib
import itertools
import math
import time

from repro_torch.distributed.sharding import RankView, mesh_axis_sizes
from repro_torch.kernels.ivf_scan import merge_windows
from repro_torch.launch.op_census import report_collective

__all__ = ["AxisComm", "Traffic", "axis_classes", "axis_groups", "mesh_built", "gather_along",
           "reduce_scatter_along", "reduce_all", "split_along", "Stripes", "group_size",
           "quantize_int8", "dequantize_int8", "staged", "all_gather", "broadcast",
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
    builds it (``over``), in the same order."""

    @classmethod
    def over(cls, mesh, axes, n: int = 4) -> "Stripes":
        """This rank's group over mesh dimensions ``axes`` (one name, or
        several taken as one), opened ``n`` times.  Every rank of the
        default group opens every group of those dimensions, in the same
        order (``new_group`` is collective), and keeps its own; once per
        mesh object (:func:`mesh_built`)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)

        def build():
            me, mine = dist.get_rank(), None
            for row in axis_classes(mesh, axes):
                groups = [dist.new_group(row) for _ in range(n)]
                if me in row:
                    mine = groups
            return cls(mine)

        return mesh_built(mesh, ("stripes", axes, n), build)


def mesh_built(mesh, key, build):
    """``build()``'s process groups for ``mesh`` under ``key``, built the
    first time and kept on the mesh object.  Every rank makes the same
    calls in the same order, so every rank builds, or finds, the same
    groups: a step made again over the same mesh opens no new group."""
    cache = mesh.__dict__.setdefault("_process_groups", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def axis_classes(mesh, axes) -> list:
    """The ranks of ``mesh`` (a ``DeviceMesh``) grouped by their coordinates
    off the mesh dimensions ``axes``: one list of global ranks per group,
    ordered along ``axes``, the first major (the order of
    :class:`AxisComm`'s ``index``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    ranks = mesh.mesh  # built once here: a DeviceMesh rebuilds it on every read
    order = [d for d in range(ranks.ndim) if d not in dims] + dims
    return ranks.permute(order).reshape(-1, math.prod(ranks.shape[d] for d in dims)).tolist()


def axis_groups(mesh) -> dict:
    """{frozenset of mesh axes: this rank's plain process group over them}
    for every set of two or more of ``mesh``'s axes of size > 1 (a single
    axis's group is the mesh's own, ``get_group``).  Every rank of the mesh
    builds every group, in the same order: ``new_group`` is collective over
    the default group, so they are built where the mesh's step is made,
    never inside a step, and once per mesh object (:func:`mesh_built`).
    (``DeviceMesh._flatten`` would build the same groups, but it is
    private and its group creation has changed between releases; plain
    ``new_group`` calls are the same on each.)"""

    def build():
        live = [nm for nm, n in mesh_axis_sizes(mesh).items() if n > 1]
        me, out = dist.get_rank(), {}
        for k in range(2, len(live) + 1):
            for axes in itertools.combinations(live, k):
                for row in axis_classes(mesh, axes):
                    group = dist.new_group(row)
                    if me in row:
                        out[frozenset(axes)] = group
        return out

    return mesh_built(mesh, "axis_groups", build)


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


# ---- tensor parallelism over one mesh axis ----------------------------------
#
# The gradient convention: a tensor that every rank of the axis holds whole
# (replicated) carries, on each rank, a PARTIAL gradient, whose sum over the
# ranks is its gradient; a tensor that the ranks hold in pieces carries its
# piece's gradient.  A loss is therefore a partial sum too (``models.model.
# LM.loss_fn``: terms computed alike on every rank count on one of them),
# and a parameter replicated over the axis sums its gradient over the axis
# (``launch.steps.DataParallel``).  Under it the four placements changes
# pair up as:
#
#   gather_along          pieces -> whole        backward: reduce-scatter
#   reduce_scatter_along  partial sums -> pieces  backward: all-gather
#   reduce_all            partial sums -> whole   backward: all-reduce
#   split_along           whole -> pieces         backward: zero-padded piece
#
# (Megatron's identity / all-reduce pair belongs to the other convention,
# in which a replicated tensor carries its whole gradient; there every
# place where a replicated tensor meets rank-distinct work needs an extra
# operator, and the MoE router, read by both kinds of work, would need its
# gradient split by hand.)


class Traffic:
    """What one rank's collectives carried, by kind: ``bytes`` (each one's
    own payload) and, with ``clock`` set, ``seconds`` (the host time from
    its start, the card synchronised first, to its end; without ``clock``
    nothing is synchronised and ``seconds`` stays empty)."""

    def __init__(self, clock: bool = False):
        self.clock = clock
        self.bytes: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.bytes.clear()
        self.seconds.clear()

    @contextlib.contextmanager
    def timed(self, kind: str, nbytes: int, device: torch.device):
        """Count one collective of ``kind`` carrying ``nbytes``."""
        self.bytes[kind] += nbytes
        if not self.clock:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds[kind] += time.perf_counter() - t0


class AxisComm:
    """Mesh axes ``names`` (one, or several taken as one: the first
    major) as this rank executes them: ``size`` ranks, this rank's
    ``index`` among them (its piece in ``sharding.local_slice``'s order)
    and their process group (None over a
    :class:`~repro_torch.distributed.sharding.RankView`: the collectives
    then return tensors of the shape they would, with nothing moved, for a
    dry run on ``device="meta"``).  Over several axes of size > 1 the group
    is the one ``groups`` (:func:`axis_groups` of the mesh, built when the
    step was made) holds for them; it may leave out ranks of the mesh (the
    ("model", "data") slots of a (pod, data, model) mesh: one group per
    pod).  A group orders its ranks by global rank, which may differ from
    ``index``'s order: :meth:`gather` puts the pieces in ``index`` order.
    Each collective is counted in ``traffic`` (a :class:`Traffic`, or None)
    under its kind prefixed by the axes' ``name`` ("model all-gather",
    "model+data+pod all-reduce"), and by a census open around the step
    (``op_census.report_collective``)."""

    def __init__(self, mesh, names, traffic: Traffic | None = None,
                 groups: dict | None = None):
        names = (names,) if isinstance(names, str) else tuple(names)
        sizes = mesh_axis_sizes(mesh)
        coord = dict(zip(sizes, mesh.get_coordinate()))
        self.mesh, self.name, self.traffic = mesh, "+".join(names), traffic
        self.size, self.index = 1, 0
        for nm in names:
            self.size *= sizes[nm]
            self.index = self.index * sizes[nm] + coord[nm]
        self.order = None  # group rank -> index, where they differ
        live = [nm for nm in names if sizes[nm] > 1]
        if isinstance(mesh, RankView):
            self.group = None
        elif len(live) <= 1:
            self.group = mesh.get_group(live[0] if live else names[0])
        else:
            self.group = (groups or {}).get(frozenset(live))
            if self.group is None:
                raise ValueError(f"no process group over {live}: build the mesh's groups "
                                 f"with collectives.axis_groups where the step is made")
            row = next(r for r in axis_classes(mesh, names) if dist.get_rank() in r)
            if row != sorted(row):
                self.order = [row.index(r) for r in sorted(row)]

    def _timed(self, kind: str, nbytes: int, device: torch.device):
        if self.traffic is None:
            return contextlib.nullcontext()
        return self.traffic.timed(f"{self.name} {kind}", nbytes, device)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's piece, concatenated along ``dim`` in rank order.
        bfloat16 crosses as its bytes (gloo has no 16-bit all-gather)."""
        shape = list(x.shape)
        shape[dim] *= self.size
        nbytes = x.numel() * x.element_size() * self.size
        if self.group is None:
            report_collective("all-gather", nbytes)
            return x.new_empty(shape)
        bits = x.dtype == torch.bfloat16
        w = x.contiguous().view(torch.uint8) if bits else x.contiguous()
        with self._timed("all-gather", nbytes, x.device):
            g = all_gather(w, self.group)
        pieces = list(g.unbind(0))
        if self.order is not None:
            for at, i in enumerate(self.order):
                pieces[i] = g[at]
        out = torch.cat(pieces, dim=dim)
        return out.view(torch.bfloat16) if bits else out

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in float32 (a new tensor in
        ``x``'s dtype)."""
        nbytes = x.numel() * 4
        if self.group is None:
            report_collective("all-reduce", nbytes)
            return x.new_empty(x.shape)
        w = x.float().contiguous() if x.dtype != torch.float32 else x.clone()
        with self._timed("all-reduce", nbytes, x.device):
            all_reduce(w, group=self.group)
        return w.to(x.dtype)

    def maximum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's ``x`` (no gradient)."""
        nbytes = x.numel() * 4
        if self.group is None:
            report_collective("all-reduce", nbytes)
            return x.detach()
        w = x.detach().float().clone()
        with self._timed("all-reduce", nbytes, x.device):
            all_reduce(w, op=dist.ReduceOp.MAX, group=self.group)
        return w.to(x.dtype)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece along ``dim`` of the sum of every rank's ``x``:
        an all-reduce, then the piece (gloo has no reduce-scatter of its
        own, so the bytes counted are the all-reduce's)."""
        return self.piece(self.reduce(x), dim)

    def piece(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of ``x`` along ``dim`` (a copy, contiguous)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} {self.name!r} ranks")
        size = n // self.size
        return x.narrow(dim, self.index * size, size).contiguous()

    def pad(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` as this rank's piece along ``dim`` of a tensor that is zero
        elsewhere."""
        shape = list(x.shape)
        shape[dim] *= self.size
        out = x.new_zeros(shape)
        out.narrow(dim, self.index * x.shape[dim], x.shape[dim]).copy_(x)
        return out


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return comm.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return comm.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.gather(g, ctx.dim), None, None


class _ReduceAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce(g), None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return comm.piece(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.pad(g, ctx.dim), None, None


def gather_along(x: torch.Tensor, dim: int, comm: AxisComm) -> torch.Tensor:
    """The whole tensor of which each rank of ``comm`` holds the piece
    ``x`` along ``dim``; backward: the reduce-scatter of the partial
    gradients."""
    return _GatherAlong.apply(x, dim, comm)


def reduce_scatter_along(x: torch.Tensor, dim: int, comm: AxisComm) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum of the ranks' partial
    sums ``x``; backward: the all-gather of the pieces' gradients."""
    return _ReduceScatterAlong.apply(x, dim, comm)


def reduce_all(x: torch.Tensor, comm: AxisComm) -> torch.Tensor:
    """The sum of the ranks' partial sums ``x``, on every rank; backward:
    the all-reduce of the partial gradients (each rank's ``x`` is its own
    and takes the whole gradient)."""
    return _ReduceAll.apply(x, comm)


def split_along(x: torch.Tensor, dim: int, comm: AxisComm) -> torch.Tensor:
    """This rank's piece along ``dim`` of the whole tensor ``x``; backward:
    the piece's gradient, zero elsewhere (a partial gradient)."""
    return _SplitAlong.apply(x, dim, comm)
