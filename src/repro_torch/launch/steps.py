"""Step functions for every (arch x shape) cell: train, prefill, decode.

The port of ``repro.launch.steps``: ``build_cell`` returns the model, its
step function with the model bound, meta-device arguments and, given a
mesh, the reference's ``in_shardings`` (each leaf a
``distributed.sharding.Sharding``) under the per-shape ``RULE_OVERRIDES``.

Over a ``DeviceMesh`` of ("pod", "data", "model") ranks (the
reference's ``make_host_mesh(data=D, model=M)``, or its multi-pod layout
with a "pod" axis) the steps execute the reference's partition
(:class:`DataParallel`): each rank holds its piece of every parameter and
of both AdamW moments as the shardings assign it (``embed_fsdp``
dimensions split over "data": the reference's ZeRO layout, replicated
over "pod"; ``qkv``, ``ffn``, ``vocab``, ``inner`` ... over "model"),
gathers its model pieces whole along "data" into the model, runs
``loss_fn`` under ``use_rules(mesh)`` on its rows of each microbatch (the
batch over "pod" x "data"; the model executes the "model" axis:
``distributed.sharding.constrain``), sums the gradients over the ranks
that took other rows (and over the model ranks for a leaf the model axis
replicates: its gradient there is a partial sum) and updates its own
pieces, clipping by the norm of the whole summed gradient.
Prefill and decode run under the same rules on the rank's rows, the
model holding its model pieces (gathered along "data" once).  Over an
``AbstractMesh`` only the shardings are derived.

The train step takes and returns the reference's (params, opt_state,
batch) -> (params, opt_state, metrics), with ``params`` the model's
parameter names -> tensors (a rank's pieces, over a mesh); it updates the
parameters and the moments IN PLACE and returns the same tensors
(``optim.adamw``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import microbatch_rows
from repro_torch.distributed.collectives import (Stripes, Traffic, all_reduce, axis_groups,
                                                 compressed_grad_allreduce, gather_sharded_many)
from repro_torch.distributed.sharding import (MODEL_AXIS, AbstractMesh, local_slice,
                                              make_rules, mesh_axis_sizes, rules_in,
                                              tree_shardings)
from repro_torch.launch.specs import cell_is_runnable, input_specs
from repro_torch.models.common import DataShare
from repro_torch.models.model import LM, build_model, reference_leaves, reference_ndims
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                     opt_state_axes)

__all__ = ["Cell", "DataParallel", "RULE_OVERRIDES", "build_cell", "train_grads",
           "train_step", "compress_grads", "prefill_step", "serve_step", "dp_rows",
           "row_split", "bind_model_pieces", "model_specs"]

# Per-shape logical-rule overrides (the reference's).
RULE_OVERRIDES: dict[str, dict] = {
    # 500k-token caches: batch=1, so spread the cache seq over every axis.
    "long_500k": {"kv_seq": ("model", "data", "pod")},
}


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape: str
    kind: str  # train | prefill | decode
    step_fn: Callable
    args: tuple  # meta-device tensors (shapes and dtypes of the step's inputs)
    model: LM
    runnable: bool = True
    skip_reason: str = ""
    # Given a mesh: the reference's in_shardings, in its argument order
    # (train: params, opt_state, batch; prefill: params, batch; decode:
    # params, token, caches, pos) and decode's out_shardings (logits, caches).
    in_shardings: tuple | None = None
    out_shardings: tuple | None = None
    data_parallel: "DataParallel | None" = None


def _only(spec: tuple, axis: str) -> tuple:
    """``spec`` with only its ``axis`` entries."""
    return tuple(tuple(nm for nm in ((part,) if isinstance(part, str) else (part or ()))
                       if nm == axis) or None for part in spec)


class DataParallel:
    """The (pod, data, model) placement of a step over ``mesh`` (a
    ``DeviceMesh`` with a "data" axis and, optionally, the rules' other
    batch axis "pod" and a "model" axis; an axis of size > 1 that is none
    of these is refused by name), for the parameters placed by
    ``shardings`` ({name: Sharding}, from ``tree_shardings`` of the model's
    logical axes under ``overrides``).  Given ``model`` and a model axis of
    size > 1, the model's parameters become this rank's model pieces
    (whole along "data" and "pod"): from then on the model computes only
    under :meth:`rules`.

    A batch of B rows with ``grad_accum`` ga splits over the batch's mesh
    axes (the rules' ``batch``: "pod", then "data") as far as the
    reference's prefix rule takes them: the longest prefix whose product n
    divides every microbatch (:meth:`split`; at ga 1 exactly the
    reference's ``Rules.resolve``).  Rank ``index`` (pod-major: ``pod x
    data_size + data``) takes its contiguous part of each microbatch
    (``data.pipeline.microbatch_rows``) and the gradients sum over those n
    ranks; where nothing divides, every rank computes the whole batch and
    nothing is summed (the reference replicates such a batch).  The
    parameters and moments are split over "data" only (``embed_fsdp``), so
    the parameter all-gather runs along "data" and every pod computes the
    same update of its (equal) pieces: "pod" is pure data parallelism.
    ``size`` and ``index`` are the whole batch axes' (a batch that splits
    over all of them).

    Every process group a step uses is built here, once, by every rank in
    the same order: the plain groups of each set of axes
    (``collectives.axis_groups``) and the striped groups of the large
    collectives.  ``traffic`` (a ``collectives.Traffic``) counts, by kind,
    what each collective of this rank carried, the kinds prefixed by the
    mesh axes they ran over ("pod+data gradient all-reduce", "model
    all-gather"), and with ``traffic.clock`` set the host time each
    took."""

    def __init__(self, mesh, shardings: dict, model: LM | None = None,
                 overrides: dict | None = None):
        sizes = mesh_axis_sizes(mesh)
        rules = make_rules(mesh, overrides)
        self.batch_axes = tuple(nm for nm in rules.table["batch"] if nm in sizes)
        known = set(self.batch_axes) | {"data", MODEL_AXIS}
        unknown = [k for k, n in sizes.items() if n > 1 and k not in known]
        if "data" not in sizes or unknown:
            raise ValueError(f"a step over a mesh needs a 'data' axis and no axis of size > 1 "
                             f"but the batch's {self.batch_axes} and {MODEL_AXIS!r}; "
                             f"{unknown or ['data']} cannot be expressed (mesh {sizes})")
        self.mesh, self.shardings, self.overrides = mesh, shardings, overrides
        self.sizes = sizes
        self.coord = dict(zip(sizes, mesh.get_coordinate()))
        self.model_size = sizes.get(MODEL_AXIS, 1)
        self.size, self.index = 1, 0
        for nm in self.batch_axes:
            self.size, self.index = self.size * sizes[nm], self.index * sizes[nm] + self.coord[nm]
        self.groups = axis_groups(mesh)
        # the large collectives (parameters, gradients, codes) run striped:
        # the parameters along "data", the gradients over each prefix of the
        # batch's axes, with the model axis too for a leaf it replicates
        self._stripes: dict = {}
        for axes in [("data",)] + [self.batch_axes[:i] + extra
                                   for i in range(len(self.batch_axes) + 1)
                                   for extra in ((), (MODEL_AXIS,))]:
            live = self._live(axes)
            if live and live not in self._stripes:
                self._stripes[live] = Stripes.over(mesh, live)
        # the group of --grad-compress: every rank of the batch's axes
        self.stripes = self._stripes.get(self._live(self.batch_axes)) or mesh.get_group("data")
        self.share = DataShare(self.size, functools.partial(self._sum_counts, self.batch_axes))
        self.traffic = Traffic()
        self._rules = make_rules(mesh, overrides, self.traffic, self.groups)
        self.data_specs = {k: _only(sh.spec, "data") for k, sh in shardings.items()}
        self.model_specs = model_specs(shardings)
        self.model_split = {k for k, sp in self.model_specs.items()
                            if self.model_size > 1 and any(sp)}
        if model is not None and self.model_size > 1:
            bind_model_pieces(model, self.model_specs, self.mesh)

    def _live(self, axes) -> tuple:
        """The axes of ``axes`` of size > 1."""
        return tuple(nm for nm in axes if self.sizes.get(nm, 1) > 1)

    def _group(self, axes):
        """The plain process group over the mesh axes ``axes`` (None: no
        axis of size > 1)."""
        live = self._live(axes)
        if len(live) > 1:
            return self.groups[frozenset(live)]
        return self.mesh.get_group(live[0]) if live else None

    def rules(self, rows: tuple = ()):
        """The rules the model computes under (over the mesh, counting
        into ``traffic``), one object for the step's life; ``rows``: the
        mesh axes the batch rows split over (:meth:`split`), which the
        placement of new decode caches reads (``sharding.cache_split``:
        :meth:`init_caches`)."""
        rules = self._rules
        if rows:
            rules = dataclasses.replace(rules, rows=tuple(rows), comms=rules.comms)
        return rules_in(rules)

    def split(self, rows: int, ga: int = 1) -> tuple[int, int, tuple]:
        """:func:`row_split` of a batch of ``rows`` rows in ``ga``
        microbatches over this rank's mesh."""
        return row_split(self.sizes, self.batch_axes, rows, ga, self.coord)

    def splits(self, rows: int, ga: int) -> bool:
        """Whether a batch of ``rows`` rows in ``ga`` microbatches is split
        over the batch's ranks."""
        return self.split(rows, ga)[0] > 1

    def share_of(self, axes: tuple) -> DataShare:
        """The ``DataShare`` of a batch split over the mesh axes ``axes``:
        :attr:`share` where they hold every batch rank."""
        n = math.prod(self.sizes[nm] for nm in axes)
        if n == self.size:
            return self.share
        return DataShare(n, functools.partial(self._sum_counts, axes))

    def local(self, tree: dict) -> dict:
        """This rank's piece (a view) of each full tensor of ``tree``."""
        return {k: local_slice(v, self.shardings[k].spec, self.mesh) for k, v in tree.items()}

    def local_data(self, tree: dict) -> dict:
        """This rank's "data" piece (a view) of each tensor of ``tree`` that
        is whole along "data" (the model's own parameters and gradients)."""
        return {k: local_slice(v, self.data_specs[k], self.mesh) for k, v in tree.items()}

    def local_params(self, model: LM) -> dict:
        """This rank's pieces of the model's parameters, copies of their own."""
        own = dict(model.named_parameters())
        pieces = self.local_data(own) if self.model_size > 1 else self.local(own)
        return {k: v.detach().clone() for k, v in pieces.items()}

    def init_caches(self, model: LM, rows: int, cache_len: int) -> dict:
        """This rank's pieces of zeroed decode caches for a batch of
        ``rows`` rows (its rows of them, as :func:`serve_step` takes
        them), placed as the reference places a global batch's."""
        n, _, axes = self.split(rows)
        with self.rules(axes):
            return model.init_caches(rows // n, cache_len)[0]

    @torch.no_grad()
    def gather_into(self, params: dict, model: LM) -> None:
        """The model pieces, gathered along "data" from every data rank's
        pieces ``params``, written into the model's own parameters."""
        own = dict(model.named_parameters())
        names = list(params)
        nbytes = sum(params[k].numel() * params[k].element_size() for k in names
                     if self.sizes["data"] > 1 and any(self.data_specs[k]))
        with self.traffic.timed("data param all-gather", nbytes, model.device):
            full = gather_sharded_many([params[k] for k in names],
                                       [self.data_specs[k] for k in names], self.mesh,
                                       groups={"data": self._stripes.get(("data",))})
        for k, t in zip(names, full):
            own[k].copy_(t)

    def sum(self, tensors: dict, kind: str, axes: tuple = (), model_too=()) -> dict:
        """Each tensor summed over the ranks of the mesh axes ``axes`` (those
        the batch split over) in its dtype (float32 where the dtypes
        differ), and those named in ``model_too`` (all of them: ``True``)
        over the model ranks as well: one all-reduce of each set packed
        into one buffer, counted as "<axes joined by '+'> <kind>"."""
        every = set(tensors) if model_too is True else set(model_too)
        if self.model_size == 1:
            every = set()
        out = {}
        for names, over in (([k for k in tensors if k not in every], tuple(axes)),
                            ([k for k in tensors if k in every], tuple(axes) + (MODEL_AXIS,))):
            live = self._live(over)
            if not names or not live:
                out.update({k: tensors[k] for k in names})
                continue
            dtypes = {tensors[k].dtype for k in names}
            dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
            flat = torch.cat([tensors[k].to(dtype).reshape(-1) for k in names])
            nbytes = flat.numel() * flat.element_size()
            with self.traffic.timed(f"{'+'.join(live)} {kind}", nbytes, flat.device):
                all_reduce(flat, group=self._stripes[live])
            at = 0
            for k in names:
                t = tensors[k]
                out[k] = flat[at:at + t.numel()].reshape(t.shape)
                at += t.numel()
        return {k: out[k] for k in tensors}

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model ranks (one float32 all-reduce)."""
        if self.model_size == 1:
            return x
        with self.traffic.timed("model grad-norm all-reduce", 4, x.device):
            return all_reduce(x.float().clone(), group=self.mesh.get_group(MODEL_AXIS))

    def _sum_counts(self, axes: tuple, counts: torch.Tensor) -> torch.Tensor:
        """A MoE layer's expert counts summed over the ranks of ``axes``."""
        live = self._live(axes)
        with self.traffic.timed(f"{'+'.join(live)} moe counts all-reduce", counts.numel() * 4,
                                counts.device):
            return all_reduce(counts, group=self._group(live))

    def state_shardings(self, model: LM, ebuf: dict | None = None) -> tuple:
        """Shardings of the trainer's state (params, opt_state, ebuf): the
        moments as the parameters, the step and the error-feedback buffer
        replicated."""
        shapes = model._param_shapes
        opt = tree_shardings(opt_state_axes(model.param_axes()),
                             {"m": shapes, "v": shapes, "step": ()}, self.mesh, self.overrides)
        rep = None if ebuf is None else tree_shardings(
            {k: (None,) * v.ndim for k, v in ebuf.items()}, ebuf, self.mesh)
        return self.shardings, opt, rep


def row_split(sizes: dict, batch_axes: tuple, rows: int, ga: int = 1,
              coord: dict | None = None) -> tuple[int, int, tuple]:
    """(n, index, axes) of a batch of ``rows`` rows in ``ga`` microbatches
    over a mesh of axis ``sizes``: the longest prefix ``axes`` of the
    batch's mesh axes ``batch_axes`` whose product n divides every
    microbatch (at ga 1 the reference's ``Rules.resolve``), and the index
    among those n ranks of the rank at ``coord`` (default: coordinate 0),
    pod-major."""
    n, index, axes = 1, 0, ()
    for nm in batch_axes:
        k = sizes[nm]
        if rows % (ga * n * k):
            break
        n, index, axes = n * k, index * k + (coord or {}).get(nm, 0), axes + (nm,)
    return n, index, axes


def bind_model_pieces(model: LM, specs: dict, mesh) -> None:
    """Replace each of the model's parameters by this rank's piece of it
    under ``specs[name]`` over ``mesh`` (a ``DeviceMesh`` or a
    ``sharding.RankView``): a copy of its own."""
    for name, p in list(model.named_parameters()):
        piece = local_slice(p.detach(), specs[name], mesh).clone()
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        owner._parameters[leaf] = torch.nn.Parameter(piece, requires_grad=p.requires_grad)


def model_specs(shardings: dict) -> dict:
    """{name: the spec with only its model-axis entries} of ``shardings``:
    the pieces the model holds (whole along every other axis)."""
    return {k: _only(sh.spec, MODEL_AXIS) for k, sh in shardings.items()}


def _to_device(batch: dict, dev) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(dev)
            for k, v in batch.items()}


def train_grads(model: LM, batch: dict, dp: DataParallel | None = None
                ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, {name: gradient}) of ``batch`` (arrays or tensors:
    ``tokens``, ``labels``, + ``frames`` / ``vision``) with respect to the
    model's parameters (their gradients turned on).

    With ``cfg.grad_accum`` = ga > 1 the batch splits along its rows into ga
    microbatches, one backward pass each, whose gradients (in the
    parameter dtype) are summed into float32 buffers and divided by ga; the
    loss is the microbatches' mean and the other loss metrics are the last
    microbatch's, as in the reference's scan.  With ga = 1 the gradients
    stay in the parameter dtype (``adamw_update`` takes them in float32).

    With ``dp`` splitting the batch, this rank computes its rows of each
    microbatch as its share (``LM.sharing``: the global token count, the
    MoE counts of every rank) and the gradients, loss and metrics are summed
    over the data ranks, every rank returning the global batch's (over a
    model axis, its model pieces of the gradients; the partial sums of the
    loss, the metrics and each model-replicated leaf's gradient summed over
    the model ranks as well): the
    gradients in their dtype (the parameters' at ga = 1, as the reference's
    reduction of its bf16 gradients; the float32 accumulators at ga > 1),
    the loss and metrics in float32."""
    own = dict(model.named_parameters())
    names = list(own)
    plist = [own[n].requires_grad_(True) for n in names]
    dev = model.device
    batch = _to_device(batch, dev)
    ga = max(model.cfg.grad_accum, 1)
    rows = batch["tokens"].shape[0]
    if rows % ga:
        raise ValueError(f"batch of {rows} rows does not split into {ga} microbatches")
    n, index, axes = dp.split(rows, ga) if dp is not None else (1, 0, ())
    split = n > 1
    mbs = microbatch_rows(batch, ga, index, n) if split else microbatch_rows(batch, ga)

    def grads_of(b):
        loss, mets = model.loss_fn(b)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, [
            torch.zeros_like(p) if g is None else g for p, g in zip(plist, gs)]

    rules = dp.rules() if dp is not None else contextlib.nullcontext()
    with model.sharing(dp.share_of(axes) if split else None), rules:
        if ga == 1:
            loss, mets, gs = grads_of(mbs[0])
            grads = dict(zip(names, gs))
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in own.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in mbs:
                loss_i, mets, gs = grads_of(mb)
                for n, g in zip(names, gs):
                    grads[n].add_(g)  # x + y.astype(f32)
                lsum = lsum + loss_i
                del gs  # this microbatch's gradients go before the next one's backward
            loss = lsum
    if split or (dp is not None and dp.model_size > 1):
        grads = dp.sum(grads, "gradient all-reduce", axes,
                       model_too=[k for k in grads if k not in dp.model_split])
        scalars = dp.sum({"loss": loss, **mets}, "loss all-reduce", axes, model_too=True)
        loss, mets = scalars.pop("loss"), scalars
    if ga > 1:
        for g in grads.values():
            g.div_(ga)
        loss = loss / ga
    return loss, mets, grads


def _stacked(tree: dict, leaves: dict) -> dict:
    """``tree`` (the port's names) as the reference's leaves: each layer
    stack's tensors stacked along a leading axis."""
    return {key: tree[names[0]] if key == names[0] else torch.stack([tree[n] for n in names])
            for key, names in leaves.items()}


def _unstacked(tree: dict, leaves: dict) -> dict:
    """The inverse of :func:`_stacked`."""
    out = {}
    for key, names in leaves.items():
        if key == names[0]:
            out[key] = tree[key]
        else:
            out.update({n: t for n, t in zip(names, tree[key].unbind(0))})
    return out


def compress_grads(grads: dict, ebuf: dict, group=None) -> tuple[dict, dict]:
    """``compressed_grad_allreduce`` of ``grads`` with error feedback
    ``ebuf`` (both keyed by the port's parameter names) over ``group``, with
    one int8 scale per leaf of the reference's tree: a layer stack's
    gradients are quantized as one tensor (``models.model.
    reference_leaves``).  Returns (mean gradients, new error feedback)."""
    leaves = reference_leaves(grads)
    mean, new_e = compressed_grad_allreduce(_stacked(grads, leaves), _stacked(ebuf, leaves),
                                            group)
    return _unstacked(mean, leaves), _unstacked(new_e, leaves)


def train_step(model: LM, opt: AdamWConfig, params: dict, opt_state: dict, batch: dict, *,
               dp: DataParallel | None = None, ebuf: dict | None = None):
    """One AdamW step on ``batch`` -> (params, opt_state, metrics: loss,
    nll, aux, grad_norm, lr); gradients as :func:`train_grads` takes them.
    ``params`` are the model's parameter names -> tensors: its own, or a
    restored checkpoint's, which the model then computes with
    (``LM.bind_params``); with ``dp``, this rank's pieces, gathered into the
    model's parameters first, and the update writes only the pieces.

    ``ebuf`` ({name: float32 full-shape error feedback}, the same on every
    rank) turns on ``--grad-compress``: the summed gradient goes through
    ``compressed_grad_allreduce`` over the data ranks and ``ebuf`` takes
    its new residual, in place; the clip norm is then the compressed
    gradient's, as in the reference's trainer (:func:`compress_grads`)."""
    if dp is None:
        model.bind_params(params)
        if dict(model.named_parameters()).keys() != params.keys():
            raise ValueError("params must name every parameter of the model")
    else:
        dp.gather_into(params, model)
    loss, mets, grads = train_grads(model, batch, dp)
    if ebuf is not None:
        if dp is not None and dp.model_size > 1:
            raise ValueError("--grad-compress runs over a data mesh only (the reference's "
                             "trainer keeps model=1)")
        group = None if dp is None else dp.stripes
        codes = sum(g.numel() for g in grads.values()) * 4 + 4 * len(reference_leaves(grads))
        over = "" if dp is None else "+".join(dp._live(dp.batch_axes)) + " "
        with (dp.traffic.timed(f"{over}compressed all-reduce (int32 codes, scales)", codes,
                               model.device)
              if dp is not None else contextlib.nullcontext()):
            grads, new_e = compress_grads(grads, ebuf, group)
        for k, e in new_e.items():
            ebuf[k].copy_(e)
    if dp is not None and dp.model_size > 1:
        gnorm = global_norm(grads, split=dp.model_split, reduce=dp.model_sum)
        grads = dp.local_data(grads)
    else:
        gnorm = global_norm(grads)
        if dp is not None:
            grads = dp.local(grads)
    params, opt_state, om = adamw_update(opt, params, grads, opt_state,
                                         ndims=reference_ndims(params), grad_norm=gnorm)
    return params, opt_state, {"loss": loss, **mets, **om}


def prefill_step(model: LM, batch: dict[str, torch.Tensor], *, dp: DataParallel | None = None):
    """(last-position logits, caches) of a prompt batch; with ``dp``, of
    this rank's rows (where they split over the batch's ranks), its pieces of
    the logits (``vocab``) and of the caches as decode takes them."""
    if dp is None:
        return model.prefill(batch)
    with dp.rules():
        return model.prefill(dp_rows(dp, batch))


def serve_step(model: LM, token: torch.Tensor, caches: dict, pos, *,
               dp: DataParallel | None = None):
    """One new token against ``caches`` (updated in place) at ``pos``; with
    ``dp``, this rank's rows of ``token`` against its pieces of the caches
    (``dp.init_caches``)."""
    if dp is None:
        return model.decode_step(token, caches, pos)
    with dp.rules():
        return model.decode_step(dp_rows(dp, {"tokens": token})["tokens"], caches, pos)


def dp_rows(dp: DataParallel, batch: dict) -> dict:
    """This rank's rows of ``batch`` where they split over the batch's
    ranks (:meth:`DataParallel.split`; else the whole batch, as the
    reference replicates it)."""
    rows = batch["tokens"].shape[0]
    n, index, _ = dp.split(rows)
    if n == 1:
        return batch
    return {k: (v[index * (rows // n):(index + 1) * (rows // n)]
                if hasattr(v, "shape") and v.ndim and v.shape[0] == rows else v)
            for k, v in batch.items()}


def build_cell(arch_id: str, shape: str, *, mesh=None, device="cuda",
               cfgset: dict | None = None, opt: AdamWConfig | None = None,
               overrides: dict | None = None) -> Cell:
    """The cell's model (seed 0, on ``device``; ``"meta"`` for shapes only),
    its step function with the model bound, and its arguments' specs (a
    train cell's: parameters, optimizer state, batch; its model's
    parameters take gradients).  Given ``mesh`` (an ``AbstractMesh`` or a
    ``DeviceMesh``), the in_shardings under ``RULE_OVERRIDES`` for the
    shape plus ``overrides``; a cell over a ``DeviceMesh`` steps over its
    ranks (``cell.data_parallel``, which holds the model's model pieces:
    a train cell's initial state is ``data_parallel.local_params(
    cell.model)`` and ``adamw_init`` of it; a decode cell's caches are
    ``data_parallel.init_caches(cell.model, rows, cache_len)``)."""
    cfg = get_config(arch_id)
    if cfgset:
        cfg = dataclasses.replace(cfg, **cfgset)
    spec, bspecs, baxes = input_specs(cfg, shape)
    ok, why = cell_is_runnable(cfg, shape)
    rules = dict(RULE_OVERRIDES.get(shape, {}))
    if overrides:
        rules.update(overrides)
    model = build_model(cfg, device=device)
    meta = model if model.device.type == "meta" else build_model(cfg, device="meta")
    shapes = dict(meta.named_parameters())

    def shard(axes, shaped):
        return None if mesh is None else tree_shardings(axes, shaped, mesh, rules)

    param_sh, batch_sh = shard(meta.param_axes(), shapes), shard(baxes, bspecs)
    live = mesh is not None and not isinstance(mesh, AbstractMesh)
    if spec.kind == "train":
        model.requires_grad_(True)
        opt_shapes = adamw_init(shapes)
        dp = DataParallel(mesh, param_sh, model, rules) if live else None
        return Cell(arch_id, shape, spec.kind,
                    functools.partial(train_step, model, opt or AdamWConfig(), dp=dp),
                    (shapes, opt_shapes, bspecs), model, ok, why,
                    in_shardings=None if mesh is None else (
                        param_sh, shard(opt_state_axes(meta.param_axes()), opt_shapes),
                        batch_sh),
                    data_parallel=dp)
    dp = DataParallel(mesh, param_sh, model, rules) if live else None
    if spec.kind == "prefill":
        return Cell(arch_id, shape, spec.kind, functools.partial(prefill_step, model, dp=dp),
                    (bspecs,), model, ok, why,
                    in_shardings=None if mesh is None else (param_sh, batch_sh),
                    data_parallel=dp)
    b = spec.global_batch
    caches, cache_axes = meta.init_caches(b, spec.seq)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    cell = Cell(arch_id, shape, spec.kind, functools.partial(serve_step, model, dp=dp),
                (token, caches, pos), model, ok, why, data_parallel=dp)
    if mesh is not None:
        cache_sh = shard(cache_axes, caches)
        cell.in_shardings = (param_sh, shard(("batch", "seq"), token), cache_sh,
                             shard((), pos))
        cell.out_shardings = (shard(("batch", "vocab"), (b, cfg.vocab_padded)), cache_sh)
    return cell
