"""Step functions for every (arch x shape) cell: train, prefill, decode.

The port of ``repro.launch.steps``: ``build_cell`` returns the model, its
step function with the model bound and meta-device arguments.  The
reference's mesh, ``in_shardings`` and per-shape rule overrides are
TPU-mesh placement; on one card the model carries no sharding annotations
(the reference's ``constrain`` is a no-op when no rules are active).  The
multi-device half of training (sharded parameters and optimizer state)
is ROADMAP queue 1 item 8b-ii.

The train step takes and returns the reference's (params, opt_state,
batch) -> (params, opt_state, metrics), with ``params`` the model's
parameter names -> tensors; it updates the parameters and the moments IN
PLACE and returns the same tensors (``optim.adamw``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.specs import cell_is_runnable, input_specs
from repro_torch.models.model import LM, build_model, reference_ndims
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["Cell", "build_cell", "train_grads", "train_step", "prefill_step", "serve_step"]


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


def train_grads(model: LM, batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, {name: gradient}) of ``batch`` (arrays or tensors:
    ``tokens``, ``labels``, + ``frames`` / ``vision``) with respect to the
    model's parameters (their gradients turned on).

    With ``cfg.grad_accum`` = ga > 1 the batch splits along its rows into ga
    microbatches, one backward pass each, whose gradients (in the
    parameter dtype) are summed into float32 buffers and divided by ga; the
    loss is the microbatches' mean and the other loss metrics are the last
    microbatch's, as in the reference's scan.  With ga = 1 the gradients
    stay in the parameter dtype (``adamw_update`` takes them in float32)."""
    own = dict(model.named_parameters())
    names = list(own)
    plist = [own[n].requires_grad_(True) for n in names]
    dev = model.device
    batch = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(dev)
             for k, v in batch.items()}

    def grads_of(b):
        loss, mets = model.loss_fn(b)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, [
            torch.zeros_like(p) if g is None else g for p, g in zip(plist, gs)]

    ga = max(model.cfg.grad_accum, 1)
    if ga == 1:
        loss, mets, gs = grads_of(batch)
        return loss, mets, dict(zip(names, gs))
    rows = batch["tokens"].shape[0]
    if rows % ga:
        raise ValueError(f"batch of {rows} rows does not split into {ga} microbatches")
    mb = rows // ga
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev) for n, p in own.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(ga):
        loss_i, mets, gs = grads_of({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        for n, g in zip(names, gs):
            grads[n].add_(g)  # x + y.astype(f32)
        lsum = lsum + loss_i
        del gs  # this microbatch's gradients go before the next one's backward
    for g in grads.values():
        g.div_(ga)
    return lsum / ga, mets, grads


def train_step(model: LM, opt: AdamWConfig, params: dict, opt_state: dict, batch: dict):
    """One AdamW step on ``batch`` -> (params, opt_state, metrics: loss,
    nll, aux, grad_norm, lr); gradients as :func:`train_grads` takes them.
    ``params`` are the model's parameter names -> tensors (its own, or a
    restored checkpoint's, which the model then computes with:
    ``LM.bind_params``)."""
    model.bind_params(params)
    if dict(model.named_parameters()).keys() != params.keys():
        raise ValueError("params must name every parameter of the model")
    loss, mets, grads = train_grads(model, batch)
    params, opt_state, om = adamw_update(opt, params, grads, opt_state,
                                         ndims=reference_ndims(params))
    return params, opt_state, {"loss": loss, **mets, **om}


def prefill_step(model: LM, batch: dict[str, torch.Tensor]):
    """(last-position logits, caches) of a prompt batch."""
    return model.prefill(batch)


def serve_step(model: LM, token: torch.Tensor, caches: dict, pos):
    """One new token against ``caches`` (updated in place) at ``pos``."""
    return model.decode_step(token, caches, pos)


def build_cell(arch_id: str, shape: str, *, device="cuda", cfgset: dict | None = None,
               opt: AdamWConfig | None = None) -> Cell:
    """The cell's model (seed 0, on ``device``; ``"meta"`` for shapes only),
    its step function with the model bound, and its arguments' specs (a
    train cell's: parameters, optimizer state, batch; its model's
    parameters take gradients)."""
    cfg = get_config(arch_id)
    if cfgset:
        cfg = dataclasses.replace(cfg, **cfgset)
    spec, bspecs = input_specs(cfg, shape)
    ok, why = cell_is_runnable(cfg, shape)
    model = build_model(cfg, device=device)
    if spec.kind == "train":
        model.requires_grad_(True)
        shapes = dict(build_model(cfg, device="meta").named_parameters())
        return Cell(arch_id, shape, spec.kind,
                    functools.partial(train_step, model, opt or AdamWConfig()),
                    (shapes, adamw_init(shapes), bspecs), model, ok, why)
    if spec.kind == "prefill":
        return Cell(arch_id, shape, spec.kind, functools.partial(prefill_step, model),
                    (bspecs,), model, ok, why)
    b = spec.global_batch
    caches = build_model(cfg, device="meta").init_caches(b, spec.seq)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return Cell(arch_id, shape, spec.kind, functools.partial(serve_step, model),
                (token, caches, pos), model, ok, why)
