"""AdamW with decoupled weight decay, global-norm clipping and float32
moments (the port of ``repro.optim.adamw``).

Trees are flat dicts of tensors keyed by the port's parameter names
(``LM.named_parameters()``); the state is ``{"m": {...}, "v": {...},
"step": 0-d int32}``, so checkpoints treat it like any other tree.  The
arithmetic is the reference's, in float32, op for op.

Two departures, both in what is stored, not in what is computed:

  * ``adamw_update`` writes the parameters and the moments IN PLACE
    (under ``torch.no_grad()``) and returns the same tensors, as
    ``LM.decode_step`` does with its caches: a copy of 2.5 B parameters
    and their moments every step would cost more than the step.
  * The reference skips weight decay on a leaf of ndim < 2
    (``p.ndim >= 2``), and its leaves inside the layer stacks carry a
    leading 'layers' axis: every norm weight, bias, ``A_log``, ``D`` and
    ``dt_bias`` there is decayed, while ``final_norm`` and ``enc_norm``
    and the hybrid's unstacked shared block are not.  The port unrolls
    that axis, so the rule reads the reference's ndim from ``ndims``
    (:func:`repro_torch.models.model.reference_ndims` for an ``LM``), not
    from the tensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "schedule", "global_norm", "adamw_init", "adamw_update",
           "opt_state_axes"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: dict, *, split=(), reduce=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared float32 values.  Over a
    partitioned tree, the leaves named in ``split`` are this rank's pieces:
    their squares are summed by ``reduce`` (the sum over the ranks that
    hold the other pieces), and every other leaf, whole on each rank, is
    counted once."""
    total = 0
    pieces = torch.zeros((), dtype=torch.float32,
                         device=next(iter(tree.values())).device if tree else None)
    for name, leaf in tree.items():
        sq = torch.sum(torch.square(leaf.float()))
        if name in split:
            pieces = pieces + sq
        else:
            total = total + sq
    if reduce is not None:
        total = total + reduce(pieces)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_init(params: dict) -> dict:
    """Zeroed float32 moments beside each parameter, and step 0."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"m": zeros, "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict, *,
                 ndims: dict | None = None,
                 grad_norm: torch.Tensor | None = None) -> tuple[dict, dict, dict]:
    """One step: (params, state, {"grad_norm", "lr"}), the parameters and
    moments updated in place (the same tensors returned).  ``grads`` may
    hold any float dtype (each leaf is taken in float32); ``grad_norm`` is
    the norm before clipping: ``global_norm(grads)`` unless given (a
    data-parallel rank updates its piece of each leaf with the norm of the
    whole gradient).  ``ndims[name]`` is the reference's ndim of that leaf
    (default: the tensor's own), which decides its decay."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        # decoupled weight decay; the reference skips its 1-D leaves
        ndim = p.ndim if ndims is None else ndims[name]
        pf = p.float()
        if ndim >= 2 and cfg.weight_decay:
            delta.add_(pf * cfg.weight_decay)
        p.copy_(pf.sub_(delta.mul_(lr)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(params_axes):
    """Logical axes for the optimizer state (moments mirror the params)."""
    return {"m": params_axes, "v": params_axes, "step": ()}
