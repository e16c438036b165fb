"""Step functions for every (arch x shape) serving cell.

The port of ``repro.launch.steps``' serving half: ``build_cell`` returns
the model, its step function and meta-device arguments.  The reference's
mesh, ``in_shardings`` and per-shape rule overrides are TPU-mesh placement;
on one card the model carries no sharding annotations (the reference's
``constrain`` is a no-op when no rules are active).  The train kind comes
with the training slice (ROADMAP queue 1 item 8, the training half).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs import get_config
from repro_torch.launch.specs import cell_is_runnable, input_specs
from repro_torch.models.model import LM, build_model

__all__ = ["Cell", "build_cell", "prefill_step", "serve_step"]


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape: str
    kind: str  # prefill | decode
    step_fn: Callable
    args: tuple  # meta-device tensors (shapes and dtypes of the step's inputs)
    model: LM
    runnable: bool = True
    skip_reason: str = ""


def prefill_step(model: LM, batch: dict[str, torch.Tensor]):
    """(last-position logits, caches) of a prompt batch."""
    return model.prefill(batch)


def serve_step(model: LM, token: torch.Tensor, caches: dict, pos):
    """One new token against ``caches`` (updated in place) at ``pos``."""
    return model.decode_step(token, caches, pos)


def build_cell(arch_id: str, shape: str, *, device="cuda", cfgset: dict | None = None,
               ) -> Cell:
    """The cell's model (seed 0, on ``device``; ``"meta"`` for shapes only),
    its step function with the model bound, and its arguments' specs."""
    cfg = get_config(arch_id)
    if cfgset:
        cfg = dataclasses.replace(cfg, **cfgset)
    spec, bspecs = input_specs(cfg, shape)
    if spec.kind == "train":
        raise NotImplementedError(
            f"{arch_id} {shape}: the train step is not ported yet (ROADMAP queue 1 "
            f"item 8, the training half)")
    ok, why = cell_is_runnable(cfg, shape)
    model = build_model(cfg, device=device)
    if spec.kind == "prefill":
        return Cell(arch_id, shape, spec.kind, functools.partial(prefill_step, model),
                    (bspecs,), model, ok, why)
    b = spec.global_batch
    caches = build_model(cfg, device="meta").init_caches(b, spec.seq)
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return Cell(arch_id, shape, spec.kind, functools.partial(serve_step, model),
                (token, caches, pos), model, ok, why)
