"""Input specs (meta-device stand-ins) for every (arch x shape) cell.

The port of ``repro.launch.specs``.  Shapes are the four LM cells:

  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill step
  decode_32k   cache 32768, global_batch 128  -> serve step (1 token)
  long_500k    cache 524288, global_batch 1   -> serve step (1 token);
               runs only for sub-quadratic-capable archs (SSM / hybrid /
               SWA / alternating-local)

Modality frontends are stubs: whisper gets precomputed frame embeddings,
llama-vision gets projected patch embeddings.  A spec is a tensor on
``device="meta"``: its shape and dtype, with nothing allocated.  Each
input also carries the reference's logical axes (``batch_logical_axes``),
from which ``distributed.sharding`` places it over a mesh: the batch rows
over the ("pod", "data") axes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "batch_specs", "batch_logical_axes",
           "cell_is_runnable", "LONG_OK"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Archs whose long-context decode is sub-quadratic-capable (SSM state,
# sliding windows, or alternating local attention bounding cache growth).
LONG_OK = {"mamba2-130m", "zamba2-1.2b", "mixtral-8x7b", "gemma2-9b"}


def cell_is_runnable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.arch_id not in LONG_OK:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, spec: ShapeSpec) -> dict[str, torch.Tensor]:
    """Training/prefill batch: tokens (+ stub modality embeddings)."""
    b, s = spec.global_batch, spec.seq
    out = {"tokens": _spec((b, s), torch.int32)}
    if spec.kind == "train":
        out["labels"] = _spec((b, s), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), cfg.param_dtype)
    if cfg.family == "vlm":
        out["vision"] = _spec((b, cfg.vision_seq, cfg.vision_dim), cfg.param_dtype)
    return out


def batch_logical_axes(cfg: ArchConfig, spec: ShapeSpec) -> dict[str, tuple]:
    """The logical axes of each input of :func:`batch_specs`."""
    out = {"tokens": ("batch", "seq")}
    if spec.kind == "train":
        out["labels"] = ("batch", "seq")
    if cfg.family == "encdec":
        out["frames"] = ("batch", "frames", "embed")
    if cfg.family == "vlm":
        out["vision"] = ("batch", "frames", "embed")
    return out


def input_specs(cfg: ArchConfig, shape: str):
    """(shape spec, batch specs, batch logical axes) for one cell."""
    spec = SHAPES[shape]
    return spec, batch_specs(cfg, spec), batch_logical_axes(cfg, spec)
