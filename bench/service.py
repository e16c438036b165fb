"""The system under test: the port's flat DADE route, built with the port's
own set-up functions in the order ``launch/serve.prepare_service`` uses
them, and the step the front end drives.

``prepare_service`` cannot be called here: it takes no corpus and draws its
own from seed 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.dade_ivf import ServiceConfig
from repro_torch.core.estimators import build_estimator, kernel_spec
from repro_torch.kernels.ops import block_table
from repro_torch.launch.annservice import build_search_step
from repro_torch.quant.scalar import fit_block_scales, quantize_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Served:
    """The index on the device and the program's step over it."""

    est: object
    rows: torch.Tensor  # (N, d_pad) rotated rows in the row dtype
    codes: torch.Tensor  # (N, d_pad) int8 per-block codes
    bscales: torch.Tensor
    eps: torch.Tensor
    scale: torch.Tensor
    eps_lo: torch.Tensor
    d_pad: int
    dim: int
    step: object


def service_config(config: dict, k: int) -> ServiceConfig:
    s = config["service"]
    return ServiceConfig(
        arch_id=s["arch_id"], corpus_per_device=config["rows"], dim=config["dim"],
        query_batch=s["query_batch"], k=k, delta_d=s["delta_d"], wave=s["wave"],
        p_s=s["p_s"], dtype=s["dtype"], quant=s["quant"])


def build(config: dict, k: int, corpus: torch.Tensor, seed: int, clock) -> Served:
    """The estimator on the corpus's first rows (a generator seeded from
    ``seed``), the blocked table, the rotated rows and their int8 codes, and
    the search step.  ``clock(part)`` closes each part of the set-up."""
    s = config["service"]
    svc = service_config(config, k)
    est = build_estimator(s["method"], corpus[:s["estimator_rows"]],
                          torch.Generator().manual_seed(seed % (1 << 63)),
                          p_s=svc.p_s, delta_d=svc.delta_d, device=corpus.device)
    clock("estimator")
    kernel_spec(est, svc.dim, svc.delta_d)  # refuse what the kernel can't express
    eps, scale, d_pad, eps_lo = block_table(est.table, svc.dim, svc.delta_d)
    c_rot = torch.nn.functional.pad(est.rotate(corpus), (0, d_pad - svc.dim))
    bscales = fit_block_scales(c_rot, svc.delta_d)
    codes = quantize_block(c_rot, bscales, svc.delta_d)
    rows = c_rot.to(_DTYPES[svc.dtype])
    del c_rot
    step = build_search_step(svc, with_stats=True, shards=s["shards"])
    clock("encoding")
    return Served(est=est, rows=rows, codes=codes, bscales=bscales, eps=eps, scale=scale,
                  eps_lo=eps_lo, d_pad=d_pad, dim=svc.dim, step=step)


class SearchStep:
    """One batch through the program: the raw float32 queries to the device,
    rotated, padded and cast to the row dtype, the search step, and the ids
    and distances read back.  Sums the kernel's scan counters."""

    def __init__(self, served: Served, spans):
        self.s = served
        self.spans = spans
        self.scan = np.zeros(6, np.float64)

    def __call__(self, batch: np.ndarray):
        s, spans = self.s, self.spans
        with spans("step"):
            with spans("step.h2d"):
                q = torch.from_numpy(batch).to(s.rows.device)
            with spans("step.search"):
                x = torch.nn.functional.pad(s.est.rotate(q), (0, s.d_pad - s.dim))
                dists, ids, scan = s.step(s.rows, s.codes, s.bscales, x.to(s.rows.dtype),
                                          s.eps, s.scale, s.eps_lo)
            with spans("step.readback"):
                d, i = dists.cpu().numpy(), ids.cpu().numpy()
                self.scan += scan.cpu().numpy()
        return d, i
