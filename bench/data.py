"""The benchmark's data, made from seeds on the device: a frozen torch copy
of the recipe of ``repro_torch.data.pipeline.synthetic_vectors`` and
``synthetic_queries`` (a Gaussian mixture with exponentially decaying
per-dimension scales, turned by a random rotation; queries are corpus
points with 0.1-sigma jitter).

The mixture itself (its centres and rotation) is the deployment's data
distribution and comes from the configuration's ``data_seed``, drawn on
the host so that it is the same on every device.  The rows and the queries
are drawn from the run's ``--seed`` on the device, in fixed chunks, so a
seed gives the same rows every time it is drawn again on that device.
This module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 18  # rows drawn per call: bounds the device memory a draw needs


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def mixture(dim: int, *, data_seed: int, n_modes: int, decay: float):
    """(scales (dim,), centres (n_modes, dim), rotation (dim, dim)), float32
    on the host: the distribution the rows are drawn from."""
    g = _gen(data_seed, "cpu")
    scales = torch.exp(-decay * torch.arange(dim, dtype=torch.float32))
    centres = torch.randn(n_modes, dim, generator=g) * scales * 2
    rot, _ = torch.linalg.qr(torch.randn(dim, dim, generator=g, dtype=torch.float64))
    return scales, centres, rot.float()


def corpus(data: dict, seed: int, device) -> torch.Tensor:
    """(rows, dim) float32 on ``device``: the configuration's ``data`` block
    (rows, dim, data_seed, n_modes, decay) drawn from ``seed``."""
    n, dim = data["rows"], data["dim"]
    scales, centres, rot = (t.to(device) for t in mixture(
        dim, data_seed=data["data_seed"], n_modes=data["n_modes"], decay=data["decay"]))
    g = _gen(2 * seed, device)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        mode = torch.randint(data["n_modes"], (m,), generator=g, device=device)
        x = torch.randn((m, dim), generator=g, device=device) * scales
        torch.matmul(x + centres[mode], rot, out=out[s:s + m])
    return out


def query_pool(rows: torch.Tensor, count: int, seed: int, *, jitter: float = 0.1) -> np.ndarray:
    """(count, dim) float32 on the host: corpus points plus ``jitter`` times
    the corpus's per-dimension spread of Gaussian noise."""
    dev = rows.device
    spread = torch.std(rows, dim=0, correction=0, keepdim=True)
    g = _gen(2 * seed + 1, dev)
    out = np.empty((count, rows.shape[1]), np.float32)
    for s in range(0, count, CHUNK):
        m = min(CHUNK, count - s)
        base = rows[torch.randint(rows.shape[0], (m,), generator=g, device=dev)]
        noise = torch.randn(base.shape, generator=g, device=dev)
        out[s:s + m] = (base + jitter * spread * noise).cpu().numpy()
    return out
