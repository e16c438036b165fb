"""PyTorch/CUDA port of the DADE-screened ANN search system.

Mirrors the module layout of the JAX package ``repro`` so each part can be
held against its counterpart, but is written in PyTorch's idiom: plain
functions on tensors, small dataclasses for state, an explicit ``device=``
on every entry point (default ``"cuda"``) and ``torch.Generator`` wherever
the JAX package takes a ``jax.random`` key.

Five hand-written kernels (CUDA C++ for ``sm_90a`` in ``kernels/csrc/``,
each built with ``nvcc`` at first use) carry the search: the fused IVF wave
scan ``ivf_scan``, the graph beam scan ``graph_scan`` (one wave, or a whole
walk in one launch), the flat DCO screens ``dade_dco`` and ``quant_dco``,
and the exact ``l2_scan``.  Around them: the flat, IVF and graph indexes,
the serving routes (``launch.serve``: batched flat and graph serving, and
continuous graph batching through ``launch.annservice``'s continuous
engines), the request schedulers with deadlines, watermark shedding and
bounded retries (``runtime.scheduler``), the fault-injection harness
(``runtime.chaos``) and telemetry (``obs``: metrics, spans, exports).
Importing this package imports nothing CUDA-specific.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
