"""PyTorch/CUDA port of the DADE-screened ANN search system.

Mirrors the module layout of the JAX package ``repro`` so each part can be
held against its counterpart, but is written in PyTorch's idiom: plain
functions on tensors, small dataclasses for state, an explicit ``device=``
on every entry point (default ``"cuda"``) and ``torch.Generator`` wherever
the JAX package takes a ``jax.random`` key.

The one hand-written kernel of this slice is the fused IVF wave scan
(``repro_torch.kernels.ivf_scan``, CUDA C++ for ``sm_90a``), built with
``nvcc`` at first use.  Importing this package imports nothing CUDA-specific.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
