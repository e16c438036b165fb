"""Host side shared by the flat DCO screen kernels (``dade_dco``,
``quant_dco``): their build, ``ctypes`` binding and launch, and the shape
and device checks ``l2_scan`` shares with them.

The two screens are one skeleton (``csrc/dco_screen.cuh``) at two modes,
each built from its own ``.cu`` file into its own library with the same C
entry point ``<name>_launch``; pointers a mode does not read are passed as
null.  A kernel takes any Q and N (it masks its ragged tiles) and needs
``D % block_d == 0``, ``block_d % 16 == 0`` (16-byte copies of f32 rows
and int8 codes) and 16-byte aligned rows.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import MAX_SMEM_BYTES

__all__ = ["KERNEL_TILE", "build", "launch", "check_padded", "one_device"]

# (queries, candidates) of one CTA; the plain versions take any tile.
KERNEL_TILE = (16, 128)


def _sources(name: str) -> tuple[str, ...]:
    return (f"{name}.cu", "dco_screen.cuh", "tiles.cuh")


def build(name: str):
    """Compile kernel ``name`` if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    return _build.build(name, _sources(name))


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [i] + [p] * 10 + [i] * 4 + [ctypes.c_float, p]
    fn.restype = i
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [i, i]
    smem.restype = ctypes.c_longlong
    return lib


def launch(name: str, q: torch.Tensor, c: torch.Tensor, *, block_d: int,
           cscales=None, eps=None, scale=None, ecum=None, r_sq=None,
           slack: float = 0.0):
    """Launch screen ``name`` on CUDA tensors ``q`` (Q, D) f32 and ``c``
    (N, D) f32 rows or int8 codes.  Returns ``(est, flag, dims)``: (Q, N)
    f32, int32, int32."""
    qn, dim = q.shape
    n = c.shape[0]
    if dim % block_d or block_d % 16:
        raise ValueError(f"the CUDA kernel copies 16 bytes at a time: D={dim} "
                         f"must be a multiple of block_d={block_d}, itself a "
                         f"multiple of 16")
    if qn > 65535 * KERNEL_TILE[0]:  # gridDim.y counts the query tiles
        raise ValueError(f"{qn} queries exceed the grid's {65535 * KERNEL_TILE[0]}")
    lib = _lib(name)
    smem = getattr(lib, f"{name}_smem_bytes")(dim // block_d, block_d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name} needs {smem} B of shared memory per block at "
                         f"block_d={block_d}; the card offers {MAX_SMEM_BYTES}")
    dev = q.device
    ins = [q.float().contiguous(), c.contiguous()]
    ins += [None if t is None else t.to(dev, torch.float32).contiguous()
            for t in (cscales, eps, scale, ecum, r_sq)]
    for name_, t in (("queries", ins[0]), ("candidates", ins[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"{name_} must be 16-byte aligned for cp.async")
    est = torch.empty((qn, n), dtype=torch.float32, device=dev)
    flag = torch.empty((qn, n), dtype=torch.int32, device=dev)
    dims = torch.empty((qn, n), dtype=torch.int32, device=dev)
    ptr = [None if t is None else t.data_ptr() for t in ins + [est, flag, dims]]
    err = getattr(lib, f"{name}_launch")(
        dev.index or 0, *ptr, qn, n, dim, block_d, float(1.0 - slack),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return est, flag, dims


def check_padded(name: str, qn: int, n: int, dim: int, s_count: int | None, *,
                 block_q: int, block_c: int, block_d: int) -> None:
    """The reference's shape contract: pre-padded to the caller's tiles."""
    if qn % block_q or n % block_c or dim % block_d:
        raise ValueError(f"{name}: shapes must be padded: Q={qn}%{block_q}, "
                         f"N={n}%{block_c}, D={dim}%{block_d}")
    if s_count is not None and s_count != dim // block_d:
        raise ValueError(f"{name}: table has {s_count} steps, need {dim // block_d}")


def one_device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all inputs live on (cuda or cpu), or raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    return dev
