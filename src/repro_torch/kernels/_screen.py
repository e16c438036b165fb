"""Host side shared by the flat DCO screen kernels (``dade_dco``,
``quant_dco``): their build, ``ctypes`` binding and launch, and the shape
and device checks ``l2_scan`` shares with them.

The two screens are one skeleton (``csrc/dco_screen.cuh``) at two modes,
each built from its own ``.cu`` file into its own library with the same C
entry point ``<name>_launch``; pointers a mode does not read are passed as
null.  A kernel takes any Q and N (it masks its ragged tiles) and needs
``D % block_d == 0``, ``block_d % 16 == 0`` (16-byte copies of f32 rows
and int8 codes), 16-byte aligned rows and one linear grid index per
128 x 64 tile.  :func:`screen_work` reads off a screen's ``dims`` output
which of the kernel's two paths each tile took.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import MAX_SMEM_BYTES

__all__ = ["KERNEL_TILE", "LIST_CAP", "PATH_CASES", "build", "launch", "check_launch",
           "check_padded", "one_device", "screen_work", "path_case"]

# (queries, candidates) of one CTA and the survivors it keeps as a list
# (kScreenTQ, kScreenTC and kListCap in csrc/dco_screen.cuh); the plain
# versions take any tile.
KERNEL_TILE = (128, 64)
LIST_CAP = 512
# Floats of the CTA's staging ring (kScreenRing), which also stages the
# list: one entry's query and candidate dims after block 1 must fit.
_RING_FLOATS = 4 * (KERNEL_TILE[0] + KERNEL_TILE[1]) * 20
_MAX_GRID = 2**31 - 1


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
    check_launch(qn, n, dim, block_d, int8=c.dtype == torch.int8)
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


def check_launch(qn: int, n: int, dim: int, block_d: int, *, int8: bool) -> None:
    """The shapes the CUDA screens take, or raise: 16-byte copies, one
    list entry's dims after block 1 within the staging ring, and the
    linear grid."""
    if block_d <= 0 or block_d % 16 or dim % block_d:
        raise ValueError(f"the CUDA kernel copies 16 bytes at a time: D={dim} "
                         f"must be a multiple of block_d={block_d}, itself a "
                         f"multiple of 16")
    rest = dim - block_d
    stride = 2 * rest + 4 + (rest // 4 if int8 else 0)  # screen_entry_floats
    if rest and stride > _RING_FLOATS:
        raise ValueError(f"D={dim} is too wide: a list entry's {rest} dims after "
                         f"block 1 take {stride} floats of the {_RING_FLOATS}-float "
                         f"staging ring")
    tq, tc = KERNEL_TILE
    tiles = -(-qn // tq) * -(-n // tc)
    if tiles > _MAX_GRID:
        raise ValueError(f"{qn} x {n} needs {tiles} {tq} x {tc} tiles; the linear "
                         f"grid holds {_MAX_GRID}")


def screen_work(dims: torch.Tensor, block_d: int, *, tile=KERNEL_TILE,
                cap: int = LIST_CAP) -> dict:
    """Which path the CUDA screen took, read off its ``dims`` output (Q, N).

    A tile runs block 1 dense; after checkpoint s it counts the pairs still
    active (``dims > (s+1)·block_d``): none ends it, at most ``cap`` run the
    remaining blocks as a list, more run block s+2 dense.  Returns the
    (tile, block) steps that ran dense, the list entries summed (an entry
    per survivor per later block) and the tiles."""
    qn, n = dims.shape
    tq, tc = tile
    d = torch.nn.functional.pad(dims, (0, (-n) % tc, 0, (-qn) % tq))
    shape = (d.shape[0] // tq, tq, d.shape[1] // tc, tc)
    tiles = shape[0] * shape[2]
    deepest = int(d.max()) // block_d if d.numel() else 0
    dense = torch.ones(tiles, dtype=torch.long, device=dims.device)
    still = torch.ones(tiles, dtype=torch.bool, device=dims.device)  # dense so far
    entries = 0
    for s in range(deepest - 1):  # the survivors of checkpoint s
        count = (d > (s + 1) * block_d).reshape(shape).sum(dim=(1, 3)).flatten()
        still &= count > cap
        dense += still
        entries += int(count[~still].sum())
    return {"dense_steps": int(dense.sum()), "list_entries": entries, "tiles": tiles}


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


# Inputs that force each path of the CUDA screens (:func:`path_case`).
PATH_CASES = {  # (Q, N, D, block_d)
    "cap": (128, 64, 64, 16),
    "cap+1": (128, 64, 64, 16),
    "all_survive": (200, 300, 128, 32),
    "ragged_d384_bd128": (130, 1000, 384, 128),
    "ragged_bd16": (257, 333, 256, 16),
}


def _tables(seed, qn, n, dim, block_d, device):
    """Seeded queries near the rows, the rows, their int8 codes with
    per-dimension scales and the error band E(d_s), and a table of ε in
    [0, 0.3) and scale D/d_s (the last checkpoint exact), on ``device``."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-0.03 * np.arange(dim))
    c = rng.standard_normal((n, dim)) * decay
    q = c[rng.integers(0, n, qn)] + 0.3 * rng.standard_normal((qn, dim)) * decay
    s_count = dim // block_d
    eps = rng.uniform(0.0, 0.3, s_count)
    eps[-1] = 0.0
    scale = dim / (block_d * (np.arange(s_count) + 1.0))
    c = c.astype(np.float32)
    scales = np.abs(c).max(0) / 127 + 1e-6
    codes = np.clip(np.round(c / scales), -127, 127).astype(np.int8)
    ecum = np.sqrt(np.cumsum((scales * 0.5) ** 2)[block_d - 1::block_d])
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)  # noqa: E731
    return (f32(q), f32(c), torch.as_tensor(codes, device=device), f32(scales), f32(eps),
            f32(scale), f32(ecum))


def _survivor_rsq(e0, extra):
    """r² per query such that exactly ``LIST_CAP // Q`` pairs of each row
    (one more in row 0 where ``extra``) have a first-checkpoint estimate
    ``e0`` at or under it: with ε = 0 and scale 1 they survive block 1."""
    qn = e0.shape[0]
    keep = torch.full((qn,), LIST_CAP // qn, device=e0.device)
    keep[0] += extra
    return torch.sort(e0, dim=1).values[torch.arange(qn, device=e0.device), keep - 1]


def path_case(case: str, device):
    """Inputs that force one path of the CUDA screens: exactly the list's
    capacity of block-1 survivors in the one 128 x 64 tile (``cap``: the
    list from block 2), capacity + 1 (``cap+1``: block 2 dense, the list
    from block 3), every pair
    surviving every block (``all_survive``: r² = 1e30, dense throughout),
    and Q and N ragged against the tile at D 384 / block_d 128 and at
    block_d 16 (r² the 5 % distance quantile).  Returns (the arguments of
    ``dade_dco_kernel_call``, of ``quant_dco_kernel_call``, block_d, the
    block-1 survivors each screen has, or None)."""
    from repro_torch.kernels.ref import dade_dco_ref, quant_dco_ref

    qn, n, dim, bd = PATH_CASES[case]
    q, c, codes, scales, eps, scale, ecum = _tables(17, qn, n, dim, bd, device)
    survivors = None
    if case.startswith("cap"):
        # Far queries, and later blocks that add little to a pair's sum: the
        # survivors of block 1 but the last of each row survive to the end.
        q = torch.randn((qn, dim), generator=torch.Generator().manual_seed(5)).to(device)
        q[:, bd:] *= 0.01
        c[:, bd:] *= 0.01
        scales = c.abs().amax(dim=0) / 127 + 1e-6
        codes = torch.clamp(torch.round(c / scales), -127, 127).to(torch.int8)
        ecum = torch.sqrt(torch.cumsum((scales.double() * 0.5) ** 2, 0)[bd - 1::bd]).float()
        eps, scale = torch.zeros_like(eps), torch.ones_like(scale)
        zero = torch.zeros(qn, device=device)
        e0 = dade_dco_ref(q[:, :bd], c[:, :bd], eps[:1], scale[:1], zero, block_d=bd)[0]
        l0 = quant_dco_ref(q[:, :bd], codes[:, :bd], scales[:bd], eps[:1], scale[:1],
                           ecum[:1], zero, block_d=bd)[0]
        extra = int(case == "cap+1")
        r_fp, r_q = _survivor_rsq(e0, extra), _survivor_rsq(l0, extra)
        survivors = LIST_CAP + extra
    elif case == "all_survive":
        r_fp = r_q = torch.full((qn,), 1e30, device=device)
    else:
        d2 = torch.cdist(q.double(), c.double()) ** 2
        r_fp = r_q = torch.quantile(d2, 0.05, dim=1).float()
    return ((q, c, eps, scale, r_fp), (q, codes, scales, eps, scale, ecum, r_q), bd,
            survivors)
