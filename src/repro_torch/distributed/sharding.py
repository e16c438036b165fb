"""Logical-axis sharding rules (the port of ``repro.distributed.sharding``).

Model code names each tensor dimension with a *logical* axis ("embed_fsdp",
"vocab", "batch", ...); a rule table maps logical axes to mesh axes.  The
mapping is divisibility-aware: a rule is dropped (the dimension replicated)
when the dimension does not divide by the product of the mesh axes, and a
mesh axis is used at most once per tensor.

A *mesh* is anything with named axis sizes: a
``torch.distributed.device_mesh.DeviceMesh`` over ranks
(``launch.mesh.make_host_mesh``), or an :class:`AbstractMesh` of names and
sizes that needs no process group (a 16 x 16 layout reasoned about on one
host).  A *spec* is a tuple with one entry per tensor dimension: ``None``
or a tuple of mesh-axis names, as the reference's ``PartitionSpec`` holds;
a dimension sharded over (a1, a2) is split into size(a1) x size(a2)
pieces, a1 major.

Torch has no partitioner, so nothing here places a tensor: ``constrain``
returns its input, and the data-parallel train step
(``launch.steps.DataParallel``) slices, gathers and sums explicitly by the
specs :func:`tree_shardings` gives.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Sequence

__all__ = ["AbstractMesh", "Rules", "DEFAULT_RULE_TABLE", "Sharding", "use_rules",
           "current_rules", "constrain", "logical_to_spec", "tree_shardings",
           "spec_bytes", "mesh_axis_sizes", "local_shape", "local_slice"]

# Mesh axes: "pod" (inter-pod DP), "data" (DP + FSDP), "model" (TP).
DEFAULT_RULE_TABLE: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),  # seq inside attention/mlp math (unsharded)
    "act_seq": ("model",),  # residual-stream seq (Megatron-style SP)
    "embed": (),  # activation d_model: replicated across model
    "embed_fsdp": ("data",),  # weight d_model dim: ZeRO/FSDP shard
    "vocab": ("model",),
    "ffn": ("model",),
    "qkv": ("model",),  # merged n_heads*head_dim projection dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "kv_seq": ("model",),  # decode-time KV cache sequence (flash-decoding)
    "expert": (),  # baseline: TP-in-expert; EP variant remaps to ("model",)
    "expert_ffn": ("model",),  # routed-expert hidden width
    "expert_cap": (),
    "inner": ("model",),  # ssm d_inner
    "ssm_state": ("model",),
    "ssm_heads": ("heads_fallback",),  # resolved like heads
    "chunk": (),
    "frames": (),  # audio/vision stub sequence
    "layers": (),  # stacked-scan leading dim
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes, with no devices or process group (the
    reference's ``jax.sharding.AbstractMesh((16, 16), ("data", "model"))``)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names {self.axis_names} "
                             f"differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def ndim(self) -> int:
        return len(self.axis_sizes)

    def size(self) -> int:
        """Devices in the whole mesh (``DeviceMesh.size()``)."""
        return math.prod(self.axis_sizes)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any
    table: dict[str, tuple[str, ...]]

    def resolve(self, axis: str | None, dim: int,
                used: set[str] | None = None) -> tuple[str, ...] | None:
        """Mesh axes for one logical axis, honoring divisibility and
        skipping mesh axes already claimed by an earlier tensor dim (a spec
        may use each mesh axis at most once)."""
        if axis is None:
            return None
        names = self.table.get(axis)
        if names == ("heads_fallback",):
            names = self.table.get("heads", ())
        if not names:
            return None
        used = used if used is not None else set()
        sizes = mesh_axis_sizes(self.mesh)
        # use only the prefix of mesh axes whose product divides dim
        chosen: list[str] = []
        prod = 1
        for nm in names:
            if nm not in sizes or nm in used:
                continue
            nxt = prod * sizes[nm]
            if dim % nxt == 0:
                chosen.append(nm)
                prod = nxt
            else:
                break
        return tuple(chosen) or None


_RULES: contextvars.ContextVar[Rules | None] = contextvars.ContextVar(
    "sharding_rules", default=None)


def _table(overrides: dict | None) -> dict[str, tuple[str, ...]]:
    table = dict(DEFAULT_RULE_TABLE)
    if overrides:
        table.update(overrides)
    return table


@contextlib.contextmanager
def use_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None):
    token = _RULES.set(Rules(mesh=mesh, table=_table(overrides)))
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Rules | None:
    return _RULES.get()


def logical_to_spec(axes: Sequence[str | None], shape: Sequence[int],
                    rules: Rules) -> tuple:
    """The spec of a tensor of ``shape`` whose dimensions carry ``axes``."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} do not match shape {tuple(shape)}")
    used: set[str] = set()
    parts = []
    for a, d in zip(axes, shape):
        r = rules.resolve(a, d, used)
        if r:
            used.update(r)
        parts.append(r)
    return tuple(parts)


def constrain(x, *axes: str | None):
    """The reference's sharding constraint: a no-op (nothing here places a
    tensor; placement is explicit in the step)."""
    return x


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's placement over ``mesh``: its ``spec`` and the
    ``torch.distributed.tensor`` placements that express it, one per mesh
    dimension in the mesh's order (``Shard(dim)`` where the spec names that
    mesh axis, else ``Replicate()``).  A dimension split over several mesh
    axes in an order other than the mesh's is described by ``spec`` only."""

    mesh: Any
    spec: tuple
    placements: tuple


def _placements(spec: tuple, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {nm: i for i, part in enumerate(spec) for nm in (part or ())}
    return tuple(Shard(dim_of[nm]) if nm in dim_of else Replicate()
                 for nm in mesh_axis_sizes(mesh))


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
        isinstance(e, (str, type(None))) for e in t)


def tree_shardings(axes_tree: Any, shapes_tree: Any, mesh,
                   overrides: dict[str, tuple[str, ...]] | None = None) -> Any:
    """A :class:`Sharding` for each leaf of ``shapes_tree`` (tensors, arrays
    or shape tuples), from the logical axes at the same place in
    ``axes_tree`` (a leaf: a tuple of axis names or None).  Trees are dicts,
    lists, tuples and named tuples."""
    rules = Rules(mesh=mesh, table=_table(overrides))

    def walk(axes, shaped):
        if _is_axes(axes):
            shape = tuple(shaped.shape) if hasattr(shaped, "shape") else tuple(shaped)
            spec = logical_to_spec(axes, shape, rules)
            return Sharding(mesh, spec, _placements(spec, mesh))
        if isinstance(axes, dict):
            return {k: walk(axes[k], shaped[k]) for k in axes}
        if isinstance(axes, tuple) and hasattr(axes, "_fields"):
            return type(axes)(*(walk(a, s) for a, s in zip(axes, shaped)))
        if isinstance(axes, (list, tuple)):
            return type(axes)(walk(a, s) for a, s in zip(axes, shaped))
        raise TypeError(f"not a logical-axes tree node: {axes!r}")

    return walk(axes_tree, shapes_tree)


def _split(spec: tuple, mesh, ndim: int):
    """(pieces each dimension is split into, over which mesh axes)."""
    sizes = mesh_axis_sizes(mesh)
    parts = [(p,) if isinstance(p, str) else (p or ())
             for p in tuple(spec) + (None,) * (ndim - len(spec))]
    return [(math.prod(sizes[nm] for nm in p), p) for p in parts]


def spec_bytes(shaped, spec: tuple, mesh) -> int:
    """Per-device bytes of a tensor under a spec (memory napkin math)."""
    shape = [-(-d // n) for d, (n, _) in zip(shaped.shape, _split(spec, mesh, len(shaped.shape)))]
    return math.prod(shape) * shaped.dtype.itemsize


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's piece of a tensor of ``shape`` under ``spec``
    (the spec's dimensions divide, as :class:`Rules` resolves them)."""
    return tuple(d // n for d, (n, _) in zip(shape, _split(spec, mesh, len(shape))))


def local_slice(x, spec: tuple, mesh, coordinate: Sequence[int] | None = None):
    """This rank's piece of the full tensor ``x`` under ``spec`` (a view):
    along a dimension split over mesh axes (a1, ..., ak), piece number
    c_a1 x size(a2) x ... + c_ak of the equal pieces, ``c`` the rank's mesh
    ``coordinate`` (default: the ``DeviceMesh``'s own)."""
    sizes = mesh_axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate() if coordinate is None else coordinate))
    for dim, (n, names) in enumerate(_split(spec, mesh, x.ndim)):
        if n == 1:
            continue
        idx = 0
        for nm in names:
            idx = idx * sizes[nm] + coord[nm]
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x
