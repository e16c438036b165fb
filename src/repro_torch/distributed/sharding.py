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

Torch has no partitioner, so the port executes the reference's layout
itself.  The step (``launch.steps.DataParallel``) splits the batch rows
over the "pod" and "data" axes (the prefix of them the rows divide by),
gathers each parameter's ``embed_fsdp`` pieces along "data" and sums the
gradients over the ranks that took other rows; inside the model the
"model" axis (:data:`MODEL_AXIS`) is executed by :func:`constrain`: under
:func:`use_rules` over a live mesh (a ``DeviceMesh``, or a
:class:`RankView` on ``device="meta"``) it moves a tensor from the
placement the rank's local computation produced to the one the
reference's annotation names, with the autograd-aware collectives of
``distributed.collectives``.  Over a plain :class:`AbstractMesh`, or with
no rules, it returns its input.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Sequence

__all__ = ["AbstractMesh", "RankView", "MODEL_AXIS", "Rules", "DEFAULT_RULE_TABLE", "Sharding", "use_rules",
           "current_rules", "constrain", "logical_to_spec", "tree_shardings",
           "spec_bytes", "mesh_axis_sizes", "local_shape", "local_slice", "model_dim", "rules_in",
           "make_rules", "comm_over", "cache_split", "executes"]

# The mesh axis that the model's own code executes (tensor parallelism);
# the step has split the batch over the others before the model runs.
MODEL_AXIS = "model"

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


@dataclasses.dataclass(frozen=True)
class RankView(AbstractMesh):
    """An :class:`AbstractMesh` seen from one rank's ``coordinate``, with no
    process group: enough for :func:`local_slice`, and for :func:`constrain`
    to run one rank's step on ``device="meta"`` (its collectives give the
    shapes they would return and are counted, nothing moves)."""

    coordinate: tuple = ()

    def get_coordinate(self) -> list[int]:
        return list(self.coordinate)


def executes(mesh) -> bool:
    """Whether :func:`constrain` places tensors over ``mesh``: a
    ``DeviceMesh`` or a :class:`RankView`; not a plain
    :class:`AbstractMesh`, whose layout is only reasoned about."""
    return mesh is not None and (isinstance(mesh, RankView)
                                 or not isinstance(mesh, AbstractMesh))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Rules:
    """The rule table over ``mesh``.  Over a live mesh, :func:`comm_over`
    builds each group of mesh axes' ``collectives.AxisComm`` once, in
    ``comms``, counting into ``traffic`` (a ``collectives.Traffic`` or
    None), over the process groups of several axes in ``groups``
    (``collectives.axis_groups`` of the mesh).  ``rows``: the mesh axes
    the step split its batch rows over (a tensor's "batch" dimension then
    holds this rank's rows of them), read by :func:`cache_split`."""

    mesh: Any
    table: dict[str, tuple[str, ...]]
    traffic: Any = None
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)
    rows: tuple = ()
    comms: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @functools.cached_property
    def sizes(self) -> dict[str, int]:
        """:func:`mesh_axis_sizes` of the mesh, read once."""
        return mesh_axis_sizes(self.mesh)

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
        sizes = self.sizes
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


def make_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None,
               traffic=None, groups: dict | None = None) -> Rules:
    """The default rule table, updated by ``overrides``, over ``mesh``."""
    return Rules(mesh=mesh, table=_table(overrides), traffic=traffic, groups=groups or {})


@contextlib.contextmanager
def use_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None):
    with rules_in(make_rules(mesh, overrides)):
        yield


def current_rules() -> Rules | None:
    return _RULES.get()


@contextlib.contextmanager
def rules_in(rules: Rules | None):
    """The block runs under ``rules`` (a :func:`current_rules` value, None
    included): a recomputation under the rules of its forward pass."""
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


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


def _model_split(spec, sizes) -> tuple[int | None, tuple[str, ...]]:
    """(the dimension of ``spec`` split over :data:`MODEL_AXIS`, the mesh
    axes of size > 1 it is split over, the model axis first as the spec
    names them), or (None, ()); ``sizes``: the mesh's axis sizes."""
    if sizes.get(MODEL_AXIS, 1) == 1:
        return None, ()
    for dim, part in enumerate(spec or ()):
        names = (part,) if isinstance(part, str) else (part or ())
        if MODEL_AXIS in names:
            return dim, tuple(nm for nm in names if sizes[nm] > 1)
    return None, ()


def _model_part(spec, sizes) -> int | None:
    """The dimension of ``spec`` split over :data:`MODEL_AXIS` (None: none).
    Raises, by name, for a dimension split over the model axis together
    with another axis of size > 1: an activation's placement changes only
    along the model axis (the step splits only rows over "data")."""
    dim, names = _model_split(spec, sizes)
    if len(names) > 1:
        raise NotImplementedError(
            f"a dimension split over {MODEL_AXIS!r} and {list(names[1:])} is not executed "
            f"(spec {tuple(spec)})")
    return dim


def model_dim(axes: Sequence[str | None], shape: Sequence[int]) -> int | None:
    """The dimension of a tensor of (global) ``shape`` with logical ``axes``
    that the current rules split over the model axis, where a live mesh
    executes them (:func:`executes`); None otherwise."""
    rules = current_rules()
    if rules is None or not executes(rules.mesh):
        return None
    return _model_part(logical_to_spec(axes, shape, rules), rules.sizes)


def cache_split(axes: Sequence[str | None], shape: Sequence[int]
                ) -> tuple[int | None, tuple[str, ...]]:
    """(dimension, mesh axes) over which the current rules split a decode
    cache leaf of (global) ``shape`` with logical ``axes``, where a live
    mesh executes them: the model axis, alone or with others (long_500k's
    ``kv_seq`` over "model", "data" and "pod", as far as the batch has not
    claimed them: every rank of those axes one block of slots);
    (None, ()) otherwise."""
    rules = current_rules()
    if rules is None or not executes(rules.mesh):
        return None, ()
    if rules.rows:  # the leaf holds this rank's rows: place the global batch's
        n = math.prod(rules.sizes[nm] for nm in rules.rows)
        shape = [d * n if a == "batch" else d for a, d in zip(axes, shape)]
    return _model_split(logical_to_spec(axes, shape, rules), rules.sizes)


def comm_over(names: tuple[str, ...] = (MODEL_AXIS,)):
    """The mesh axes ``names`` of the current rules' live mesh as one
    ``collectives.AxisComm`` (its size, this rank's piece index in
    :func:`local_slice`'s order, the group), built once per rules, or
    None: no rules, a mesh that is only reasoned about, or a model axis of
    size 1."""
    rules = current_rules()
    if rules is None or not executes(rules.mesh):
        return None
    if rules.sizes.get(MODEL_AXIS, 1) == 1:
        return None
    names = tuple(names)
    comm = rules.comms.get(names)
    if comm is None:
        from repro_torch.distributed.collectives import AxisComm
        comm = rules.comms[names] = AxisComm(rules.mesh, names, rules.traffic, rules.groups)
    return comm


def constrain(x, *axes: str | None, src: int | None = None, partial: bool = False):
    """The reference's sharding constraint, executed over the model axis.

    ``x`` is this rank's piece of a tensor: split along dimension ``src``
    over the model axis (None: whole), or, with ``partial``, whole-shaped
    partial sums whose sum over the model ranks is the tensor.  Returns this
    rank's piece of it placed as ``logical_to_spec(axes, its global
    shape)`` says: all-gathered, sliced or reduce-scattered along the model
    axis where the placement changes, differentiable both ways
    (``collectives.gather_along`` and siblings: a replicated tensor's
    gradient on a rank is its partial sum).  The batch rows stay as the
    step split them over the data ranks.  A no-op without rules, over a
    mesh that is only reasoned about, and over a model axis of size 1."""
    comm = comm_over()
    if comm is None:
        return x
    from repro_torch.distributed import collectives as C

    shape = list(x.shape)
    if src is not None:
        if partial:
            raise ValueError("partial sums are whole-shaped: give no src")
        shape[src] *= comm.size
    rules = current_rules()
    tgt = _model_part(logical_to_spec(axes, shape, rules), rules.sizes)
    if partial:
        return C.reduce_all(x, comm) if tgt is None else C.reduce_scatter_along(x, tgt, comm)
    if src == tgt:
        return x
    if src is not None:
        x = C.gather_along(x, src, comm)
    return x if tgt is None else C.split_along(x, tgt, comm)


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
