"""Op census of one eager step (the port of ``repro.launch.hlo_census``).

The reference parses XLA's post-optimization HLO; an eager PyTorch step
has no such text, so :func:`census` runs the step once under a
``TorchDispatchMode`` and counts every ATen op as it executes, on meta
tensors (shapes only, nothing allocated) or on the card:

    flops            — the matmul-family ops' operations, from the formulas
                       ``torch.utils.flop_counter`` registers (the table
                       ``FlopCounterMode`` uses); ``flops_by_class`` splits
                       them by the peak that applies: ``bf16`` (bf16 / f16
                       operands, tensor cores), ``fp32`` (float32 operands:
                       the port keeps TF32 off, so these run outside the
                       tensor cores) and ``int8``
    bytes            — operand bytes + output bytes of every op that is not
                       a view or a metadata op.  Eager PyTorch launches one
                       kernel per such op, so this is the counterpart of the
                       reference's post-fusion bytes per top-level op, and
                       takes its rules for ops that touch part of a tensor:
                       a gather reads its output's size, a scatter reads its
                       update and reads and writes the update's region
    collective_bytes — the bytes the port's ``distributed.collectives``
                       calls carried, by the reference's kind names
                       (``coll_by_kind``, ``coll_count_by_kind``)
    loops            — empty: an eager step runs every layer and every
                       microbatch as it goes, so there is no loop body whose
                       trip count the census would have to recover (the
                       problem the reference's parser solves does not arise)
    peak_bytes       — the largest sum of bytes of the tensors the call
                       itself allocated that were alive at once (its inputs
                       excluded; its fresh outputs included), tracked
                       through the mode by each storage's lifetime
    by_op            — {op: {"count", "flops", "bytes"}} per ATen overload

A hand-written kernel launched through ``ctypes`` is invisible to a
dispatch mode, so its wrapper reports itself (:func:`report_kernel`):
one op under the kernel's name, its operations by class and its bytes.
That call is a no-op when no census is open, so the serving paths pay
nothing for it.
"""

from __future__ import annotations

import collections
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["census", "Census", "report_kernel", "report_collective", "active",
           "paused", "flop_class", "COLLECTIVES"]

# The reference's collective kinds, plus XLA's name for a broadcast.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

# Ops that move no bytes: aliasing views the schema does not mark as such,
# allocations whose contents are never touched, and host reads.
_FREE = {
    "aten::_unsafe_view", "aten::detach", "aten::lift_fresh", "aten::alias",
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::empty_permuted",
    "aten::new_empty", "aten::new_empty_strided", "aten::_local_scalar_dense",
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel", "aten::is_same_size",
    "aten::_has_compatible_shallow_copy_type", "aten::set_",
}

_OPEN: list["Census"] = []  # the censuses open in this process, innermost last
_LOCK = threading.Lock()  # the autograd engine runs a card's backward on its own thread


def active() -> "Census | None":
    """The innermost open census, or None."""
    return _OPEN[-1] if _OPEN else None


def paused():
    """A context in which nothing dispatched is counted: a kernel wrapper's
    own bookkeeping (reading the counters it reports) is not the step's."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def flop_class(dtype: torch.dtype) -> str:
    """The peak a product with operands of ``dtype`` runs at."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "fp32"


def report_kernel(name: str, *, ops: dict, nbytes: float) -> None:
    """A hand-written kernel's launch, counted by the open census as one op:
    ``ops`` its operations by class ({"int8": n, "fp32": n, ...}),
    ``nbytes`` what it reads and writes.  No-op without an open census."""
    cen = active()
    if cen is not None:
        cen._add(name, sum(ops.values()), nbytes, ops, kernel=True)


def report_collective(kind: str, nbytes: float) -> None:
    """One collective of ``kind`` (one of :data:`COLLECTIVES`) carrying
    ``nbytes`` (its output, the reference's rule), counted by the open
    census.  No-op without an open census."""
    cen = active()
    if cen is not None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        with _LOCK:
            cen.coll_by_kind[kind] += nbytes
            cen.coll_count_by_kind[kind] += 1


# Ops that read only the slice they return, and ops that write an update
# into a larger tensor: the reference's rules for slice / gather (the
# operand read is the output's size) and scatter (the update read, the
# region read and written) instead of whole operands.
_GATHER = {"aten::index_select", "aten::gather", "aten::embedding", "aten::index"}
_SCATTER = {"aten::index_copy_", "aten::index_copy", "aten::index_put_", "aten::index_put",
            "aten::scatter_", "aten::scatter", "aten::scatter_add_", "aten::scatter_add",
            "aten::index_add_", "aten::index_add", "aten::masked_scatter_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, acc: list) -> list:
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, acc)
    return acc


def _kind(func) -> str:
    """How an op's bytes are counted: ``free`` (a view or metadata op: none),
    ``gather``, ``scatter`` or ``plain`` (every operand and output)."""
    name = func._schema.name
    if name in _FREE:
        return "free"
    rets = func._schema.returns
    # an aliasing return that is not written: a view
    if rets and all(r.alias_info is not None and not r.alias_info.is_write for r in rets):
        return "free"
    if name in _GATHER:
        return "gather"
    return "scatter" if name in _SCATTER else "plain"


class _Mode(TorchDispatchMode):
    def __init__(self, cen: "Census"):
        super().__init__()
        self.cen = cen


def _dispatch(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    self.cen._record(func, args, kwargs, out)
    return out


# Set after the class is made, so that ``TorchDispatchMode`` does not wrap
# it in ``torch._dynamo.disable``: that wrapper imports torch._dynamo at the
# first dispatch (9.6 s of a first census on the card's host), and the
# census runs eager steps only.
_Mode.__torch_dispatch__ = _dispatch


class Census:
    """``with Census(name) as c: step(...)``, then ``c.result()``: the
    counts of everything dispatched inside the block (see the module
    docstring)."""

    def __init__(self, entry: str = "step"):
        from torch.utils.flop_counter import flop_registry

        self.entry = entry
        self.registry = flop_registry
        self.by_op: dict = {}
        self.flops_by_class: collections.Counter = collections.Counter()
        self.coll_by_kind: collections.Counter = collections.Counter()
        self.coll_count_by_kind: collections.Counter = collections.Counter()
        self.kinds: dict = {}
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._closed = False
        self._mode = _Mode(self)

    def __enter__(self) -> "Census":
        _OPEN.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            _OPEN.remove(self)
            self._closed = True

    # ---- counting ------------------------------------------------------

    def _add(self, name: str, flops: float, nbytes: float, by_class: dict | None,
             kernel: bool = False) -> None:
        with _LOCK:
            row = self.by_op.get(name)
            if row is None:
                row = self.by_op[name] = {"count": 0, "flops": 0, "bytes": 0}
                if kernel:
                    row["kernel"] = True
            row["count"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes
            for cls, n in (by_class or {}).items():
                self.flops_by_class[cls] += n
                if kernel:
                    row.setdefault("ops_by_class", collections.Counter())[cls] += n

    def _free(self, key: int) -> None:
        with _LOCK:
            nb = self.live.pop(key, None)
            if nb is not None:
                self.live_bytes -= nb

    def _track(self, ins: list, outs: list) -> None:
        """Each output storage that is none of the inputs' is a fresh
        allocation, live until its storage dies."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            seen.add(key)
            nb = st.nbytes()
            with _LOCK:
                self.live[key] = nb
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _record(self, func, args, kwargs, out) -> None:
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if not self._closed:
            self._track(ins, outs)
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = _kind(func)
        if kind == "free":
            return
        if kind == "gather":
            nbytes = 2 * sum(map(_nbytes, outs))
        elif kind == "scatter":
            nbytes = 3 * _nbytes(ins[-1])  # the update: read, and its region read and written
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        flops, by_class = 0, None
        formula = self.registry.get(func.overloadpacket)
        if formula is not None and ins:
            # the ``dtype`` overloads carry the output dtype positionally
            fargs = tuple(a for a in args if not isinstance(a, torch.dtype))
            flops = int(formula(*fargs, **kwargs, out_val=out))
            by_class = {flop_class(ins[0].dtype): flops}
        self._add(str(func), flops, nbytes, by_class)

    # ---- result --------------------------------------------------------

    def result(self) -> dict:
        """The reference's keys (``flops``, ``bytes``, ``collective_bytes``,
        ``coll_by_kind``, ``coll_count_by_kind``, ``loops``, ``entry``) and
        the port's (``flops_by_class``, ``peak_bytes``, ``by_op``)."""
        by_op = {k: dict(v, ops_by_class=dict(v["ops_by_class"])) if "ops_by_class" in v
                 else dict(v) for k, v in self.by_op.items()}
        return {
            "flops": sum(r["flops"] for r in by_op.values()),
            "bytes": sum(r["bytes"] for r in by_op.values()),
            "collective_bytes": sum(self.coll_by_kind.values()),
            "coll_by_kind": dict(self.coll_by_kind),
            "coll_count_by_kind": dict(self.coll_count_by_kind),
            "loops": {},
            "entry": self.entry,
            "flops_by_class": dict(self.flops_by_class),
            "peak_bytes": self.peak_bytes,
            "by_op": by_op,
        }


def census(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under a :class:`Census` and return its
    counts (see the module docstring)."""
    with Census(getattr(getattr(fn, "func", fn), "__name__", "step")) as cen:
        fn(*args, **kw)
    return cen.result()
