"""Span tracer: explicit begin/end spans at host boundaries (port of
``repro.obs.trace``).

The serving routes interleave card launches with host work (routing,
frontier selection, stacking a continuous wave, reading results back).
The engines open explicit spans at those boundaries and ``fence`` the
tensors a span is supposed to cover: PyTorch returns before the card
finishes, so without the fence a kernel's time lands in whichever later
span first reads its output.

Zero cost when disabled: the module-level current tracer defaults to
``NULL_TRACER``, whose ``span`` returns one preallocated no-op context
manager and whose ``fence`` returns its argument untouched, with no
synchronisation, no allocation and no ``if`` in the instrumented code.
Enabling tracing is swapping the module-level pointer (``set_tracer``).

Stdlib-only at import: ``Tracer.fence`` imports torch when it is called.
"""

from __future__ import annotations

import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "current_tracer",
           "set_tracer", "use_tracer"]


class _NullSpan:
    """Reusable no-op context manager — one instance for the whole process
    so the disabled step path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **args):
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op returning shared
    singletons; ``fence`` does not wait for the card.  ``enabled`` lets
    rare non-hot-path code branch, but instrumented engine code must not —
    it just calls through."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args):
        pass

    def annotate(self, **args):
        pass

    def fence(self, value):
        return value


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._tracer._stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self._tracer
        popped = tr._stack.pop()
        if popped is not self:  # pragma: no cover - misuse guard
            raise RuntimeError(
                f"span nesting violated: exiting {self.name!r} but "
                f"innermost open span is {popped.name!r}")
        tr.events.append({
            "name": self.name, "ph": "X", "ts": self._t0, "dur": end - self._t0,
            "depth": len(tr._stack), "args": self.args,
        })
        return False

    def annotate(self, **args):
        self.args.update(args)


class Tracer:
    """Recording tracer.  Events accumulate as plain dicts (timestamps in
    perf_counter_ns ticks; export converts to Chrome-trace microseconds).

    Spans are strictly nested context managers; ``instant`` records a
    zero-duration annotation event at the current depth (used for byte
    attributions: stage-1 tiles, stage-2 slabs)."""

    __slots__ = ("events", "_stack", "meta")
    enabled = True

    def __init__(self, **meta):
        self.events: list[dict] = []
        self._stack: list[_Span] = []
        self.meta = dict(meta)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self.events.append({
            "name": name, "ph": "i", "ts": time.perf_counter_ns(),
            "depth": len(self._stack), "args": args,
        })

    def annotate(self, **args) -> None:
        """Attach args to the innermost open span (no-op at top level, so
        shared helpers can annotate without knowing their call context)."""
        if self._stack:
            self._stack[-1].args.update(args)

    def fence(self, value):
        """Wait for the card to finish the work behind ``value`` (a tensor,
        or tuples, lists and dicts of them), then return it — the honesty
        barrier for span timing.  Synchronises each CUDA device the tensors
        live on; tensors on the CPU are already done."""
        import torch

        devices = set()
        stack = [value]
        while stack:
            v = stack.pop()
            if isinstance(v, torch.Tensor):
                if v.device.type == "cuda":
                    devices.add(v.device)
            elif isinstance(v, (tuple, list)):
                stack.extend(v)
            elif isinstance(v, dict):
                stack.extend(v.values())
        for dev in devices:
            torch.cuda.synchronize(dev)
        return value

    def depth(self) -> int:
        return len(self._stack)


# ---------------------------------------------------------------------------
# Module-level current tracer.  Engines resolve it at call time via
# ``current_tracer()`` so a tracer installed by serve.py is seen by every
# layer without parameter threading.
# ---------------------------------------------------------------------------

_current: NullTracer | Tracer = NULL_TRACER


def current_tracer():
    return _current


def set_tracer(tracer) -> None:
    global _current
    _current = NULL_TRACER if tracer is None else tracer


class use_tracer:
    """Context manager installing ``tracer`` for the dynamic extent, always
    restoring the previous one (tests rely on this to not leak state)."""

    def __init__(self, tracer):
        self._tracer = tracer
        self._prev = None

    def __enter__(self):
        global _current
        self._prev = _current
        _current = NULL_TRACER if self._tracer is None else self._tracer
        return self._tracer

    def __exit__(self, *exc):
        global _current
        _current = self._prev
        return False
