"""Fault-injection harness for the serving stack (chaos drills; the port's
own copy of the reference's stdlib-only ``repro.runtime.chaos``).

Failures are made *injectable* so the degraded-mode machinery (deadlines,
shedding and retries in ``runtime.scheduler``) is tested against the
failure, not around it.

Null-object contract (the ``obs.trace`` pattern): the module-level current
controller defaults to ``NULL_CHAOS``, whose every hook is a no-op — no
allocation, no ``if`` in the instrumented engines.  Enabling chaos is
swapping the module-level pointer (``set_chaos``); the engines never test
a flag, they just call through, so the disabled serving path is
bit-identical to a build without this module.

Fault kinds (specs parse from ``kind[:key=val]*`` joined by ``;``):

  * ``step_error``     — the next ``count`` dispatched engine batches (or
    continuous waves) raise ``ChaosError`` (exercises the scheduler's
    bounded retry/backoff).
  * ``queue_overload`` — adds ``rows`` synthetic rows of queue pressure
    (exercises the queue-depth watermark shed).
  * ``shard_stall``    — injects ``ms`` of latency into ``count`` frontier
    waves once armed (the deadline/shedding path is what absorbs it).
  * ``shard_death``, ``slab_corruption``, ``torn_upsert`` and
    ``stale_transform`` parse and keep the reference's hooks, but no port
    code calls those hooks yet: they belong to the sharded walk and to the
    mutable index, snapshots and write-ahead log, which are not ported.

Every fired fault is appended to ``ChaosController.events`` and counted
under ``serve.fault.*`` when a metrics registry is attached.
"""

from __future__ import annotations

import dataclasses
import time

__all__ = [
    "ChaosError", "FaultSpec", "FAULT_KINDS", "parse_fault", "parse_chaos",
    "NullChaos", "NULL_CHAOS", "ChaosController", "current_chaos",
    "set_chaos", "use_chaos",
]

FAULT_KINDS = ("shard_death", "shard_stall", "step_error", "queue_overload",
               "slab_corruption", "torn_upsert", "stale_transform")

# Per-kind default firing budgets (-1 = unlimited).  Death, overload, and a
# stale transform are states, not events — once armed they hold; stalls,
# step errors, torn upserts, and slab corruption are discrete firings that
# default to one occurrence unless the spec says more.
_DEFAULT_COUNT = {"shard_death": -1, "shard_stall": 1, "step_error": 1,
                  "queue_overload": -1, "slab_corruption": 1,
                  "torn_upsert": 1, "stale_transform": -1}


class ChaosError(RuntimeError):
    """An injected failure (distinct type so tests and retry loops can tell
    a drill from a real engine fault)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault.  ``after`` counts dispatched engine batches (the
    scheduler ticks the clock once per dispatch): the fault arms once MORE
    than ``after`` batches have been dispatched, so ``after=2`` means two
    healthy batches, then the fault."""

    kind: str
    shard: int = -1      # target shard (shard_death / shard_stall; cosmetic
                         # for stall — a stalled shard stalls the whole wave)
    after: int = 0       # engine batches dispatched before arming
    count: int = -1      # firings left (-1 = unlimited)
    ms: float = 0.0      # injected latency per firing (shard_stall)
    rows: int = 0        # synthetic queue rows (queue_overload)
    leaf: int = 0        # leaf index to corrupt (slab_corruption)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if self.kind == "shard_death" and self.shard < 0:
            raise ValueError("shard_death needs shard=<index>")
        if self.kind == "shard_stall" and self.ms <= 0:
            raise ValueError("shard_stall needs ms=<positive latency>")
        if self.kind == "queue_overload" and self.rows <= 0:
            raise ValueError("queue_overload needs rows=<positive depth>")


_INT_FIELDS = ("shard", "after", "count", "rows", "leaf")


def parse_fault(text: str) -> FaultSpec:
    """Parse one ``kind[:key=val]*`` token, failing fast naming the bad
    piece (a chaos drill that silently no-ops is worse than no drill)."""
    parts = [p for p in text.strip().split(":") if p]
    if not parts:
        raise ValueError(f"empty fault spec in {text!r}")
    kind = parts[0]
    kwargs: dict = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"fault spec field {p!r} is not key=val "
                             f"(in {text!r})")
        key, val = p.split("=", 1)
        if key not in _INT_FIELDS + ("ms",):
            raise ValueError(f"unknown fault spec field {key!r} (in {text!r})")
        kwargs[key] = float(val) if key == "ms" else int(val)
    kwargs.setdefault("count", _DEFAULT_COUNT.get(kind, -1))
    return FaultSpec(kind=kind, **kwargs)


def parse_chaos(spec: str, *, registry=None) -> "ChaosController":
    """Parse a ``;``-joined fault list (the ``serve.py --chaos`` string)
    into a controller, e.g. ``"shard_death:shard=1:after=2;``
    ``shard_stall:ms=40:after=1:count=3"``."""
    faults = [parse_fault(tok) for tok in spec.split(";") if tok.strip()]
    if not faults:
        raise ValueError(f"chaos spec {spec!r} names no faults")
    return ChaosController(faults, registry=registry)


_EMPTY: frozenset = frozenset()


class NullChaos:
    """Disabled harness: every hook is a no-op returning shared singletons.
    ``enabled`` lets rare non-hot-path code branch (e.g. serve deciding
    whether to print a drill summary); instrumented engine and scheduler
    code must not — it just calls through."""

    __slots__ = ()
    enabled = False
    specs: tuple = ()
    events: tuple = ()

    def on_engine_step(self) -> None:
        pass

    def on_wave(self, wave: int) -> None:
        pass

    def maybe_fail_step(self) -> None:
        pass

    def dead_shards(self, num_shards: int) -> frozenset:
        return _EMPTY

    def degraded_now(self) -> bool:
        return False

    def queue_pressure(self) -> int:
        return 0

    def take_corruption(self):
        return None

    def take_torn_upsert(self):
        return None

    def stale_transform_active(self) -> bool:
        return False


NULL_CHAOS = NullChaos()


class ChaosController:
    """Armed harness: holds the fault specs, the engine-batch clock, the
    per-spec firing budgets, and the event log.

    The clock is ``on_engine_step()``, ticked by the scheduler once per
    dispatched batch (warm-up and verification calls bypass the scheduler
    on purpose, so they never advance a drill).  A spec is *armed* once
    ``steps > spec.after``.
    """

    enabled = True

    def __init__(self, specs, *, registry=None):
        self.specs = tuple(specs)
        self.registry = registry
        self.steps = 0
        self.events: list[dict] = []
        self._budget = {i: s.count for i, s in enumerate(self.specs)}
        self._announced: set[int] = set()

    # ---- bookkeeping -----------------------------------------------------

    def _fire(self, idx: int, counter: str, delta: float = 1.0,
              **info) -> None:
        spec = self.specs[idx]
        self.events.append({"kind": spec.kind, "step": self.steps, **info})
        if self.registry is not None:
            self.registry.counter(counter).add(delta)

    def _armed(self, spec: FaultSpec) -> bool:
        return self.steps > spec.after

    def _spend(self, idx: int) -> bool:
        """Consume one firing from spec ``idx``'s budget (False = spent)."""
        left = self._budget[idx]
        if left == 0:
            return False
        if left > 0:
            self._budget[idx] = left - 1
        return True

    # ---- hooks (called by scheduler / engines / serve) -------------------

    def on_engine_step(self) -> None:
        self.steps += 1

    def on_wave(self, wave: int) -> None:
        """Per-frontier-wave hook (the graph wave loops): injects
        shard-stall latency.  A stalled shard stalls the whole wave — the
        walk is wave-synchronous — so the sleep models exactly what a slow
        device does to the batch."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "shard_stall" or not self._armed(spec):
                continue
            if not self._spend(i):
                continue
            time.sleep(spec.ms / 1e3)
            self._fire(i, "serve.fault.stall_ms", delta=spec.ms,
                       shard=spec.shard, wave=wave, ms=spec.ms)

    def maybe_fail_step(self) -> None:
        """Pre-dispatch hook (the scheduler): raises ``ChaosError`` while a
        ``step_error`` fault is armed with budget — the scheduler's bounded
        retry/backoff is what must absorb it."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "step_error" or not self._armed(spec):
                continue
            if not self._spend(i):
                continue
            self._fire(i, "serve.fault.step_error")
            raise ChaosError(
                f"injected step failure (step {self.steps})")

    def dead_shards(self, num_shards: int) -> frozenset:
        """Shards currently dead, as seen by an engine with ``num_shards``
        shards.  Death is permanent (no budget): once armed, the shard
        stays dead for every later batch — failover, not flakiness."""
        dead = set()
        for i, spec in enumerate(self.specs):
            if spec.kind != "shard_death" or not self._armed(spec):
                continue
            if spec.shard >= num_shards:
                continue
            dead.add(spec.shard)
            if i not in self._announced:
                self._announced.add(i)
                self._fire(i, "serve.fault.shard_death", shard=spec.shard)
        return frozenset(dead)

    def degraded_now(self) -> bool:
        """True while any shard-death fault is armed — shard-count-agnostic,
        so the scheduler can tag in-flight requests as degraded without
        knowing the engine's topology."""
        return any(s.kind == "shard_death" and self._armed(s)
                   for s in self.specs)

    def queue_pressure(self) -> int:
        """Synthetic queue rows added to the watermark check (the scheduler
        calls this at submit): models a traffic spike without generating
        the traffic."""
        rows = 0
        for i, spec in enumerate(self.specs):
            if spec.kind == "queue_overload" and self._armed(spec):
                rows += spec.rows
                if i not in self._announced:
                    self._announced.add(i)
                    self._fire(i, "serve.fault.queue_pressure",
                               delta=spec.rows, rows=spec.rows)
        return rows

    def take_corruption(self) -> FaultSpec | None:
        """Pop an armed ``slab_corruption`` fault (one-shot): the caller
        (``serve.py --index-ckpt``) flips a snapshot byte before restore so
        the digest check must catch it.  Snapshot restore happens BEFORE
        the first dispatched batch, so this arms at ``steps >= after``
        (the batch clock never ticks past a restore-time fault)."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "slab_corruption" or self.steps < spec.after:
                continue
            if not self._spend(i):
                continue
            self._fire(i, "serve.fault.slab_corruption", leaf=spec.leaf)
            return spec
        return None

    def take_torn_upsert(self) -> FaultSpec | None:
        """Pop an armed ``torn_upsert`` fault (one-shot): the mutation log
        (``checkpoint.wal``) truncates the record it is appending and
        raises ``ChaosError`` — the torn-tail crash WAL replay must
        recover from.  Mutations apply BETWEEN dispatched batches, so like
        ``take_corruption`` this arms at ``steps >= after`` (``after=2``
        = two healthy batches, then the crash before the next one)."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "torn_upsert" or self.steps < spec.after:
                continue
            if not self._spend(i):
                continue
            self._fire(i, "serve.fault.torn_upsert")
            return spec
        return None

    def stale_transform_active(self) -> bool:
        """True while a ``stale_transform`` fault is armed: the drift
        watchdog still measures staleness but its recalibration swap is
        suppressed — serving continues on the stale epsilon table (the
        no-recalibration regime fig10 prices).  State, not event; the
        first suppressed swap is announced and counted once."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "stale_transform" or not self._armed(spec):
                continue
            if i not in self._announced:
                self._announced.add(i)
                self._fire(i, "serve.fault.stale_transform")
            return True
        return False


# ---------------------------------------------------------------------------
# Module-level current controller (the obs.trace pattern): engines resolve
# it at call time via ``current_chaos()`` so a controller installed by
# serve.py is seen by every layer without parameter threading.
# ---------------------------------------------------------------------------

_current: NullChaos | ChaosController = NULL_CHAOS


def current_chaos():
    return _current


def set_chaos(chaos) -> None:
    global _current
    _current = NULL_CHAOS if chaos is None else chaos


class use_chaos:
    """Context manager installing ``chaos`` for the dynamic extent, always
    restoring the previous controller (tests rely on this to not leak a
    drill into the next test)."""

    def __init__(self, chaos):
        self._chaos = chaos
        self._prev = None

    def __enter__(self):
        global _current
        self._prev = _current
        _current = NULL_CHAOS if self._chaos is None else self._chaos
        return self._chaos

    def __exit__(self, *exc):
        global _current
        _current = self._prev
        return False
