"""Fault-tolerant training-loop runtime (the port of
``repro.runtime.fault_tolerance``).

  * ``TrainRunner`` — step loop with periodic (asynchronous) checkpoints,
    restart-from-latest on an injected or real step failure, bounded
    retry, and data-pipeline skip-ahead (the pipeline is stateless in
    step).
  * ``StragglerMonitor`` — per-step deadline tracking; p50/p95 and the
    steps that exceeded ``deadline_factor`` x p50.
  * ``elastic_restore`` — restore a checkpoint under a new mesh's
    placement (written at N ranks, restored onto M, or onto one process).

Over a rank mesh every rank runs the same loop on its pieces of the state
(``shardings``): each checkpoint is gathered and written by rank 0; a
failure is injected at the same step on every rank, and before restoring
every rank waits for rank 0's writes to commit (``ckpt.wait()``, then a
barrier) and restores the step rank 0 broadcasts, so no rank restores a
step rank 0 has not committed.  In one process too the runner waits for
the pending writes before it reads the latest step; the reference reads
it first, and a failure right after an asynchronous save can restart it
from an older step.

The port's train step updates its state IN PLACE (``optim.adamw``), so
the state the loop started from is gone after the first step.  The
reference restarts a run that fails before its first checkpoint from
that state (``template = state``); the runner here keeps a copy of it on
the host for that restart, placed back on each leaf's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["StragglerMonitor", "TrainRunner", "elastic_restore"]


class StragglerMonitor:
    """Per-step deadline tracking over steady-state (post-warmup) times.

    The first ``warmup`` steps carry compile and cache-fill time; both the
    straggler test and the reported p50/p95 use only ``times[warmup:]``
    (all times while there are no others).  With a ``registry`` attached,
    each observation feeds gauges ``{prefix}.p50_ms`` / ``{prefix}.p95_ms``,
    histogram ``{prefix}.step_ms`` and counter ``{prefix}.stragglers``.
    """

    def __init__(self, deadline_factor: float = 3.0, warmup: int = 3,
                 *, registry: Any = None, prefix: str = "runtime.straggler"):
        self.times: list[float] = []
        self.deadline_factor = deadline_factor
        self.warmup = warmup
        self.straggler_steps: list[int] = []
        self.registry = registry
        self.prefix = prefix

    def _steady(self) -> list[float]:
        steady = self.times[self.warmup:]
        return steady if steady else self.times

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; True if the step was a straggler."""
        self.times.append(dt)
        straggler = False
        if len(self.times) > self.warmup:
            p50 = float(np.median(self.times[self.warmup:]))
            if dt > self.deadline_factor * p50:
                self.straggler_steps.append(step)
                straggler = True
        if self.registry is not None:
            self.registry.histogram(f"{self.prefix}.step_ms").observe(dt * 1e3)
            self.registry.gauge(f"{self.prefix}.p50_ms").set(self.p50 * 1e3)
            self.registry.gauge(f"{self.prefix}.p95_ms").set(self.p95 * 1e3)
            if straggler:
                self.registry.counter(f"{self.prefix}.stragglers").add(1)
        return straggler

    @property
    def p50(self) -> float:
        return float(np.median(self._steady())) if self.times else 0.0

    @property
    def p95(self) -> float:
        return float(np.percentile(self._steady(), 95)) if self.times else 0.0


@dataclasses.dataclass
class _Held:
    """A tensor leaf kept on the host, and the device it came from."""

    host: torch.Tensor
    device: torch.device


def _host_copy(tree):
    """The tree with each tensor leaf copied to the host (a :class:`_Held`);
    nested dicts, lists and tuples walked, other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return _Held(tree.detach().to("cpu", copy=True), tree.device)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _from_host(tree):
    """A :func:`_host_copy` placed back, each leaf a fresh tensor on its
    device."""
    if isinstance(tree, _Held):
        return tree.host.to(tree.device, copy=True)
    if isinstance(tree, dict):
        return {k: _from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_host(v) for v in tree)
    return tree


@dataclasses.dataclass
class TrainRunner:
    step_fn: Callable[[Any, dict], tuple[Any, dict]]  # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], dict]  # step -> batch  (stateless/resumable)
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_restarts: int = 3
    registry: Any = None  # optional obs registry (straggler + restart metrics)
    shardings: Any = None  # the state's Sharding tree over a rank mesh; None: one process

    def _latest_committed(self) -> int | None:
        """The latest committed step, once every pending write has landed;
        over ranks, rank 0's (after a barrier), the same on every rank."""
        self.ckpt.wait()
        if self.shardings is None:
            return self.ckpt.latest_step()
        dist.barrier()
        box = [self.ckpt.latest_step() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def run(self, state: Any, *, start_step: int = 0, num_steps: int = 100,
            fail_at: dict[int, int] | None = None, log_every: int = 0,
            ) -> tuple[Any, dict]:
        """Run the loop; on a step failure, restore the latest checkpoint and
        resume (the data pipeline skips ahead: it is stateless).  A failure
        before the first checkpoint restarts from the initial state (kept
        on the host, since steps update the state in place).  ``fail_at``
        (step -> times to fail there) injects failures for drills."""
        monitor = StragglerMonitor(registry=self.registry)
        restarts = 0
        failures_left = dict(fail_at or {})
        initial = _host_copy(state)
        template = state
        step = start_step
        history = []
        while step < num_steps:
            try:
                if failures_left.get(step, 0) > 0:
                    failures_left[step] -= 1
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, self.batch_fn(step))
                dt = time.perf_counter() - t0
                monitor.observe(step, dt)
                history.append(metrics)
                if log_every and step % log_every == 0:
                    print(f"step {step}: {metrics} ({dt*1e3:.1f} ms)")
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, shardings=self.shardings)
            except Exception:
                restarts += 1
                if self.registry is not None:
                    self.registry.counter("runtime.restarts").add(1)
                if restarts > self.max_restarts:
                    raise
                latest = self._latest_committed()
                if latest is None:
                    # Nothing committed yet: cold restart from the INITIAL
                    # state (the partially-advanced one must not leak into
                    # the rerun) and drop the rolled-back metric rows.
                    state = _from_host(initial)
                    step = start_step
                    history.clear()
                    continue
                state = self.ckpt.restore(latest, template, shardings=self.shardings)
                # Steps in (latest, step) are rolled back and WILL re-run:
                # their metric rows go.
                del history[max(latest - start_step, 0):]
                step = latest
        self._latest_committed()
        return state, {
            "restarts": restarts,
            "straggler_steps": monitor.straggler_steps,
            "p50_ms": monitor.p50 * 1e3,
            "p95_ms": monitor.p95 * 1e3,
            "history": history,
        }


def elastic_restore(ckpt: CheckpointManager, step: int, template: Any,
                    new_shardings: Any) -> Any:
    """Restore a checkpoint onto a different mesh (elastic re-shard).  The
    checkpoint holds full leaves, so placing them under the new mesh's
    ``new_shardings`` (None: one process) is a slice per rank, no
    collective."""
    return ckpt.restore(step, template, shardings=new_shardings)
