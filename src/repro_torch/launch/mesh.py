"""Rank meshes and rank processes for multi-device serving (the port of
``repro.launch.mesh``, in ``torch.distributed``'s idiom).

A rank is one process; rank r runs on ``cuda:(r % torch.cuda.device_count())``
(or on the CPU when the caller asks for it), so one card may hold several
ranks.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, its ranks laid out row-major: the
linear rank of mesh coordinate (c_0, ..., c_{d-1}) is the reference's
``shard_base`` order (the last axis fastest).

The backend is chosen by the caller and never swapped: ``nccl`` where every
rank has a card of its own, ``gloo`` otherwise (NCCL refuses two ranks on
one card; gloo also runs on the CPU).  Process groups initialise from a
``file://`` path, so concurrent groups on one host cannot collide on a
port.  CUDA cannot be forked once initialised, so ranks start with the
``spawn`` method and import their function by module path.

Not applicable here: the reference's ``make_production_mesh`` (a TPU v5e
pod) and its ``shard_map`` / ``check_vma`` version shims (jax-only).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch._device import resolve_device

__all__ = ["BACKENDS", "rank_device", "init_rank", "make_mesh", "make_host_mesh",
           "mesh_device_type", "spawn", "LeadRank"]

BACKENDS = ("nccl", "gloo")
# How long a collective may wait for a peer before the group raises: a rank
# that died mid-run must fail the others, not hang them.
GROUP_TIMEOUT_S = 300


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """Where rank ``rank`` runs: ``cuda:(rank % device_count)``, or the CPU
    when ``device`` is ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_device_type(backend: str) -> str:
    """The device type of a mesh over a ``backend`` group: ``cuda`` for
    NCCL, ``cpu`` for gloo (whose groups the mesh then reuses as they are)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return "cuda" if backend == "nccl" else "cpu"


def init_rank(rank: int, world: int, *, backend: str, init_file: str,
              device: str = "cuda", timeout_s: float = GROUP_TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend``, initialised from ``init_file`` (a path no earlier group
    used); returns the rank's device, made current when it is a card."""
    mesh_device_type(backend)
    dev = rank_device(rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape, axes, device_type: str):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    default group's ranks, row-major (``init_device_mesh``); the group must
    hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A small ("data", "model") mesh over the default group's ranks (the
    data-parallel trainer's, tests).  Raises, naming both, when ``data *
    model`` is not the group's size."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                         f"the group has {world}")
    return make_mesh((data, model), ("data", "model"), device_type)


def _rank_entry(fn, rank, world, backend, init_file, device, args, results):
    """A spawned rank: join the group, run ``fn(rank, world, device,
    *args)``, report its result (or its traceback) to the parent."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # CPU ranks share the host's cores
    try:
        dev = init_rank(rank, world, backend=backend, init_file=init_file, device=device)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


class RankProcs:
    """The ranks :func:`spawn` started: :meth:`join` collects their results;
    :meth:`terminate` stops whatever still runs."""

    def __init__(self, procs: dict, results):
        self.procs, self._results = procs, results

    def terminate(self) -> None:
        for p in self.procs.values():
            if p.is_alive():
                p.terminate()
        for p in self.procs.values():
            p.join(timeout=30)

    def join(self, timeout_s: float = GROUP_TIMEOUT_S) -> dict:
        """{rank: result}, once every rank has reported; raises, after
        stopping the rest, when a rank failed, died or overran ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        while len(got) < len(self.procs):
            try:
                rank, ok, val = self._results.get(timeout=0.5)
            except queue.Empty:
                lost = [r for r, p in self.procs.items()
                        if r not in got and p.exitcode is not None]
                if lost or time.monotonic() > deadline:
                    self.terminate()
                    raise RuntimeError(
                        f"ranks {lost or sorted(set(self.procs) - set(got))} "
                        f"{'exited without a result' if lost else 'timed out'}")
                continue
            got[rank] = (ok, val)
        for p in self.procs.values():
            p.join(timeout=60)
        self.terminate()
        failed = {r: v for r, (ok, v) in got.items() if not ok}
        bad = {r: p.exitcode for r, p in self.procs.items() if p.exitcode != 0}
        if failed or bad:
            raise RuntimeError("rank failure: " + "; ".join(
                [f"rank {r}: {v}" for r, v in sorted(failed.items())]
                + [f"rank {r} exit code {c}" for r, c in sorted(bad.items()) if r not in failed]))
        return {r: v for r, (_, v) in got.items()}


def spawn(fn, world: int, *, backend: str, init_file: str, args=(),
          device: str = "cuda", ranks=None) -> RankProcs:
    """Start ``ranks`` (default: all ``world``) as ``spawn``-method processes,
    each running ``fn(rank, world, device, *args)`` in the default group of
    ``world`` ranks over ``backend`` (``init_file``: a fresh path).  ``fn``
    and ``args`` are pickled: ``fn`` must be importable by module path."""
    mesh_device_type(backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = {}
    for r in (range(world) if ranks is None else ranks):
        p = ctx.Process(target=_rank_entry, daemon=True,
                        args=(fn, r, world, backend, init_file, device, tuple(args), results))
        p.start()
        procs[r] = p
    return RankProcs(procs, results)


class LeadRank:
    """This process as rank 0 of a ``world``-rank group, ranks 1.. spawned
    to run ``worker(rank, world, device, *args)``.

    ``with LeadRank(...) as lead:`` starts the ranks and joins the group
    (``lead.device`` is rank 0's device); on a clean exit the group is torn
    down and the workers' results land in ``lead.results`` ({rank: value});
    if the body raises, the workers are stopped and the error propagates.
    Either way no process outlives the block."""

    def __init__(self, worker, world: int, *, backend: str, device: str = "cuda",
                 args=()):
        self.worker, self.world, self.backend = worker, int(world), backend
        self.device_name, self.args = device, tuple(args)
        self.results: dict = {}
        self.device = None
        self._dir = self._procs = None

    def __enter__(self) -> "LeadRank":
        rank_device(0, self.device_name)  # no card: fail before spawning
        self._dir = tempfile.mkdtemp(prefix="rank-group-")
        init_file = os.path.join(self._dir, "init")
        self._procs = spawn(self.worker, self.world, backend=self.backend,
                            init_file=init_file, args=self.args, device=self.device_name,
                            ranks=range(1, self.world))
        try:
            self.device = init_rank(0, self.world, backend=self.backend,
                                    init_file=init_file, device=self.device_name)
        except BaseException:
            self._procs.terminate()
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                dist.destroy_process_group()
                self.results = self._procs.join()
            else:
                self._procs.terminate()
                if dist.is_initialized():
                    dist.destroy_process_group()
        finally:
            self._procs.terminate()
            shutil.rmtree(self._dir, ignore_errors=True)
        return False
