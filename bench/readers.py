"""Arithmetic the metric readers (``bench/metrics/<name>.py``) share.  Each
returns None where the run has nothing to read."""

from __future__ import annotations

from bench import work

KERNEL = "ivf_scan_kernel"  # the CUDA kernel's name in the profiler's trace


def kernel_mean_s(run, name: str = KERNEL) -> float | None:
    """Mean device seconds a launch of the kernels whose name holds ``name``."""
    if run.trace is None:
        return None
    hits = [c for n, c in run.trace["kernels"].items() if name in n]
    count = sum(c[0] for c in hits)
    return sum(c[1] for c in hits) / count if count else None


def ivf_scan_bound_s(run) -> float:
    """The least time one launch of the cell's step could take."""
    cfg, s = run.cell.config, run.cell.config["service"]
    d_pad = -(-cfg["dim"] // s["delta_d"]) * s["delta_d"]
    return work.bound_s(work.least_work(queries=run.batch, rows=cfg["rows"], dim=d_pad,
                                        k=run.cell.traffic["k"], block_d=s["delta_d"]))


def step_host_ms(run) -> float | None:
    """Mean over the window's steps of the step's span less the device's
    busy time inside it (ms)."""
    if run.trace is None or not run.trace["step_host_ms"]:
        return None
    h = run.trace["step_host_ms"]
    return sum(h) / len(h)


def idle_share(run) -> float | None:
    """Percent of the traced window in which no operation ran on the device."""
    if run.trace is None or run.trace["device_events"] == 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
