"""Reading a ``torch.profiler`` chrome trace of the window: device busy
time, kernel time by name, the host's spans (``torch.profiler.
record_function`` ranges the harness opened) and the device's idle gaps
named by the innermost span the host was in."""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e, starts) -> float:
    """Length of [s, e] covered by ``merged`` (sorted, disjoint)."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < e:
        tot += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return tot


def innermost(spans, points):
    """For each time in ``points``, the name of the innermost span (from
    ``spans``: (start, end, name), properly nested) that holds it, or
    ``"none"``."""
    ev = [(s, 0, j) for j, (s, _, _) in enumerate(spans)]
    ev += [(e, 2, j) for j, (_, e, _) in enumerate(spans)]
    ev += [(t, 1, j) for j, t in enumerate(points)]
    ev.sort()
    stack, out = [], ["none"] * len(points)
    for _, kind, j in ev:
        if kind == 0:
            stack.append(j)
        elif kind == 2:
            if stack and stack[-1] == j:
                stack.pop()
            elif j in stack:
                stack.remove(j)
        elif stack:
            out[j] = spans[stack[-1]][2]
    return out


def analyse(events: list, span_names) -> dict | None:
    """The window's figures from chrome-trace ``events`` (times in us), or
    None when the trace holds no ``window`` span."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in span_names]
    win = [s for s in spans if s[2] == "window"]
    if not win:
        return None
    w0, w1 = win[0][0], win[0][1]
    dev, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        dev.append((s, t))
        c = kernels.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += (t - s) / 1e6
    merged = _merge(dev)
    starts = [m[0] for m in merged]
    busy = sum(e - s for s, e in merged)
    steps = [(s, e) for s, e, n in spans if n == "step"]
    host = [((e - s) - _overlap(merged, s, e, starts)) / 1e3 for s, e in steps]
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    named = innermost([s for s in spans if s[2] != "window"],
                      [(a + b) / 2 for a, b in gaps])
    idle = {}
    for (a, b), name in zip(gaps, named):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "kernels": kernels,
            "step_host_ms": host, "idle_by_span": idle, "device_events": len(dev)}


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def breakdown(t: dict, top: int = 10) -> dict:
    """The device ops that took most time and the idle time by the span the
    host was in, ``top`` of each, as [name, seconds]."""
    ops = sorted(((n, c[1]) for n, c in t["kernels"].items()), key=lambda x: -x[1])
    idle = sorted(t["idle_by_span"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}
