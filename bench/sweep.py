"""The knee of an open-loop cell: its mix at a list of request rates, one
process, one set-up.

    python3 bench/sweep.py --workload deep1m.online --seed 5 --seconds 10 \\
        --rates 1000 1400 1800 2200

For each rate it prints the offered and achieved rates (requests and
queries a second), the backlog at the window's end (rows of the requests
due by then and not yet answered, one batch in flight among them), how
long the front end took to answer them after the window, and ``p50_ms`` /
``p95_ms`` over every request.  The knee is the highest rate whose backlog
at the window's end is under two batches: the batch in flight and under
one batch queued.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import use_checkout  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    use_checkout()
    import torch

    from bench import harness, loadgen, manifest, stats

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    spans = harness.Spans(False)
    p = harness.prepare(cell, args.seed, device="cuda", t_start=T_START, spans=spans)
    for rate in args.rates:
        traffic = dict(cell.traffic, arrivals={"kind": "open", "phases": [[1.0, rate]]})
        sched = harness.front_end(traffic, p)
        w = loadgen.drive(sched, loadgen.Pool(p.pool), loadgen.Mix(traffic, args.seed),
                          args.seconds, spans)
        lat = [(s.req.completed_at - s.due) * 1e3 if s.req.status == "served" else float("inf")
               for s in w.sent]
        rows = sum(s.rows for s in w.sent)
        t_end = w.start + args.seconds
        answered = sum(s.rows for s in w.sent
                       if s.req.status == "served" and s.req.completed_at <= t_end)
        print(json.dumps({
            "offered_rps": rate, "requests": len(w.sent),
            "achieved_rps": len(w.sent) / (w.end - w.start),
            "achieved_qps": rows / (w.end - w.start),
            "backlog_rows": rows - answered, "tail_ms": (w.end - t_end) * 1e3,
            "batches": sched.stats["batches"],
            "batch_fill": sched.stats["rows"] / max(sched.stats["rows"]
                                                     + sched.stats["padded_rows"], 1),
            "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95),
            "late_ms_max": max(w.late_ms) if w.late_ms else 0.0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
