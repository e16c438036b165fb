"""The readings that set the limits of ``correct``: a cell's short runs on
several seeds in one process, with the program (``--side program``) or with
the control in its place (``--side control``: the reference computed in
int8, ``reference.Int8Search``).

    python3 bench/control.py --workload deep1m.batch --side control \\
        --seconds 3 --seeds 11 12 13

Prints one JSON line a seed with each compared number; the limits are not
applied here.
"""

import time

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import use_checkout  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    use_checkout()
    import torch

    from bench import harness, manifest

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        result, checks = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                                          t_start=time.perf_counter(),
                                          control=args.side == "control")
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "numbers": {k: c["value"] for k, c in checks.items()},
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()}}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
