"""The benchmark's entry: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload deep1m.batch --seed 1234 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA devices.
Prints the set-up's parts, the window's figures and each number compared
beside its limit on standard error, and the result as one JSON object on
the last line of standard output.  Exits 2 without a result where the
devices are missing, 3 where a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Build and kernel caches at fixed paths inside the checkout, set before the
# program loads: a kernel a later change adds finds its cache where the
# next run of the cell looks.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the loaded modules), those whose top-level
    name, compared whole, is a JAX one or the JAX package's."""
    return sorted({m for m in (sys.modules if names is None else names)
                   if m.split(".")[0] in FORBIDDEN})


def use_checkout() -> None:
    """Import the program from this checkout; keep its caches inside it."""
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "bench" / "_cache" / sub)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    use_checkout()
    import torch

    from bench import harness, manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
