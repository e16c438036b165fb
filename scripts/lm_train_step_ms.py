"""Time the port's one-card LM train step on the card, as chip_smoke.py's
phase 17(a) runs it: ``build_cell(arch, "train_4k")`` at full width and
depth, ``--rows`` rows of the cell's sequence from ``TokenPipeline``, AdamW,
``--warm`` untimed steps, then the median of ``--steps`` timed ones.

    PYTHONPATH=src python scripts/lm_train_step_ms.py --arch gemma-2b \\
        --rows 4 [--label NAME]

Prints one JSON line: the label, the card's name and power limit
(``nvidia-smi``), the step times in ms and their median.  To compare two
trees in one call, run it once with each tree's ``src`` on PYTHONPATH.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> None:
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.specs import SHAPES
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n = a.warm + a.steps
    cell = build_cell(a.arch, "train_4k", device="cuda",
                      opt=AdamWConfig(lr=1e-5, warmup_steps=1, total_steps=n))
    cfg = cell.model.cfg
    params = dict(cell.model.named_parameters())
    opt_state = adamw_init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=a.rows,
                         seq=SHAPES["train_4k"].seq, seed=0)
    times, losses = [], []
    for i in range(n):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, mets = cell.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(mets["loss"]))
    timed = times[a.warm:]
    print(json.dumps({"label": a.label, "card": card(), "arch": a.arch, "rows": a.rows,
                      "seq": SHAPES["train_4k"].seq, "layers": cfg.num_layers,
                      "ms": timed, "median_ms": statistics.median(timed),
                      "warm_ms": times[:a.warm], "losses": losses}))


if __name__ == "__main__":
    main()
