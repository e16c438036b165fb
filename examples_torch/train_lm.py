"""Example 2: fault-tolerant LM training with an injected mid-run failure,
on the PyTorch/CUDA port.

Runs a reduced mamba2 config for 60 steps, kills step 35 once, and shows the
runner restoring from the latest checkpoint and converging anyway.

    PYTHONPATH=src python examples_torch/train_lm.py [--device cpu]

It trains on the card unless ``--device cpu`` is given; the checkpoints go
to a fresh directory under the system's temporary directory, removed at the
end.
"""
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_example-")
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "mamba2-130m", "--reduced",
        "--steps", "60", "--batch", "8", "--seq", "64",
        "--ckpt-dir", ckpt, "--ckpt-every", "10",
        "--fail-at", "35", *argv,
    ]
    src = str(Path(__file__).resolve().parents[1] / "src")
    path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p)
    try:
        return subprocess.call(cmd, env={**os.environ, "PYTHONPATH": path})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
