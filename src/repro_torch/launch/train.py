"""Fault-tolerant training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        [--reduced] --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--fail-at 37] [--device cpu] [--deterministic]

Runs on the card (``--device cuda``, the default) unless asked for the
CPU; ``--reduced`` gives a model small enough for the CPU.  The loop is
``repro_torch.runtime.fault_tolerance.TrainRunner``: asynchronous
checkpoints every ``--ckpt-every`` steps, restart-from-latest on failure
(``--fail-at`` injects one for chaos drills), straggler tracking,
stateless data skip-ahead.  ``--deterministic`` runs the card's ops with
deterministic algorithms (``torch.use_deterministic_algorithms``, warning
where PyTorch has none), so a restarted run can equal an uninterrupted one
bit for bit.  The
multi-device flags (``--devices > 1``, ``--grad-compress``) are the
reference's data-parallel mesh: refused by name until ROADMAP queue 1
item 8b-ii.  Exits nonzero if the last step's loss is above the first's.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> tuple:
    """Train as the flags say; returns (final state, the runner's info)."""
    args = parse_args(argv)
    if args.devices > 1 or args.grad_compress:
        raise SystemExit(
            "--devices > 1 and --grad-compress run the reference's data-parallel mesh "
            "(sharded state, compressed all-reduce): not ported yet (ROADMAP queue 1 "
            "item 8b-ii, the multi-device training half)")
    if args.deterministic:  # before the first cuBLAS call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.fault_tolerance import TrainRunner

    dev = resolve_device(args.device)
    if args.deterministic:
        # an op PyTorch has no deterministic CUDA version of (a float cumsum:
        # the SSD scan's) warns instead of failing; a restarted drill then
        # checks the outcome bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev).requires_grad_(True)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0)

    def step_fn(state, batch):
        params, opt_state, ebuf = state
        params, opt_state, mets = train_step(model, opt_cfg, params, opt_state, batch)
        return (params, opt_state, ebuf), {"loss": float(mets["loss"]),
                                           "grad_norm": float(mets["grad_norm"])}

    runner = TrainRunner(step_fn=step_fn, batch_fn=pipe.batch_at,
                         ckpt=CheckpointManager(args.ckpt_dir, keep=2),
                         ckpt_every=args.ckpt_every)
    start = 0
    state = (params, opt_state, None)
    if args.resume:
        latest = runner.ckpt.latest_step()
        if latest is not None:
            state = runner.ckpt.restore(latest, state)
            start = latest
            print(f"[resume] from step {latest}")

    fail_at = {args.fail_at: 1} if args.fail_at is not None else None
    state, info = runner.run(state, start_step=start, num_steps=args.steps,
                             fail_at=fail_at, log_every=10)
    losses = [h["loss"] for h in info["history"]]
    print(f"[done] steps={args.steps} restarts={info['restarts']} "
          f"p50={info['p50_ms']:.0f}ms p95={info['p95_ms']:.0f}ms")
    print(f"[loss] first10={sum(losses[:10])/max(len(losses[:10]),1):.4f} "
          f"last10={sum(losses[-10:])/max(len(losses[-10:]),1):.4f}")
    if losses and losses[-1] > losses[0]:
        sys.exit("loss did not improve")
    return state, info


if __name__ == "__main__":
    main()
