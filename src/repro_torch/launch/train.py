"""Fault-tolerant training driver (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        [--reduced] --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--fail-at 37] [--device cpu] [--deterministic] \\
        [--devices N --dist-backend nccl|gloo] [--grad-compress] [--resume]

Runs on the card (``--device cuda``, the default) unless asked for the
CPU; ``--reduced`` gives a model small enough for the CPU.  The loop is
``repro_torch.runtime.fault_tolerance.TrainRunner``: asynchronous
checkpoints every ``--ckpt-every`` steps, restart-from-latest on failure
(``--fail-at`` injects one for chaos drills), straggler tracking,
stateless data skip-ahead.  ``--deterministic`` runs the card's ops with
deterministic algorithms (``torch.use_deterministic_algorithms``, warning
where PyTorch has none), so a restarted run can equal an uninterrupted one
bit for bit.

``--devices N`` (N > 1) spawns N rank processes (``launch.mesh.spawn``)
over ``--dist-backend`` (default nccl on cuda, gloo on cpu; ranks sharing
one card need gloo: NCCL refuses two ranks on one device) on the
reference's (data=N, model=1) mesh: the data-parallel step of
``launch.steps.DataParallel``, each rank holding its pieces of the
parameters and moments, every rank reading the same global batch and
taking its rows.  ``--grad-compress`` (at any N, one process included)
passes the summed gradient through the int8 error-feedback all-reduce;
its error buffer is part of the checkpointed state (params, opt_state,
ebuf), replicated on every rank.  ``--resume`` restores the latest
checkpoint, whatever rank count wrote it.  Exits nonzero if the last
step's loss is above the first's.
"""

from __future__ import annotations

import argparse
import math
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
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of --devices > 1: nccl (a card per rank) "
                         "or gloo (ranks sharing a card, or the CPU); default nccl on "
                         "cuda, gloo on cpu")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be at least 1")
    if args.dist_backend is None:
        args.dist_backend = "nccl" if args.device == "cuda" else "gloo"
    if args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl needs --device cuda")
    return args


def _train(args: argparse.Namespace, device, mesh=None) -> tuple:
    """One process's (or one rank's) run: (final state, the runner's info).
    ``mesh``: the ranks' (data, model=1) mesh, or None in one process."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.steps import DataParallel, train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.fault_tolerance import TrainRunner

    if args.deterministic:
        # an op PyTorch has no deterministic CUDA version of (a float cumsum:
        # the SSD scan's) warns instead of failing; a restarted drill then
        # checks the outcome bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=device).requires_grad_(True)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    full = dict(model.named_parameters())
    ebuf = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in full.items()} if args.grad_compress else None)
    if mesh is None:
        dp, params, shardings = None, full, None
    else:
        dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh))
        params = dp.local_params(model)
        shardings = dp.state_shardings(model, ebuf)
    opt_state = adamw_init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0)

    def step_fn(state, batch):
        params, opt_state, ebuf = state
        params, opt_state, mets = train_step(model, opt_cfg, params, opt_state, batch,
                                             dp=dp, ebuf=ebuf)
        return (params, opt_state, ebuf), {"loss": float(mets["loss"]),
                                           "grad_norm": float(mets["grad_norm"])}

    # every rank reads the same global batch and takes its rows in the step
    runner = TrainRunner(step_fn=step_fn, batch_fn=pipe.batch_at,
                         ckpt=CheckpointManager(args.ckpt_dir, keep=2),
                         ckpt_every=args.ckpt_every, shardings=shardings)
    lead = mesh is None or mesh.get_rank() == 0
    start = 0
    state = (params, opt_state, ebuf)
    if args.resume:
        latest = runner.ckpt.latest_step()
        if latest is not None:
            state = runner.ckpt.restore(latest, state, shardings=shardings)
            start = latest
            if lead:
                print(f"[resume] from step {latest}")

    fail_at = {args.fail_at: 1} if args.fail_at is not None else None
    return runner.run(state, start_step=start, num_steps=args.steps, fail_at=fail_at,
                      log_every=10 if lead else 0)


def train_rank(rank: int, world: int, device, args: dict) -> dict:
    """Rank ``rank`` of ``--devices`` ranks (run by ``launch.mesh.spawn``):
    trains on its pieces of the state; returns the runner's info."""
    from repro_torch.launch.mesh import make_host_mesh, mesh_device_type

    args = argparse.Namespace(**args)
    mesh = make_host_mesh(data=world, model=1, device_type=mesh_device_type(args.dist_backend))
    _, info = _train(args, device, mesh)
    return info


def main(argv=None) -> tuple:
    """Train as the flags say; returns (final state, the runner's info).
    With ``--devices`` > 1 the state stays in the ranks (read it from the
    checkpoints): (None, rank 0's info)."""
    args = parse_args(argv)
    if args.deterministic:  # before the first cuBLAS call (the ranks inherit it)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from repro_torch._device import resolve_device

    dev = resolve_device(args.device)
    if args.devices == 1:
        state, info = _train(args, dev)
    else:
        from repro_torch.launch.mesh import spawn

        host = " (host-staged)" if args.dist_backend == "gloo" and dev.type == "cuda" else ""
        print(f"[ranks] {args.devices} ranks over {args.dist_backend}{host} on {args.device}",
              flush=True)
        with tempfile.TemporaryDirectory(prefix="train-ranks-") as tmp:
            out = spawn(train_rank, args.devices, backend=args.dist_backend,
                        init_file=os.path.join(tmp, "init"), args=(vars(args),),
                        device=args.device).join(timeout_s=math.inf)
        state, info = None, out[0]
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
