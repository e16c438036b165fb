"""Hillclimb harness: one cell's census under rule / config variants, the
three roofline terms and the memory a rank holds, so that a
hypothesis -> change -> measure cycle takes one command (the port of
``repro.launch.perf``).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch mixtral-8x7b \\
        --shape train_4k [--override expert=model] [--multipod] [--dump-ops ops.json]

On ``device="meta"`` (the default) the census runs the global step, and the
terms are its even split over the layout's devices (``launch.dryrun``):
counts at the H100's data-sheet constants, not measurements.  With
``--device cuda`` the same census runs one step on the card, at ``--rows``
rows of the batch (default: one data rank's share), and the terms are that
step's; the allocator's ``max_memory_allocated`` stands beside the census's
peak.  ``--dump-ops PATH`` writes the census's per-op table (the reference's
``--dump-hlo``); ``--json PATH`` the whole result.  The reference's
``--no-two-phase`` has no counterpart: the port's search step always seeds
its threshold from a first wave.
"""

from __future__ import annotations

import argparse
import ast
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_census import Census
from repro_torch.launch.roofline import H100, analyse, model_flops
from repro_torch.launch.specs import SHAPES
from repro_torch.launch.steps import build_cell

__all__ = ["run", "materialize", "main"]


def materialize(tree, device):
    """Tensors on ``device`` shaped as the meta tensors of ``tree``: integer
    leaves (tokens, labels) zero, float leaves standard normal from seed 0;
    on meta, ``tree`` itself."""
    if torch.device(device).type == "meta":
        return tree
    gen = torch.Generator(device=device).manual_seed(0)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(walk, x))
        if isinstance(x, (list, tuple)):
            return type(x)(map(walk, x))
        return one(x)

    return walk(tree)


def _step_args(cell, meta, mesh, device, rows):
    """The arguments of one step of ``cell`` on ``device``: one data rank's
    rows of the batch (or ``rows`` rows), the model's own parameters and
    fresh AdamW moments, zeroed caches."""
    if rows is None:
        local = dryrun.rank_args(meta, mesh)
        rows = (local[-1] if meta.kind != "decode" else {"tokens": local[0]})
        rows = next(iter(rows.values())).shape[0]
    if cell.kind == "train":
        from repro_torch.optim.adamw import adamw_init

        params = dict(cell.model.named_parameters())
        opt = cell.args[1] if device == "meta" else adamw_init(params)
        return params, opt, materialize(dryrun.cut_batch(meta.args[2], rows), device)
    if cell.kind == "prefill":
        return (materialize(dryrun.cut_batch(meta.args[0], rows), device),)
    token = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    caches, _ = cell.model.init_caches(rows, SHAPES[cell.shape].seq)
    return token, caches, torch.zeros((), dtype=torch.int32, device=device)


def run(arch: str, shape: str, *, multipod: bool = False, overrides: dict | None = None,
        cfgset: dict | None = None, donate: bool = True, device: str = "meta",
        cell=None, args: tuple | None = None, rows: int | None = None,
        dump_ops: str | None = None, quiet: bool = False) -> dict:
    """Census one step of the cell, print the reference's lines and return
    {"census", "terms" (seconds by term), "bound", "memory" (a rank's
    bytes), "even_split", "max_memory_allocated" (cuda) or a skip's
    {"status", "reason"}}.

    On meta without ``rows`` or ``cell``, and for ``dade-ivf`` on any
    device: the dry run's record of the cell (the global step, its even
    split over the layout's devices; the search's one rank's step).
    Otherwise one step as run: ``cell`` (an already built cell, its model on
    ``device``) with ``args`` (its step's arguments there), or the cell
    built on ``device`` with one data rank's rows (or ``rows`` rows) of
    fresh inputs; its terms are that step's, beside the layout's argument
    and alias bytes and, on the card, the allocator's peak.  Its
    collectives: on meta, those of one (data, model) rank's step of the
    layout (``dryrun.rank_step``); on a device, the step's own (one device
    moves nothing between ranks).
    ``donate=False`` counts no argument as updated in place."""
    mesh = make_production_mesh(multi_pod=multipod)
    t0 = time.perf_counter()
    label = (f"{arch} {shape} mesh={'2x16x16' if multipod else '16x16'} "
             f"overrides={overrides} device={device}")
    alloc = None
    if arch == "dade-ivf" or (device == "meta" and rows is None and cell is None):
        rec = dryrun.run_cell(arch, shape, mesh, overrides=overrides, cfgset=cfgset,
                              keep_ops=True)
        if rec["status"] != "ok":
            if not quiet:
                print(f"{label}: {rec['status']}: {rec['reason']}")
            return {"status": rec["status"], "reason": rec["reason"]}
        cen, mem, even = rec["census"], rec["memory"], arch != "dade-ivf"
        terms = analyse(rec)
        t_c, t_m, t_x = terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"]
        per_dev_flops = cen["flops"]
    else:
        meta = build_cell(arch, shape, mesh=mesh, device="meta", overrides=overrides,
                                 cfgset=cfgset)
        if cell is None:
            cell = meta if device == "meta" else build_cell(
                arch, shape, device=device, overrides=overrides, cfgset=cfgset)
        if args is None:
            args = _step_args(cell, meta, mesh, device, rows)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with Census(f"{cell.kind}_step") as c:
            out = cell.step_fn(*args)
        if device == "cuda":
            torch.cuda.synchronize()
            alloc = torch.cuda.max_memory_allocated()
        cen = c.result()
        if device == "meta":  # what one (data, model) rank's step of the layout moves
            coll = dryrun.rank_collectives(meta, mesh,
                                           dryrun.rank_step(meta, mesh, overrides)[0], overrides)
            cen = dict(cen, collective_bytes=coll["total_bytes"],
                       coll_by_kind=coll["bytes_by_kind"],
                       coll_count_by_kind=coll["count_by_kind"])
        mem = dict(dryrun.memory(meta, mesh), output_bytes=dryrun.tensor_bytes(out),
                   temp_bytes=cen["peak_bytes"])
        even = False
        t_c = sum(v / H100.peak(k) for k, v in cen["flops_by_class"].items())
        t_m = cen["bytes"] / H100.hbm_bw
        t_x = cen["collective_bytes"] / H100.link_bw(max(mesh.axis_sizes))
        per_dev_flops = cen["flops"]
    if not donate:
        mem["alias_bytes"] = 0
    if dump_ops:
        with open(dump_ops, "w") as f:
            json.dump(cen["by_op"], f, indent=1)
    bound = max(t_c, t_m, t_x)
    mf = model_flops(arch, shape) / mesh.size() if even else 0.0
    total_mem = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]) / 2**30
    if not quiet:
        print(label + ("" if even else "  (one step as run, not the even split)"))
        print(f"  compute {t_c*1e3:9.2f} ms | memory {t_m*1e3:9.2f} ms | "
              f"collective {t_x*1e3:9.2f} ms | bound "
              f"{'CMX'[[t_c, t_m, t_x].index(bound)]}  ({H100.name} data-sheet counts)")
        print(f"  hbm/device: args={mem['argument_bytes']/2**30:.2f} "
              f"out={mem['output_bytes']/2**30:.2f} "
              f"temp={mem['temp_bytes']/2**30:.2f} "
              f"alias={mem['alias_bytes']/2**30:.2f} total={total_mem:.2f} GiB"
              + ("" if alloc is None else
                 f" | max_memory_allocated={alloc/2**30:.2f} GiB"))
        if mf:
            print(f"  useful={mf/per_dev_flops*100:.1f}%  "
                  f"roofline_frac={(mf/bound)/H100.peak_bf16*100:.2f}%")
        print(f"  coll by kind: "
              f"{ {k: round(v/2**30, 2) for k, v in cen['coll_by_kind'].items()} } GiB")
        print(f"  census {time.perf_counter()-t0:.1f}s")
    return {"census": cen, "terms": {"compute": t_c, "memory": t_m, "collective": t_x},
            "bound": bound, "memory": mem, "even_split": even,
            "max_memory_allocated": alloc}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--dump-ops", default=None, help="write the census's per-op table")
    ap.add_argument("--override", action="append", default=[],
                    help="logical=mesh1+mesh2 rule override, e.g. expert=model")
    ap.add_argument("--no-two-phase", action="store_true")
    ap.add_argument("--cfgset", action="append", default=[],
                    help="ArchConfig field override, e.g. pad_heads_to=64")
    ap.add_argument("--device", default="meta", choices=("meta", "cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=None,
                    help="batch rows of the step (default: one data rank's)")
    ap.add_argument("--json", default=None, help="write the run's result here")
    args = ap.parse_args(argv)
    if args.no_two_phase:
        ap.error("--no-two-phase has no counterpart: the port's search step always seeds "
                 "its threshold from a first wave (annservice.seed_rsq)")
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=")
        overrides[k] = tuple(x for x in v.split("+") if x)
    cfgset = {}
    for cv in args.cfgset:
        k, v = cv.split("=")
        cfgset[k] = type(getattr(get_config(args.arch), k))(ast.literal_eval(v))
    res = run(args.arch, args.shape, multipod=args.multipod, overrides=overrides or None,
              cfgset=cfgset or None, donate=not args.no_donate, device=args.device,
              rows=args.rows, dump_ops=args.dump_ops)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
