"""Dry run of EVERY (architecture x input shape) cell on the production
layouts, on ``device="meta"`` (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with GSPMD for a 512-device
mesh and reads XLA's memory and cost analysis.  Here every model and every
argument lives on ``device="meta"`` (shapes and dtypes, nothing
allocated), the layouts are ``distributed.sharding.AbstractMesh`` (16 x 16
and 2 x 16 x 16 ranks) and each record comes from the cell's shardings and
from ``launch.op_census`` runs of its step:

  * ``memory.argument_bytes``: the sum of ``spec_bytes`` over every leaf of
    the cell's ``in_shardings``: one rank's share of parameters, AdamW
    moments, batch and caches under the reference's layout;
    ``alias_bytes``: the arguments the reference donates (train: params and
    opt_state; decode: the caches), which the port updates in place;
    ``output_bytes``: the step's outputs under the same rules;
    ``temp_bytes``: the census's ``peak_bytes`` of one (data, model)
    rank's step (:func:`rank_step`: its rows of the batch, its model
    pieces of the caches, the model axis executed by
    ``sharding.constrain`` with a ``sharding.RankView`` in place of the
    process group, whose collectives return their shapes and are counted)
    plus the rank's model pieces of the parameters, whole along "data"
    (:func:`model_piece_bytes`, kept as ``model_piece_bytes``): the train
    step all-gathers them once and a serving rank keeps them for the whole
    step, as XLA's temp holds the gathered weights;
  * ``cost``: the census of the whole global step divided by the device
    count — the even split, which no partition beats, so a roofline's lower
    bound (``cost.basis`` says so);
  * ``collectives``: what that rank's step moves (:func:`rank_collectives`):
    the model axis's activation collectives as the census counted them,
    and in training ``DataParallel``'s own (``data_parallel``): the
    all-gather of the model pieces along "data" and the all-reduce of
    their gradients over the ranks the batch splits over (pod x data);
  * ``dade-ivf`` / ``search_1m``: one rank's step of
    ``annservice.build_search_step`` at its defaults (int8, fused) over
    ``search_input_specs`` with ``corpus_per_device`` rows, the kernel
    counting its least work (``kernels.ivf_scan.work``; each record keeps
    its hand-written kernels' rows under ``census.kernels``); its collectives
    are the seeds' ``MIN`` all-reduce and the top-k windows' all-gather
    along each mesh dimension.

Every figure is a count at data-sheet constants, not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells, both layouts
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multipod-only --jobs 4

Records stream into ``results/dryrun_torch/<mesh>/<arch>__<shape>.json`` (or
``--results DIR``), so the run is resumable and ``launch.roofline`` reads
from disk.  ``compile_s`` holds the dry run's seconds for the cell.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch

from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.configs.dade_ivf import CONFIG as SVC_CONFIG
from repro_torch.distributed.sharding import (MODEL_AXIS, RankView, Sharding, local_shape,
                                              make_rules, mesh_axis_sizes, spec_bytes,
                                              tree_shardings, use_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_census import Census
from repro_torch.launch.roofline import RESULTS
from repro_torch.launch.specs import SHAPES, cell_is_runnable
from repro_torch.launch.steps import (RULE_OVERRIDES, bind_model_pieces, build_cell,
                                     model_specs, row_split, train_step)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["run_cell", "memory", "rank_step", "rank_collectives", "rank_args", "step_args",
           "model_piece_bytes",
           "cut_batch",
           "leaves", "tensor_bytes", "MESHES", "main"]

MESHES = {"pod16x16": dict(multi_pod=False), "pod2x16x16": dict(multi_pod=True)}
# Ops kept per record (by bytes), out of the global census's table.
TOP_OPS = 8


def leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and named tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _pairs(tensors, shardings) -> list:
    """(tensor, Sharding) pairs of two trees of the same structure (dicts
    matched by key)."""
    if isinstance(shardings, Sharding):
        return [(tensors, shardings)]
    if isinstance(shardings, dict):
        return [p for k in shardings for p in _pairs(tensors[k], shardings[k])]
    if len(tensors) != len(shardings):
        raise ValueError(f"{len(tensors)} leaves against {len(shardings)} shardings")
    return [p for t, sh in zip(tensors, shardings) for p in _pairs(t, sh)]


def _placed_bytes(tensors, shardings, mesh) -> int:
    return sum(spec_bytes(t, sh.spec, mesh) for t, sh in _pairs(tensors, shardings))


def step_args(cell) -> tuple:
    """The reference's arguments of ``cell``'s step, in the order of its
    ``in_shardings``: the port binds the parameters into the prefill and
    decode steps, the reference passes them first."""
    if cell.kind == "train":
        return cell.args
    return (dict(cell.model.named_parameters()), *cell.args)


def tensor_bytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree``."""
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _axes_like(axes, tree):
    """The logical axes of ``tree`` from a cache-axes tree whose named
    tuples may hold more fields (a prefill returns an int8 cache's
    ``KVCache`` before quantizing it: its k and v)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_axes_like(getattr(axes, f), getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _axes_like(axes[k], v) for k, v in tree.items()}
    return axes


def memory(cell, mesh, out=None) -> dict:
    """(argument, alias, output) bytes of one rank under ``cell``'s
    shardings; ``out`` is the global step's output (meta tensors), without
    which ``output_bytes`` is None."""
    mem = {"argument_bytes": _placed_bytes(step_args(cell), cell.in_shardings, mesh)}
    if cell.kind == "train":
        state = _placed_bytes(cell.args[:2], cell.in_shardings[:2], mesh)
        mem["alias_bytes"] = state
        mem["output_bytes"] = None if out is None else state + tensor_bytes(out[2])
    elif cell.kind == "decode":
        mem["alias_bytes"] = _placed_bytes(cell.args[1], cell.in_shardings[2], mesh)
        mem["output_bytes"] = None if out is None else _placed_bytes(out, cell.out_shardings,
                                                                     mesh)
    else:
        mem["alias_bytes"] = 0
        mem["output_bytes"] = None
        if out is not None:
            logits, caches = out
            rules = RULE_OVERRIDES.get(cell.shape)
            _, cache_axes = cell.model.init_caches(logits.shape[0], SHAPES[cell.shape].seq)
            out_sh = (tree_shardings(("batch", "vocab"), logits, mesh, rules),
                      tree_shardings(_axes_like(cache_axes, caches), caches, mesh, rules))
            mem["output_bytes"] = _placed_bytes(out, out_sh, mesh)
    return mem


def _rules(cell, overrides: dict | None) -> dict:
    rules = dict(RULE_OVERRIDES.get(cell.shape, {}))
    rules.update(overrides or {})
    return rules


def rank_step(cell, mesh, overrides: dict | None = None):
    """(census, output) of one (data, model) rank's step of ``cell`` (built
    on meta over the ``AbstractMesh`` ``mesh``), on meta: a model holding
    the rank's model pieces, its rows of the batch (and of the decode
    caches, its pieces of them), under ``use_rules`` over a ``RankView``
    of the mesh at coordinate 0, whose collectives the census counts.  A
    train step updates the rank's model pieces (``DataParallel``'s
    data-axis collectives are :func:`rank_collectives`')."""
    view = RankView(mesh.axis_sizes, mesh.axis_names, (0,) * mesh.ndim)
    rules = _rules(cell, overrides)
    model = build_model(cell.model.cfg, device="meta")
    full = dict(model.named_parameters())
    bind_model_pieces(model, model_specs(tree_shardings(model.param_axes(), full, view,
                                                        rules)), view)
    args = rank_args(cell, mesh)
    with use_rules(view, rules):
        if cell.kind == "train":
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            fn, args = (lambda p, o, b: train_step(model, AdamWConfig(), p, o, b),
                        (params, adamw_init(params), args[2]))
        elif cell.kind == "prefill":
            fn = model.prefill
        else:
            token, _, pos = args
            caches, _ = model.init_caches(token.shape[0], SHAPES[cell.shape].seq)
            fn, args = model.decode_step, (token, caches, pos)
        return _counted(fn, args, f"{cell.kind}_step")


def model_piece_bytes(cell, mesh, overrides: dict | None = None) -> int:
    """The bytes of one rank's model pieces of ``cell``'s parameters over
    ``mesh``: each whole along every axis but "model" (``steps.
    model_specs``), as ``bind_model_pieces`` binds them and the rank holds
    them through its step."""
    shapes = dict(cell.model.named_parameters())
    specs = model_specs(tree_shardings(cell.model.param_axes(), shapes, mesh,
                                       _rules(cell, overrides)))
    return sum(math.prod(local_shape(tuple(p.shape), specs[k], mesh)) * p.element_size()
               for k, p in shapes.items())


def rank_collectives(cell, mesh, rank_census: dict, overrides: dict | None = None) -> dict:
    """What one rank's step moves: the model axis's collectives counted in
    ``rank_census`` (:func:`rank_step`'s), and in a train step
    ``DataParallel``'s (also apart, as ``data_parallel``): each model piece
    split along "data" all-gathered whole (its output bytes; ``param
    all-gather``) and the gradients all-reduced (``gradient all-reduce``,
    in the parameters' dtype at ``grad_accum`` 1, float32 above): every
    one where the batch splits over the batch's ranks (``steps.row_split``:
    pod x data, or the prefix of them the rows divide by), else those of
    the leaves the model axis replicates, over the model ranks."""
    by_kind = dict(rank_census["coll_by_kind"])
    count = dict(rank_census["coll_count_by_kind"])
    dp_kinds = {}
    if cell.kind == "train":
        sizes = mesh_axis_sizes(mesh)
        rules = _rules(cell, overrides)
        batch_axes = tuple(nm for nm in make_rules(mesh, rules).table["batch"] if nm in sizes)
        shapes = dict(cell.model.named_parameters())
        sh = tree_shardings(cell.model.param_axes(), shapes, mesh, rules)
        pieces = model_specs(sh)
        ga = max(cell.model.cfg.grad_accum, 1)
        split = row_split(sizes, batch_axes, cell.args[2]["tokens"].shape[0], ga)[0] > 1
        tp = sizes.get(MODEL_AXIS, 1) > 1
        gathered = grads = 0.0
        n_gathered = 0
        for k, p in shapes.items():
            local = math.prod(local_shape(tuple(p.shape), pieces[k], mesh))
            if any(part and a != MODEL_AXIS and sizes[a] > 1
                   for part in sh[k].spec for a in (part or ())):
                gathered += local * p.element_size()
                n_gathered += 1
            if split or (tp and not any(pieces[k])):
                grads += local * (p.element_size() if ga == 1 else 4)
        dp_kinds = {"param all-gather": gathered, "gradient all-reduce": grads}
        if n_gathered:
            by_kind["all-gather"] = by_kind.get("all-gather", 0) + gathered
            count["all-gather"] = count.get("all-gather", 0) + n_gathered
        if grads:
            by_kind["all-reduce"] = by_kind.get("all-reduce", 0) + grads
            count["all-reduce"] = count.get("all-reduce", 0) + 1
    return {"bytes_by_kind": by_kind, "count_by_kind": count,
            "total_bytes": sum(by_kind.values()), "data_parallel": dp_kinds,
            "basis": "what one (data, model) rank's step moves: the model axis's "
                     "collectives counted by the census of its step on meta, and in "
                     "training the model pieces' all-gather along 'data' and their "
                     "gradients' all-reduce over the batch's ranks"}


def _local_rows(rows: int, spec_part, mesh, ga: int = 1) -> int:
    """One rank's rows of a batch dimension of ``rows`` split over the mesh
    axes ``spec_part`` in ``ga`` microbatches (each microbatch's rows split
    when they divide, as ``DataParallel`` splits them)."""
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in (spec_part or ()))
    return rows // n if rows % (ga * n) == 0 else rows


def cut_batch(batch: dict, rows: int) -> dict:
    """``batch`` (meta tensors) cut to its first ``rows`` rows."""
    return {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype, device=v.device)
            for k, v in batch.items()}


def rank_args(cell, mesh) -> tuple:
    """The arguments of one data rank's step: its rows of the batch (and
    of the decode caches), everything else as the global step's."""
    if cell.kind == "train":
        params, opt, batch = cell.args
        rows = _local_rows(batch["tokens"].shape[0], cell.in_shardings[2]["tokens"].spec[0],
                           mesh, max(cell.model.cfg.grad_accum, 1))
        return params, opt, cut_batch(batch, rows)
    if cell.kind == "prefill":
        (batch,) = cell.args
        return (cut_batch(batch, _local_rows(batch["tokens"].shape[0],
                                             cell.in_shardings[1]["tokens"].spec[0], mesh)),)
    token, _, pos = cell.args
    rows = _local_rows(token.shape[0], cell.in_shardings[1].spec[0], mesh)
    caches, _ = cell.model.init_caches(rows, SHAPES[cell.shape].seq)
    return token[:rows], caches, pos


def _counted(fn, args, name: str):
    with Census(name) as cen:
        out = fn(*args)
    return cen.result(), out


def _split(cen: dict, devices: int) -> dict:
    return {"flops": cen["flops"] / devices, "bytes": cen["bytes"] / devices,
            "flops_by_class": {k: v / devices for k, v in cen["flops_by_class"].items()}}


def _top_ops(cen: dict) -> list:
    rows = sorted(cen["by_op"].items(), key=lambda kv: -kv[1]["bytes"])[:TOP_OPS]
    return [[k, v["count"], v["flops"], v["bytes"]] for k, v in rows]


def _search_cell(rec: dict, mesh) -> dict:
    from repro_torch.launch import annservice

    svc = SVC_CONFIG
    rec["kind"] = "search"
    specs = annservice.search_input_specs(svc, mesh, quant="int8", fused=True)
    axes = tuple(mesh_axis_sizes(mesh))
    shardings = tuple(Sharding(mesh, (axes,) + (None,) * (len(s.shape) - 1)
                               if s.placements[0].is_shard() else (None,) * len(s.shape),
                               s.placements) for s in specs)
    glob_args = [torch.empty(s.shape, dtype=s.dtype, device="meta") for s in specs]
    local = [torch.empty((svc.corpus_per_device, *s.shape[1:]) if s.placements[0].is_shard()
                         else s.shape, dtype=s.dtype, device="meta") for s in specs]
    step = annservice.build_search_step(svc)
    cen, out = _counted(step, local, "search_step")
    qn, k = svc.query_batch, svc.k
    sizes = mesh_axis_sizes(mesh)
    by_kind = {"all-reduce": 4.0 * qn * len(sizes),
               "all-gather": float(sum(n * qn * k * 8 for n in sizes.values()))}
    coll = {"bytes_by_kind": by_kind, "count_by_kind": {"all-reduce": len(sizes),
                                                        "all-gather": len(sizes)},
            "total_bytes": sum(by_kind.values()),
            "basis": "layout minimum: the seeds' MIN all-reduce and the top-k windows' "
                     "all-gather along each mesh dimension"}
    args_b = sum(spec_bytes(t, sh.spec, mesh) for t, sh in zip(glob_args, shardings))
    return _finish(rec, {"argument_bytes": args_b,
                         "output_bytes": tensor_bytes(out),
                         "alias_bytes": 0},
                   cost=dict(_split(cen, 1), basis="one rank's step"), coll=coll, cen=cen,
                   temp=cen["peak_bytes"]), cen


def _finish(rec, mem, *, cost, coll, cen, temp) -> dict:
    mem["temp_bytes"] = temp
    rec.update({
        "status": "ok",
        "memory": mem,
        "cost": {"flops": cost["flops"], "bytes_accessed": cost["bytes"],
                 "flops_by_class": cost["flops_by_class"], "basis": cost["basis"]},
        "collectives": coll,
        "census": {"flops": cost["flops"], "bytes": cost["bytes"],
                   "collective_bytes": coll["total_bytes"],
                   "coll_by_kind": coll["bytes_by_kind"],
                   "coll_count_by_kind": coll["count_by_kind"], "loops": {},
                   "entry": cen["entry"], "flops_by_class": cost["flops_by_class"],
                   "peak_bytes": temp, "step_flops": cen["flops"],
                   "step_bytes": cen["bytes"], "top_ops": _top_ops(cen),
                   "kernels": {k: v for k, v in cen["by_op"].items() if v.get("kernel")}},
    })
    return rec


def run_cell(arch: str, shape: str, mesh, mesh_name: str | None = None, *,
             cache: dict | None = None, overrides: dict | None = None,
             cfgset: dict | None = None, keep_ops: bool = False) -> dict:
    """The record of one cell on ``mesh`` (an ``AbstractMesh``), its rules
    and config changed by ``overrides`` and ``cfgset`` as ``build_cell``
    takes them.  ``cache`` ({(arch, shape): (census, output)}) shares the
    global step's census between layouts: the global step does not depend
    on the layout.  ``keep_ops`` keeps the census's whole per-op table
    (``census.by_op``)."""
    t0 = time.perf_counter()
    sizes = mesh_axis_sizes(mesh)
    rec: dict = {"arch": arch, "shape": shape,
                 "mesh": mesh_name or "pod" + "x".join(map(str, sizes.values())),
                 "devices": math.prod(sizes.values()), "group_ranks": max(sizes.values())}
    if arch == "dade-ivf":
        rec, cen = _search_cell(rec, mesh)
    else:
        ok, why = cell_is_runnable(get_config(arch), shape)
        if not ok:
            rec["status"] = "skipped"
            rec["reason"] = why
            return rec
        cell = build_cell(arch, shape, mesh=mesh, device="meta", overrides=overrides,
                          cfgset=cfgset)
        rec["kind"] = cell.kind
        cache = {} if cache is None else cache
        if (arch, shape) not in cache:
            cache[(arch, shape)] = _counted(cell.step_fn, cell.args, f"{cell.kind}_step")
        cen, out = cache[(arch, shape)]
        rank, _ = rank_step(cell, mesh, overrides)
        mem = memory(cell, mesh, out)
        mem["model_piece_bytes"] = model_piece_bytes(cell, mesh, overrides)
        rec = _finish(rec, mem,
                      cost=dict(_split(cen, rec["devices"]),
                                basis="even split: the global step's counts / devices "
                                      "(a roofline lower bound)"),
                      coll=rank_collectives(cell, mesh, rank, overrides), cen=cen,
                      temp=rank["peak_bytes"] + mem["model_piece_bytes"])
        rec["temp_basis"] = ("peak live bytes of one (data, model) rank's step on meta (its "
                             "batch rows, its model pieces of the caches; a RankView in "
                             "place of the process group) plus its model pieces of the "
                             "parameters whole along 'data' (model_piece_bytes)")
    if keep_ops:
        rec["census"]["by_op"] = cen["by_op"]
    rec["compile_s"] = round(time.perf_counter() - t0, 1)
    return rec


def _run_unit(arch: str, shape: str, meshes: list, results: str, force: bool) -> list:
    """Every layout's record of one cell (one census of the global step);
    returns (mesh, status line, failure or None) for each."""
    torch.set_num_threads(1)
    cache: dict = {}
    lines = []
    for mesh_name in meshes:
        out = os.path.join(results, mesh_name, f"{arch}__{shape}.json")
        if os.path.exists(out) and not force:
            lines.append((mesh_name, f"[cached] {mesh_name} {arch} {shape}", None))
            continue
        try:
            rec = run_cell(arch, shape, make_production_mesh(**MESHES[mesh_name]), mesh_name,
                           cache=cache)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec.get("status")
        if status == "ok":
            m = rec["memory"]
            extra = (f" args={m['argument_bytes'] / 2**30:.2f}GiB "
                     f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
                     f"flops={rec['cost']['flops']:.3g} "
                     f"coll={rec['collectives']['total_bytes']:.3g}B ({rec['compile_s']}s)")
        elif status == "skipped":
            extra = f" ({rec['reason']})"
        else:
            extra = f" {rec.get('error', '')[:140]}"
        fail = (mesh_name, arch, shape, rec.get("error", "")[:120]) if status == "error" else None
        lines.append((mesh_name, f"[{status}] {mesh_name} {arch} {shape}{extra}", fail))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--results", default=None,
                    help=f"where the records go (default {os.path.normpath(RESULTS)})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, one torch thread each")
    args = ap.parse_args(argv)
    results = args.results or RESULTS

    meshes = [m for m, kw in MESHES.items()
              if not (args.multipod_only and not kw["multi_pod"])
              and not (args.single_only and kw["multi_pod"])]
    for m in meshes:
        os.makedirs(os.path.join(results, m), exist_ok=True)
    archs = [args.arch] if args.arch else LM_ARCHS + ["dade-ivf"]
    units = [(arch, shape) for arch in archs
             for shape in ([args.shape] if args.shape
                           else (list(SHAPES) if arch != "dade-ivf" else ["search_1m"]))]
    # the slowest kind first, so that the workers finish together
    units.sort(key=lambda u: (u[1] != "train_4k", u[1] != "prefill_32k"))
    failures = []

    def report(lines):
        for _, line, fail in lines:
            print(line, flush=True)
            if fail:
                failures.append(fail)

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if args.jobs <= 1:
        for arch, shape in units:
            report(_run_unit(arch, shape, meshes, results, args.force))
    else:
        import multiprocessing as mp
        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as pool:
            jobs = [pool.submit(_run_unit, a, s, meshes, results, args.force)
                    for a, s in units]
            for job in as_completed(jobs):
                report(job.result())

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        return 1
    print(f"\nDry-run complete: {len(units)} cells x {len(meshes)} layouts in "
          f"{time.perf_counter() - t0:.1f}s.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
