"""Rank functions of the port's multi-rank tests
(``tests/test_torch_distributed.py``, ``test_torch_train_distributed.py``,
the ``gpu`` ones in ``test_torch_gpu.py``).  A spawned rank imports its function
by module path, so they live here, in a module that imports no JAX."""

import numpy as np
import torch


def topk_rank(rank, world, dev, sq, ids, k):
    """Rank ``rank`` of a 2 x 2 gloo mesh: its (Q, K) window of ``sq`` /
    ``ids`` (indexed (a, b) by its mesh coordinate) through
    ``hierarchical_topk`` over ("b", "a"); with the shape of
    ``make_host_mesh(2, 2)`` and the error it raises for a (4, 2) shape the
    group cannot hold."""
    from repro_torch.distributed.collectives import hierarchical_topk
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    mesh = make_mesh((2, 2), ("a", "b"), "cpu")
    a, b = mesh.get_coordinate()
    out_sq, out_ids = hierarchical_topk(torch.as_tensor(sq[a, b]), torch.as_tensor(ids[a, b]),
                                        mesh, ("b", "a"), k)
    host = make_host_mesh(2, 2)
    try:
        make_host_mesh(4, 2)
        too_big = ""
    except ValueError as e:
        too_big = str(e)
    return out_sq.numpy(), out_ids.numpy(), (tuple(host.shape), host.mesh_dim_names), too_big


def flat_rank(rank, world, dev, svc, rows, codes, bscales, queries, eps, scale, eps_lo,
              shards):
    """Rank ``rank`` of an R-rank flat mesh step over its ``rows`` share;
    with the step's input specs over the mesh (shape, dtype, placement)."""
    from repro_torch.launch.annservice import build_search_step, search_input_specs
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("rank",), "cpu")
    n_local = rows.shape[0] // world
    part = slice(rank * n_local, (rank + 1) * n_local)
    step = build_search_step(svc, with_stats=True, shards=shards, mesh=mesh)
    t = torch.as_tensor
    d, i, scan = step(t(rows[part]), t(codes[part]), t(bscales), t(queries), t(eps),
                      t(scale), t(eps_lo))
    specs = [(tuple(x.shape), str(x.dtype),
              f"Shard({x.placements[0].dim})" if x.placements[0].is_shard() else "Replicate")
             for x in search_input_specs(svc, mesh, quant="int8", fused=True)]
    return d.numpy(), i.numpy(), np.asarray(scan), specs


def _gathered(tree, shardings):
    """Every leaf of a rank's state gathered to its full tensor, as numpy."""
    from repro_torch.distributed.collectives import gather_sharded
    return {k: gather_sharded(v, shardings[k].spec, shardings[k].mesh).cpu().numpy()
            for k, v in tree.items()}


def train_parity_rank(rank, world, dev, cases, codec, one_ckpt, out_dir):
    """Rank ``rank`` of a (world, 1) gloo data mesh.  For each case (a
    reduced architecture, its reference parameter tree and global batch):
    the data-parallel ``train_grads`` (loss, metrics, the summed gradient),
    with ``compress`` the compressed all-reduce of that gradient from a zero
    error buffer, then one ``train_step`` (its metrics and the gathered
    parameters, moments and error buffer after it); for a MoE case also
    the aux of the planted fault, each rank's counts left local.  The first
    case's state after its step is saved over the ranks into ``out_dir``.
    ``codec``: ``compressed_grad_allreduce`` on the same arrays on every
    rank and on each rank's own.  ``one_ckpt``: (dir, step, arch), a
    one-process checkpoint of (params, opt_state) restored onto the ranks:
    their pieces."""
    import dataclasses

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.collectives import compressed_grad_allreduce
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.interop import lm_from_arrays
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (DataParallel, compress_grads, train_grads,
                                          train_step)
    from repro_torch.models.common import DataShare
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    mesh = make_host_mesh(world, 1)
    out = {"cases": []}
    for c, case in enumerate(cases):
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfgset"])
        model = lm_from_arrays(cfg, case["params"], device="cpu").requires_grad_(True)
        full = dict(model.named_parameters())
        dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh))
        res = {}
        loss, mets, grads = train_grads(model, case["batch"], dp)
        res["loss"] = float(loss)
        res["mets"] = {k: float(v) for k, v in mets.items()}
        res["grads"] = {k: g.numpy().copy() for k, g in grads.items()}
        ebuf = None
        if case["compress"]:
            zeros = {k: torch.zeros(g.shape) for k, g in grads.items()}
            mean, new_e = compress_grads(grads, zeros, dp.stripes)
            res["mean"] = {k: v.numpy() for k, v in mean.items()}
            res["new_e"] = {k: v.numpy() for k, v in new_e.items()}
            ebuf = {k: torch.zeros(g.shape) for k, g in grads.items()}
        if cfg.family == "moe":  # the planted fault: each rank's counts left local
            dp.share, keep = DataShare(dp.size, lambda t: t), dp.share
            res["aux_local_counts"] = float(train_grads(model, case["batch"], dp)[1]["aux"])
            dp.share = keep
        params = dp.local_params(model)
        opt_state = adamw_init(params)
        params, opt_state, om = train_step(model, AdamWConfig(**case["opt"]), params,
                                           opt_state, case["batch"], dp=dp, ebuf=ebuf)
        res["om"] = {k: float(v) for k, v in om.items()}
        res["params"] = _gathered(params, dp.shardings)
        res["m"] = _gathered(opt_state["m"], dp.shardings)
        res["v"] = _gathered(opt_state["v"], dp.shardings)
        if ebuf is not None:
            res["ebuf"] = {k: v.numpy() for k, v in ebuf.items()}
        if c == 0:
            CheckpointManager(out_dir, async_save=False).save(
                1, (params, opt_state, ebuf), shardings=dp.state_shardings(model, ebuf))
            # a batch whose rows do not split over the ranks: every rank
            # computes all of it and nothing is summed
            odd = {k: v[:3] for k, v in case["batch"].items()}
            lo, _, go = train_grads(model, odd, dp)
            l1, _, g1 = train_grads(model, odd)
            out["odd_batch"] = (float(lo), float(l1), all(
                torch.equal(go[k], g1[k]) for k in g1), dp.splits(3, 1))
        out["cases"].append(res)

    t = {k: torch.as_tensor(v[0]) for k, v in codec["g"].items()}
    e = {k: torch.as_tensor(v[0]) for k, v in codec["e"].items()}
    out["codec_same"] = [{k: v.numpy() for k, v in d.items()}
                         for d in compressed_grad_allreduce(t, e)]
    t = {k: torch.as_tensor(v[rank]) for k, v in codec["g"].items()}
    e = {k: torch.as_tensor(v[rank]) for k, v in codec["e"].items()}
    out["codec_own"] = [{k: v.numpy() for k, v in d.items()}
                        for d in compressed_grad_allreduce(t, e)]

    ckpt_dir, step, arch = one_ckpt
    model = build_model(reduced_config(arch), device="cpu")
    full = dict(model.named_parameters())
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh))
    params = dp.local_params(model)
    like = (params, adamw_init(params))
    shardings = dp.state_shardings(model)[:2]
    params, opt_state = CheckpointManager(ckpt_dir, async_save=False).restore(
        step, like, shardings=shardings)
    out["restored"] = ({k: v.numpy() for k, v in params.items()},
                       {k: v.numpy() for k, v in opt_state["m"].items()},
                       int(opt_state["step"]))
    out["specs"] = {k: s.spec for k, s in dp.shardings.items()}
    return out


def rank_view(sizes, names, coordinate):
    """An ``AbstractMesh`` seen from one rank's ``coordinate``: enough for
    ``sharding.local_slice`` and ``CheckpointManager.restore(shardings=)``
    to place that rank's pieces without a process group."""
    import dataclasses

    from repro_torch.distributed.sharding import AbstractMesh

    @dataclasses.dataclass(frozen=True)
    class RankView(AbstractMesh):
        coordinate: tuple = ()

        def get_coordinate(self):
            return list(self.coordinate)

    return RankView(tuple(sizes), tuple(names), tuple(coordinate))


def codec_devices_rank(rank, world, dev, g, e):
    """``compressed_grad_allreduce`` of the same (g, e) arrays as CPU tensors
    and as tensors on the rank's device (a card: gloo stages them through
    the host), over the same group: both results, as numpy."""
    from repro_torch.distributed.collectives import compressed_grad_allreduce

    out = []
    for where in ("cpu", dev):
        res = compressed_grad_allreduce({k: torch.as_tensor(v, device=where) for k, v in g.items()},
                                        {k: torch.as_tensor(v, device=where) for k, v in e.items()})
        out.append([{k: v.cpu().numpy() for k, v in d.items()} for d in res])
    return out


def dp_step_devices_rank(rank, world, dev, arch, batch, lr):
    """One data-parallel ``train_step`` of the same seeded reduced model on
    the CPU and on the rank's device, over a (world, 1) gloo mesh: for each,
    (loss, {name: the summed gradient}, {name: the gathered parameter after
    the step}) as numpy."""
    import copy

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import DataParallel, train_grads, train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(world, 1)
    cpu = build_model(reduced_config(arch), seed=1, device="cpu").requires_grad_(True)
    out = []
    for model in (cpu, copy.deepcopy(cpu).to(dev)):
        full = dict(model.named_parameters())
        dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh))
        loss, _, grads = train_grads(model, batch, dp)
        grads = {k: g.detach().cpu().numpy().copy() for k, g in grads.items()}
        params = dp.local_params(model)
        params, _, _ = train_step(model, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10),
                                  params, adamw_init(params), batch, dp=dp)
        out.append((float(loss), grads, _gathered(params, dp.shardings)))
    return out
