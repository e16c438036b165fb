"""Rank functions of the port's multi-rank tests
(``tests/test_torch_distributed.py``, ``test_torch_train_distributed.py``,
the ``gpu`` ones in ``test_torch_gpu.py``).  A spawned rank imports its function
by module path, so they live here, in a module that imports no JAX."""

import pickle

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
    """An ``AbstractMesh`` seen from one rank's ``coordinate``
    (``sharding.RankView``): enough for ``sharding.local_slice`` and
    ``CheckpointManager.restore(shardings=)`` to place that rank's pieces
    without a process group."""
    from repro_torch.distributed.sharding import RankView

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


def _placed(t, dims: dict, mesh):
    """A rank's piece of a step output gathered whole: ``dims`` maps each
    split dimension to the mesh axes it is split over (its rows over the
    axes the batch split over, a model piece over "model", a decode
    cache's slots over the axes ``common.mark_split`` recorded)."""
    from repro_torch.distributed.collectives import gather_sharded
    spec = tuple(tuple(dims[d]) if dims.get(d) else None for d in range(t.ndim))
    return gather_sharded(t.contiguous(), spec, mesh)


def _parity_case(case, mesh):
    """One case of :func:`tp_parity_rank` / :func:`pod_parity_rank` on
    ``mesh``: the partitioned train step (unless ``case["train"]`` is
    False), then the prefill (unless ``case["prefill"]`` is False) and 4
    decode steps, every output gathered whole."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.collectives import gather_sharded
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.interop import lm_from_arrays, local_state_from_arrays
    from repro_torch.launch.steps import (DataParallel, prefill_step, serve_step, train_grads,
                                          train_step)
    from repro_torch.models.common import split_axes, split_of
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfgset"])
    res = {}
    if case.get("train", True):
        model = lm_from_arrays(cfg, case["params"], device="cpu").requires_grad_(True)
        full = dict(model.named_parameters())
        sh = tree_shardings(model.param_axes(), full, mesh, case["overrides"])
        dp = DataParallel(mesh, sh, model, case["overrides"])
        loss, mets, grads = train_grads(model, case["batch"], dp)
        res["loss"], res["mets"] = float(loss), {k: float(v) for k, v in mets.items()}
        res["grads"] = {k: gather_sharded(g.contiguous(), dp.model_specs[k], mesh).numpy()
                        for k, g in grads.items()}
        params = dp.local_params(model)
        opt_state = adamw_init(params)
        ref_params, ref_state = local_state_from_arrays(cfg, case["params"], case["opt_state"],
                                                        sh, device="cpu")
        res["pieces_equal"] = all(torch.equal(params[k], ref_params[k]) for k in params) and all(
            torch.equal(opt_state[m][k], ref_state[m][k]) for m in ("m", "v") for k in params)
        res["shapes"] = {k: tuple(v.shape) for k, v in params.items()}
        res["moment_shapes"] = {k: tuple(v.shape) for k, v in opt_state["m"].items()}
        dp.traffic.reset()
        params, opt_state, om = train_step(model, AdamWConfig(**case["opt"]), params,
                                           opt_state, case["batch"], dp=dp)
        res["traffic"] = dict(dp.traffic.bytes)  # what the step's collectives carried
        res["om"] = {k: float(v) for k, v in om.items()}
        for part, tree in (("params", params), ("m", opt_state["m"]), ("v", opt_state["v"])):
            res[part] = {k: gather_sharded(v, sh[k].spec, mesh).numpy() for k, v in tree.items()}

    # serving from the parameters the reference's prefill and decode take
    model = lm_from_arrays(cfg, case["params"], device="cpu")
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), dict(model.named_parameters()),
                                           mesh, case["overrides"]), model, case["overrides"])
    m = dp.model_size
    prompt = {k: torch.as_tensor(v) for k, v in case["prompt"].items()}
    rows = prompt["tokens"].shape[0]
    row_axes = dp.split(rows)[2]

    def gathered(cs):
        return {key: type(cv)(*(_placed(t, {1: row_axes, split_of(t): split_axes(t)}
                                        if m > 1 else {1: row_axes}, mesh).numpy()
                                for t in cv)) for key, cv in cs.items()}

    if case.get("prefill", True):
        logits, caches = prefill_step(model, prompt, dp=dp)
        with dp.rules():
            res["prefill_logits"] = _placed(logits, {0: row_axes, 1: ("model",) if m > 1 else ()},
                                            mesh).numpy()
            res["prefill_caches"] = gathered(caches)
    caches = dp.init_caches(model, rows, case["cache_len"])
    with dp.rules():
        res["cache_blocks"] = {key: [(split_of(t), split_axes(t)) for t in cv]
                               for key, cv in caches.items()}
    steps = []
    for t in range(case.get("decode_steps", 4)):
        lg, caches = serve_step(model, prompt["tokens"][:, t:t + 1], caches,
                                case["decode_at"] + t, dp=dp)
        with dp.rules():
            steps.append(_placed(lg, {0: row_axes, 1: ("model",) if m > 1 else ()},
                                 mesh).numpy())
    res["decode_logits"] = steps
    with dp.rules():
        res["decode_caches"] = gathered(caches)
    return res


def tp_parity_rank(rank, world, dev, cases_path, ckpt):
    """Rank ``rank`` of a (data, model) gloo mesh (``case["mesh"]``, whose
    size is ``world``).  For each case of the pickle at ``cases_path`` (read
    here, so that starting the ranks moves no large argument through their
    pipes; a reduced architecture, its
    reference parameters, a train batch, a prompt batch, rule
    ``overrides``): the partitioned train step's loss, metrics and summed
    gradients (gathered whole), the parameters and moments after one
    ``train_step`` (gathered), the shapes of this rank's pieces, the
    prefill's logits and caches, and 4 decode steps' logits (from position
    ``case["decode_at"]``) and the caches after them, all gathered whole
    (:func:`_parity_case`).  ``ckpt`` ((dir, arch) or None): a
    one-process checkpoint restored onto the mesh (the pieces), then saved
    from the mesh into ``dir + "-back"``."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {"cases": {}}
    for c, case in cases.items():
        d, m = case["mesh"]
        out["cases"][c] = _parity_case(case, make_host_mesh(d, m))

    # build_cell over the mesh: every reduced architecture's train, prefill
    # and decode cells run one step on a small batch
    from repro_torch.configs import LM_ARCHS
    mesh = make_host_mesh(world // 2, 2)
    out["cells"] = {}
    for arch in LM_ARCHS:
        cfgset = dataclasses.asdict(reduced_config(arch))
        cfgset.pop("arch_id")
        rng = np.random.default_rng(len(arch))
        cfg = reduced_config(arch)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal((8, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
        if cfg.family == "vlm":
            batch["vision"] = rng.standard_normal((8, cfg.vision_seq, cfg.vision_dim),
                                                  dtype=np.float32)
        got = {}
        cell = build_cell(arch, "train_4k", mesh=mesh, device="cpu", cfgset=cfgset)
        params = cell.data_parallel.local_params(cell.model)
        _, _, mets = cell.step_fn(params, adamw_init(params), batch)
        got["train"] = float(mets["loss"])
        prompt = {k: torch.as_tensor(v) for k, v in batch.items() if k != "labels"}
        cell = build_cell(arch, "prefill_32k", mesh=mesh, device="cpu", cfgset=cfgset)
        logits, _ = cell.step_fn(prompt)
        got["prefill"] = tuple(logits.shape), bool(torch.isfinite(logits).all())
        cell = build_cell(arch, "decode_32k", mesh=mesh, device="cpu", cfgset=cfgset)
        dp = cell.data_parallel
        with dp.rules():
            caches, _ = cell.model.init_caches(8 // dp.size, 16)
        logits, _ = cell.step_fn(prompt["tokens"][:, :1], caches, 0)
        got["decode"] = tuple(logits.shape), bool(torch.isfinite(logits).all())
        if arch == "gemma2-9b":  # long_500k: one row, the slots over every rank
            cell = build_cell(arch, "long_500k", mesh=mesh, device="cpu", cfgset=cfgset)
            one = build_model(cell.model.cfg, device="cpu")  # build_cell's seed
            with cell.data_parallel.rules():
                caches, _ = cell.model.init_caches(1, 16)
                got["long_blocks"] = caches["kv1"].k.shape[2]
            ones, _ = one.init_caches(1, 16)
            worst = 0.0
            for t in range(12):
                tok = prompt["tokens"][:1, t:t + 1]
                lg, caches = cell.step_fn(tok, caches, t)
                lo, _ = one.decode_step(tok, ones, t)
                v = lg.shape[-1]
                piece = lo[:, mesh.get_coordinate()[1] * v:(mesh.get_coordinate()[1] + 1) * v]
                worst = max(worst, float((lg - piece).abs().max()))
            got["long_500k"] = worst
        out["cells"][arch] = got

    if ckpt is not None:
        out.update(_checkpoint_round_trip(mesh, *ckpt, f"{ckpt[0]}-back{world}"))
    return out


def _checkpoint_round_trip(mesh, path, arch, back):
    """A one-process checkpoint of a reduced ``arch`` at ``path`` restored
    onto ``mesh`` (each rank's pieces, as numpy: ``restored``, with the
    specs), then saved from the mesh into ``back``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.steps import DataParallel
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init

    model = build_model(reduced_config(arch), device="cpu")
    full = {k: v.detach().clone() for k, v in model.named_parameters()}
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh), model)
    params = dp.local_params(model)
    like = (params, adamw_init(params))
    shardings = dp.state_shardings(model)[:2]
    mgr = CheckpointManager(path, async_save=False)
    params, opt_state = mgr.restore(mgr.latest_step(), like, shardings=shardings)
    out = {"restored": ({k: v.numpy().copy() for k, v in params.items()},
                        {k: v.numpy().copy() for k, v in opt_state["m"].items()},
                        int(opt_state["step"])),
           "specs": {k: s.spec for k, s in dp.shardings.items()}}
    CheckpointManager(back, async_save=False).save(
        int(opt_state["step"]), (params, opt_state), shardings=shardings)
    return out


def tp_devices_rank(rank, world, dev, arch, batch, lr):
    """One partitioned (data=1, model=world) train step, prefill and 4
    decode steps of the same seeded reduced model on the CPU and on the
    rank's device, over a gloo mesh: for each, (loss, {name: the summed
    gradient, gathered}, {name: the gathered parameter after the step},
    the gathered prefill logits, the gathered decode logits) as numpy."""
    import copy

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.collectives import gather_sharded
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (DataParallel, prefill_step, serve_step, train_grads,
                                          train_step)
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(1, world)
    cpu = build_model(reduced_config(arch), seed=1, device="cpu").requires_grad_(True)
    out = []
    for model in (cpu, copy.deepcopy(cpu).to(dev)):
        full = dict(model.named_parameters())
        dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh), model)
        loss, _, grads = train_grads(model, batch, dp)
        grads = {k: gather_sharded(g.contiguous(), dp.model_specs[k], mesh).cpu().numpy()
                 for k, g in grads.items()}
        params = dp.local_params(model)
        params, _, _ = train_step(model, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10),
                                  params, adamw_init(params), batch, dp=dp)
        after = {k: gather_sharded(v, dp.shardings[k].spec, mesh).cpu().numpy()
                 for k, v in params.items()}
        tokens = torch.as_tensor(batch["tokens"], device=model.device)
        with torch.no_grad():
            logits, _ = prefill_step(model, {"tokens": tokens}, dp=dp)
            with dp.rules():
                pre = gather_sharded(logits, (None, ("model",)), mesh).cpu().numpy()
                caches, _ = model.init_caches(tokens.shape[0], 8)
            dec = []
            for t in range(4):
                lg, caches = serve_step(model, tokens[:, t:t + 1], caches, 2 + t, dp=dp)
                dec.append(gather_sharded(lg, (None, ("model",)), mesh).cpu().numpy())
        out.append((float(loss), grads, after, pre, dec))
    return out


def pod_parity_rank(rank, world, dev, cases_path, ckpt, codec):
    """Rank ``rank`` of a ("pod", "data", "model") gloo mesh of ``world``
    ranks (every case's ``case["mesh"]``, one mesh for all of them): each
    case of the pickle at ``cases_path`` through :func:`_parity_case`;
    gemma2-9b's reduced long_500k decode cell from ``build_cell`` (its
    cache slots over every rank) against one process's decode; the
    one-process checkpoint ``ckpt`` ((dir, arch)) restored onto the mesh
    and saved back into ``dir + "-back" + world``; an ``AxisComm`` gather
    over every axis, model major; ``codec`` ({name:
    array}) through ``compressed_grad_allreduce`` over the batch's ranks
    (every rank the same arrays) and in one process."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.distributed.collectives import (AxisComm, axis_groups,
                                                     compressed_grad_allreduce)
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import DataParallel, build_cell
    from repro_torch.models.common import split_axes
    from repro_torch.models.model import build_model

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    shape = next(iter(cases.values()))["mesh"]
    mesh = make_mesh(shape, ("pod", "data", "model"), "cpu")
    out = {"cases": {c: _parity_case(case, mesh) for c, case in cases.items()}}

    # long_500k's cell: one row, the slots over model, data and pod
    cfgset = dataclasses.asdict(reduced_config("gemma2-9b"))
    cfgset.pop("arch_id")
    cell = build_cell("gemma2-9b", "long_500k", mesh=mesh, device="cpu", cfgset=cfgset)
    one = build_model(cell.model.cfg, device="cpu")  # build_cell's seed
    caches = cell.data_parallel.init_caches(cell.model, 1, 16)
    with cell.data_parallel.rules():
        out["long_blocks"] = (caches["kv1"].k.shape[2], split_axes(caches["kv1"].k))
    ones, _ = one.init_caches(1, 16)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(0, one.cfg.vocab_size, (1, 12)),
                             dtype=torch.int32)
    v = one.cfg.vocab_padded // cell.data_parallel.model_size
    lo = cell.data_parallel.coord["model"] * v
    worst = 0.0
    for t in range(12):
        tok = tokens[:, t:t + 1]
        lg, caches = cell.step_fn(tok, caches, t)
        ref, _ = one.decode_step(tok, ones, t)
        worst = max(worst, float((lg - ref[:, lo:lo + v]).abs().max()))
    out["long_500k"] = worst

    out.update(_checkpoint_round_trip(mesh, *ckpt, f"{ckpt[0]}-back{world}"))

    # a gather over every axis, model major: its pieces in AxisComm's index
    # order, which is not the group's rank order
    comm = AxisComm(mesh, ("model", "data", "pod"), groups=axis_groups(mesh))
    out["gather_order"] = comm.gather(torch.tensor([comm.index]), 0).tolist()

    model = build_model(reduced_config("gemma-2b"), device="cpu")
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), dict(model.named_parameters()),
                                           mesh))
    g = {k: torch.as_tensor(a) for k, a in codec["g"].items()}
    e = {k: torch.as_tensor(a) for k, a in codec["e"].items()}
    out["codec"] = [{k: t.numpy() for k, t in d.items()}
                    for d in compressed_grad_allreduce(g, e, dp.stripes)]
    out["codec_ranks"] = torch.distributed.get_world_size(dp.stripes[0])
    return out
