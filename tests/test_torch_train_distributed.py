"""The port's data-parallel training against the reference's multi-device
step, on 2 gloo CPU ranks (``launch.mesh.spawn``, rank functions in
``tests/_torch_dist.py``):

  * the 2-rank ``DataParallel`` step (``launch.steps``) against the
    reference's step on a forced 2-device CPU mesh in a subprocess, composed
    as ``src/repro/launch/train.py`` composes it (``loss_fn`` under
    ``use_rules`` on parameters and moments placed by ``tree_shardings``,
    the ``shard_map``'d ``compressed_grad_allreduce`` with ``--grad-compress``,
    ``adamw_update``; with ``grad_accum`` 2 the microbatch scan of
    ``launch/steps.py``), for a dense, a MoE and an SSM architecture at
    reduced config: loss, metrics, every summed gradient leaf, the
    compressed gradient and its new error buffer, and the parameters,
    moments and error buffer after the step; MoE's aux from rank-local
    counts (a planted fault) must differ;
  * ``compressed_grad_allreduce`` against the reference's on the same
    arrays, replicated and per rank;
  * elastic restore: a one-process checkpoint onto 2 ranks, a 2-rank
    checkpoint onto one process and onto the reference's manager;
  * ``launch/train.py --reduced --device cpu --devices 2 --grad-compress``
    with ``--fail-at``.

Tolerances are ``tests/_torch_lm.py``'s and ``test_torch_train.py``'s:
the loss and metrics within 1e-5, gradients within rtol 1e-4 and atol 1e-4
x the reference leaf's max |g|, state after the step within 1e-5.  Where
the two packages' gradients differ by float32 rounding, an int8 code at a
near-tie may round to the neighbouring code (compressed path), and a
near-zero gradient's sign may flip (Adam's first step is +-lr by sign):
such elements are counted and excused only where the code moved by one or
the reference gradient is zero to rounding, at most 1e-3 of each leaf.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_lm import LOSS_TOL, train_inputs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_restore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_RTOL = 1e-4
STATE_TOL = 1e-5
NEAR_SHARE = 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# (architecture, config changes, --grad-compress): dense, MoE and SSM, at
# grad_accum 1 and 2
CASES = [("codeqwen1.5-7b", {"grad_accum": 1}, True),
         ("codeqwen1.5-7b", {"grad_accum": 2}, False),
         ("mixtral-8x7b", {"grad_accum": 2}, False),
         ("mamba2-130m", {"grad_accum": 1}, True)]
CASE_IDS = [f"{a}-ga{c['grad_accum']}{'-compress' if z else ''}" for a, c, z in CASES]

_REF = textwrap.dedent("""
    import os
    import sys
    # LLVM's backend optimizations off: the compile takes half the time
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                               "--xla_backend_optimization_level=0")
    import dataclasses
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import reduced_config
    from repro.distributed.collectives import compressed_grad_allreduce
    from repro.distributed.sharding import tree_shardings, use_rules
    from repro.launch.mesh import make_mesh_compat, shard_map
    from repro.models.model import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update, opt_state_axes
    from repro_torch.interop import lm_param_map

    a = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    mesh = make_mesh_compat((2, 1), ("data", "model"))
    out = {}

    def named(prefix, tree):
        for name, leaf, layer in lm_param_map(jax.tree.map(np.asarray, tree)):
            out[f"{prefix}/{name}"] = leaf if layer is None else leaf[layer]

    for c, case in enumerate(cases):
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfgset"])
        model = build_model(cfg)
        params, axes = model.init(jax.random.PRNGKey(c))
        opt = AdamWConfig(**case["opt"])
        opt_state = adamw_init(params)
        params = jax.device_put(params, tree_shardings(axes, params, mesh))
        opt_state = jax.device_put(opt_state, tree_shardings(opt_state_axes(axes),
                                                             opt_state, mesh))
        batch = {k: a[f"{c}/b/{k}"] for k in ("tokens", "labels")}
        batch = jax.device_put(batch, tree_shardings(
            {k: ("batch", "seq") for k in batch}, batch, mesh))
        ebuf = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                if case["compress"] else None)
        ga = max(cfg.grad_accum, 1)

        @jax.jit
        def step(params, opt_state, ebuf, batch):
            with use_rules(mesh):
                if ga == 1:  # launch/train.py
                    (loss, mets), grads = jax.value_and_grad(
                        model.loss_fn, has_aux=True)(params, batch)
                else:  # launch/steps.py's microbatch scan
                    mb = jax.tree.map(
                        lambda x: x.reshape(ga, x.shape[0] // ga, *x.shape[1:]), batch)

                    def body(carry, b_i):
                        gsum, lsum = carry
                        (l, mets_i), g = jax.value_and_grad(
                            model.loss_fn, has_aux=True)(params, b_i)
                        gsum = jax.tree.map(lambda x, y: x + y.astype(jnp.float32), gsum, g)
                        return (gsum, lsum + l), mets_i

                    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                    (gsum, lsum), mets = jax.lax.scan(
                        body, (zeros, jnp.zeros((), jnp.float32)), mb)
                    grads = jax.tree.map(lambda g: g / ga, gsum)
                    loss = lsum / ga
                    mets = jax.tree.map(lambda m: m[-1], mets)
                raw = grads
                if ebuf is not None:
                    grads, ebuf = shard_map(
                        lambda g, e: compressed_grad_allreduce(g, e, "data"),
                        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                        check_vma=False)(grads, ebuf)
                params, opt_state, om = adamw_update(opt, params, grads, opt_state)
            return params, opt_state, ebuf, raw, grads, loss, mets, om

        p, s, e, raw, mean, loss, mets, om = step(params, opt_state, ebuf, batch)
        out[f"{c}/loss"] = np.asarray(loss)
        for k, v in {**mets, **om}.items():
            out[f"{c}/{k}"] = np.asarray(v)
        named(f"{c}/grads", raw)
        named(f"{c}/params", p)
        named(f"{c}/m", s["m"])
        named(f"{c}/v", s["v"])
        if e is not None:
            named(f"{c}/mean", mean)
            named(f"{c}/ebuf", e)

    g = {k[len("codec/g/"):]: a[k] for k in a if k.startswith("codec/g/")}
    e = {k[len("codec/e/"):]: a[k] for k in a if k.startswith("codec/e/")}
    same = jax.jit(shard_map(lambda g, e: compressed_grad_allreduce(g, e, "data"),
                             mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                             check_vma=False))(
        jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e))
    own = jax.jit(shard_map(
        lambda g, e: jax.tree.map(lambda x: x[None], compressed_grad_allreduce(
            jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e), "data")),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
        check_vma=False))(g, e)
    for tag, (mean, new_e) in (("same", same), ("own", own)):
        for k in g:
            out[f"codec_{tag}/mean/{k}"] = np.asarray(mean[k])
            out[f"codec_{tag}/new_e/{k}"] = np.asarray(new_e[k])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codec_arrays():
    """Error-feedback inputs: ``g`` and ``e`` per rank (row 0 is also the
    replicated case's), float32."""
    rng = np.random.default_rng(7)
    g = {"w": rng.standard_normal((2, 8, 8)).astype(np.float32),
         "b": (rng.standard_normal((2, 5)) * 1e-3).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    return g, e


def _one_process_checkpoint(path):
    """A one-process checkpoint of a reduced mamba2's (params, opt_state)."""
    model = build_model(reduced_config("mamba2-130m"), seed=3, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt = adamw_init(params)
    for k, m in opt["m"].items():
        m.copy_(torch.randn(m.shape, generator=torch.Generator().manual_seed(len(k))))
    opt["step"].fill_(4)
    CheckpointManager(str(path), async_save=False).save(4, (params, opt))
    return params, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 2 ranks, run side by side."""
    import dataclasses
    tmp = tmp_path_factory.mktemp("dp")
    inputs, cases = {}, []
    for c, (arch, cfgset, compress) in enumerate(CASES):
        batch = train_inputs(j_reduced_config(arch), b=4, s=32, seed=c)
        inputs.update({f"{c}/b/{k}": v for k, v in batch.items()})
        cases.append(dict(arch=arch, cfgset=cfgset, compress=compress, opt=OPT, batch=batch))
    g, e = _codec_arrays()
    inputs.update({f"codec/g/{k}": v for k, v in g.items()})
    inputs.update({f"codec/e/{k}": v for k, v in e.items()})
    np.savez(tmp / "in.npz", **inputs)
    spec = [{k: c[k] for k in ("arch", "cfgset", "compress", "opt")} for c in cases]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # the subprocess draws each case's parameters as below, from PRNGKey(case)
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "in.npz"), str(tmp / "out.npz"),
         json.dumps(spec)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for c, case in enumerate(cases):
            jcfg = dataclasses.replace(j_reduced_config(case["arch"]), **case["cfgset"])
            case["params"] = jax.tree.map(
                np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(c))[0])
        one = _one_process_checkpoint(tmp / "one")
        port = spawn(_torch_dist.train_parity_rank, 2, backend="gloo",
                     init_file=str(tmp / "init"), device="cpu",
                     args=(cases, {"g": g, "e": e}, (str(tmp / "one"), 4, "mamba2-130m"),
                           str(tmp / "two"))).join(timeout_s=240)
        _, err = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
        ref_proc.wait()
    assert ref_proc.returncode == 0, err[-4000:]
    return dict(np.load(tmp / "out.npz")), port, one, tmp, cases


def _ref_tree(ref, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


def _close_or_excused(got: dict, ref: dict, what: str, rtol, atol_of, excusable=None):
    """Every leaf of ``got`` against ``ref``; elements off tolerance must lie
    in ``excusable[name]`` (a mask), at most NEAR_SHARE of the leaf.
    Returns the masks of the elements excused."""
    assert got.keys() == ref.keys(), (what, sorted(got.keys() ^ ref.keys())[:4])
    excused = {}
    for k, r in ref.items():
        g = np.asarray(got[k], np.float32)
        r = np.asarray(r, np.float32)
        bad = ~np.isclose(g, r, rtol=rtol, atol=atol_of(k))
        ok = np.zeros_like(bad) if excusable is None else excusable[k]
        assert not (bad & ~ok).any(), (
            f"{what} {k}: {int((bad & ~ok).sum())} of {r.size} differ, up to "
            f"{float(np.abs(g - r)[bad & ~ok].max()):.3e}")
        assert (bad & ok).sum() <= NEAR_SHARE * r.size, (what, k, int((bad & ok).sum()))
        excused[k] = bad & ok
    return excused


@pytest.mark.parametrize("c", range(len(CASES)), ids=CASE_IDS)
def test_data_parallel_step_matches_reference_multi_device_step(runs, c):
    ref, port, _, _, _ = runs
    got = port[0]["cases"][c]
    np.testing.assert_allclose(got["loss"], float(ref[f"{c}/loss"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(got["mets"][k], float(ref[f"{c}/{k}"]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    compress = CASES[c][2]
    # the compressed gradient's norm carries its scales' error (below)
    norm_tol = 2 * GRAD_RTOL if compress else LOSS_TOL
    np.testing.assert_allclose(got["om"]["grad_norm"], float(ref[f"{c}/grad_norm"]),
                               rtol=norm_tol, atol=norm_tol)
    np.testing.assert_allclose(got["om"]["lr"], float(ref[f"{c}/lr"]), rtol=LOSS_TOL)
    rgrads = _ref_tree(ref, f"{c}/grads")
    gmax = {k: float(np.abs(r).max()) for k, r in rgrads.items()}
    _close_or_excused(got["grads"], rgrads, "gradient", GRAD_RTOL,
                      lambda k: GRAD_RTOL * gmax[k])
    if compress:
        # Each leaf's codes share one scale, max|g + e| / 127: every element
        # of the compressed gradient carries the relative error of the
        # leaf's largest gradient (within 2 x GRAD_RTOL by the tolerance
        # above), the residual g + e - dequant that and its own; an int8 code
        # at a near-tie may round to its neighbour, one scale apart.
        rmean = _ref_tree(ref, f"{c}/mean")
        near = {k: np.abs(np.asarray(got["mean"][k]) - r)
                <= gmax[k] / 127.0 + 3 * GRAD_RTOL * gmax[k] for k, r in rmean.items()}
        moved = _close_or_excused(got["mean"], rmean, "compressed gradient", 2 * GRAD_RTOL,
                                  lambda k: 0.0, near)
        for part, what in (("new_e", "new error buffer"), ("ebuf", "error buffer after step")):
            _close_or_excused(got[part], _ref_tree(ref, f"{c}/ebuf"), what, 0.0,
                              lambda k: 3 * GRAD_RTOL * gmax[k], moved)
        flippable = moved
    else:
        # within the gradient's tolerance a gradient's sign is not determined
        flippable = {k: np.abs(r) <= GRAD_RTOL * gmax[k] for k, r in rgrads.items()}
    for part in ("params", "m", "v"):
        _close_or_excused(got[part], _ref_tree(ref, f"{c}/{part}"), part, STATE_TOL,
                          lambda k: STATE_TOL, flippable)
    # every rank holds the same gathered state and the same reduced gradient
    other = port[1]["cases"][c]
    for part in ("grads", "params", "m", "v"):
        for k, v in got[part].items():
            assert np.array_equal(v, other[part][k]), (part, k)
    assert got["loss"] == other["loss"] and got["om"] == other["om"]


def test_moe_aux_from_rank_local_counts_differs(runs):
    """The planted fault: each rank's aux from its own counts (their mean is
    not the product of the global means) misses the reference's aux."""
    ref, port, _, _, _ = runs
    c = next(i for i, (a, _, _) in enumerate(CASES) if a == "mixtral-8x7b")
    got = port[0]["cases"][c]
    want = float(ref[f"{c}/aux"])
    np.testing.assert_allclose(got["mets"]["aux"], want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(got["aux_local_counts"] - want) > 100 * LOSS_TOL, (got["aux_local_counts"], want)


def test_indivisible_batch_is_replicated_not_summed(runs):
    """3 rows over 2 ranks: ``Rules.resolve`` replicates the batch, so each
    rank computes all of it, its gradients unsummed: equal to one process's
    bit for bit."""
    _, port, _, _, _ = runs
    for r in range(2):
        lo, l1, same, split = port[r]["odd_batch"]
        assert lo == l1 and same and not split


@pytest.mark.parametrize("tag", ["same", "own"])
def test_compressed_grad_allreduce_matches_reference(runs, tag):
    """The same (g, e) on both ranks (the trainer's case) and each rank's own:
    the mean and the new error feedback equal the reference's, ``mean +
    new_e`` equals ``g + e`` within 1e-5 (the reference's own gate) where
    the inputs are the same, and every rank's mean is identical."""
    ref, port, _, _, _ = runs
    g, e = _codec_arrays()
    for r in range(2):
        mean, new_e = port[r][f"codec_{tag}"]
        for k in g:
            rm = ref[f"codec_{tag}/mean/{k}"]
            re_ = ref[f"codec_{tag}/new_e/{k}"]
            if tag == "own":
                rm, re_ = rm[r], re_[r]
            np.testing.assert_allclose(mean[k], rm, rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(new_e[k], re_, rtol=1e-6, atol=1e-7, err_msg=k)
            if tag == "same":
                assert np.abs(mean[k] + new_e[k] - (g[k][0] + e[k][0])).max() < 1e-5
        assert all(np.array_equal(mean[k], port[0][f"codec_{tag}"][0][k]) for k in g)


def test_elastic_restore_one_process_checkpoint_onto_two_ranks(runs):
    """Each rank's restored pieces are its slices of the one-process leaves
    (``embed_fsdp`` dimensions split over the data ranks)."""
    _, port, (params, opt), _, _ = runs
    sliced = 0
    for r in range(2):
        p_r, m_r, step = port[r]["restored"]
        assert step == 4
        for k, full in params.items():
            spec = port[r]["specs"][k]
            want, got = full.numpy(), p_r[k]
            for dim, part in enumerate(spec):
                if part and "data" in part:
                    size = want.shape[dim] // 2
                    want = want.take(range(r * size, (r + 1) * size), axis=dim)
                    sliced += 1
            assert np.array_equal(got, want), k
            assert got.shape == m_r[k].shape
    assert sliced > 0


def test_two_rank_checkpoint_restores_in_one_process_and_the_reference(runs):
    """The first case's state after its 2-rank step, written by rank 0 from
    the gathered pieces, restores in one process (``elastic_restore`` with
    no mesh) and in the reference's manager as the gathered full leaves."""
    _, port, _, tmp, cases = runs
    got = port[0]["cases"][0]
    cfg = reduced_config(cases[0]["arch"])
    import dataclasses
    model = build_model(dataclasses.replace(cfg, **cases[0]["cfgset"]), device="meta")
    full = {k: torch.zeros(v.shape) for k, v in model.named_parameters()}
    like = (full, adamw_init(full), {k: torch.zeros(v.shape) for k, v in full.items()})
    mgr = CheckpointManager(str(tmp / "two"), async_save=False)
    assert mgr.all_steps() == [1]
    params, opt, ebuf = elastic_restore(mgr, 1, like, None)
    for k in full:
        assert np.array_equal(params[k].numpy(), got["params"][k]), k
        assert np.array_equal(opt["m"][k].numpy(), got["m"][k]), k
        assert np.array_equal(ebuf[k].numpy(), got["ebuf"][k]), k
    assert int(opt["step"]) == 1
    jtree = JManager(str(tmp / "two")).restore(1, jax.tree.map(
        lambda t: np.zeros(t.shape, np.float32), (
            {k: v.numpy() for k, v in full.items()},
            {"m": {k: v.numpy() for k, v in full.items()},
             "v": {k: v.numpy() for k, v in full.items()}, "step": np.zeros((), np.int32)},
            {k: v.numpy() for k, v in full.items()})))
    for k in full:  # the reference's manager reads the same leaves
        assert np.array_equal(np.asarray(jtree[0][k]), got["params"][k]), k
        assert np.array_equal(np.asarray(jtree[1]["m"][k]), got["m"][k]), k
        assert np.array_equal(np.asarray(jtree[2][k]), got["ebuf"][k]), k


def test_train_cli_two_ranks_grad_compress_restarts(tmp_path, capsys):
    """``train.py --reduced --device cpu --devices 2 --grad-compress`` with a
    failure injected after the first checkpoint: one restart, both
    checkpoints committed, the loss improves, and the step-10 state (its
    error buffer included) restores in one process."""
    ck = tmp_path / "ck"
    _, info = t_train.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
                            "--devices", "2", "--dist-backend", "gloo", "--grad-compress",
                            "--steps", "10", "--batch", "4", "--seq", "32", "--lr", "3e-3",
                            "--ckpt-every", "5", "--fail-at", "7", "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    assert "[ranks] 2 ranks over gloo on cpu" in out and "restarts=1" in out
    assert info["restarts"] == 1 and len(info["history"]) == 10
    losses = [h["loss"] for h in info["history"]]
    assert losses[-1] < losses[0]
    mgr = CheckpointManager(str(ck))
    assert mgr.all_steps() == [5, 10]
    model = build_model(reduced_config("mamba2-130m"), device="cpu")
    full = {k: v.detach() for k, v in model.named_parameters()}
    zeros = {k: torch.zeros(v.shape) for k, v in full.items()}
    params, opt, ebuf = elastic_restore(mgr, 10, (full, adamw_init(full), zeros), None)
    assert int(opt["step"]) == 10
    assert any(float(v.abs().max()) > 0 for v in ebuf.values())
    meta = json.loads((ck / "step_000000010" / "tree.json").read_text())
    assert len(meta["leaves"]) == 4 * len(full) + 1
