"""The port's training path against the reference on seeded numpy inputs:
AdamW (``optim.adamw``) on numpy trees with a stacked and an unstacked
leaf, its schedule and global norm; the counterparts of
``tests/test_substrate.py``'s optimizer, pipeline, checkpoint and runner
tests; a reduced dense model's train step and three AdamW steps against
``jax.value_and_grad`` + ``adamw_update``; ``grad_accum`` 2 through
``build_cell`` against the reference's scan; remat on against off; bf16
checkpoint leaves across the packages; the SSD scan's masked exponent;
and ``launch/train.py --reduced --device cpu`` with an injected failure.

Tolerances: the loss within rtol = atol = 1e-5, every gradient leaf within
rtol 1e-4 and atol 1e-4 x that reference leaf's max |g|
(``tests/_torch_lm.py``); parameters and moments after AdamW steps within
rtol = atol = 1e-5, except for a parameter element whose reference
gradient lies within float32 rounding of zero at some step: Adam's
normalised step is then +-lr on a sign the rounding picks, so the port may
take the opposite step.  Such elements are counted and may be at most
NEAR_ZERO_SHARE of each leaf, as the int8 near-ties are.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (LOSS_TOL, assert_grads_close, port_grads,  # noqa: E402
                       reference_model, train_inputs)
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_cell as j_build_cell  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.interop import (adamw_state_from_arrays, lm_from_arrays,  # noqa: E402
                                 lm_param_map)
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.steps import build_cell, train_step  # noqa: E402
from repro_torch.models.model import build_model, reference_ndims  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                                     global_norm, schedule)
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,  # noqa: E402
                                                 TrainRunner, elastic_restore)

STATE_TOL = 1e-5  # rtol = atol on parameters and moments after AdamW steps
NEAR_ZERO = 1e-6  # |reference gradient| / the leaf's max |g| at or under it: "zero"
NEAR_ZERO_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: torch's thread pool costs more
    than it gives on them, and under several test workers it oversubscribes
    the host's cores (a CPU setting; no result depends on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tree(ref_tree, dtype=torch.float32):
    """A reference-shaped numpy tree as the port's flat {name: tensor}."""
    return {name: torch.tensor(np.asarray(leaf if layer is None else leaf[layer]),
                               dtype=dtype)
            for name, leaf, layer in lm_param_map(ref_tree)}


def _ref_leaves(ref_tree) -> dict[str, np.ndarray]:
    return {name: np.asarray(leaf if layer is None else leaf[layer], np.float32)
            for name, leaf, layer in lm_param_map(ref_tree)}


def _assert_state_close(ref: dict, got: dict, what: str, flippable=None, lr=0.0) -> int:
    """``got`` (tensors) against ``ref`` (arrays) at STATE_TOL; elements in
    ``flippable[name]`` (a mask) may instead differ by up to 2 lr x steps,
    at most NEAR_ZERO_SHARE of the leaf.  Returns the elements so excused."""
    excused = 0
    for name, r in ref.items():
        g = got[name].detach().float().numpy()
        bad = ~np.isclose(g, r, rtol=STATE_TOL, atol=STATE_TOL)
        if flippable is not None:
            ok = flippable[name] & (np.abs(g - r) <= 2 * lr + STATE_TOL)
            n = int((bad & ok).sum())
            assert n <= NEAR_ZERO_SHARE * r.size, (what, name, n, r.size)
            excused += n
            bad &= ~ok
        assert not bad.any(), (f"{what} {name}: {int(bad.sum())} of {r.size} differ, up to "
                               f"{float(np.abs(g - r)[bad].max()):.3e}")
    return excused


# ---- optimizer against the reference ------------------------------------------


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"stacks": [{"norm": {"w": rng.standard_normal((3, 8)).astype(np.float32)},
                          "w": rng.standard_normal((3, 8, 5)).astype(np.float32)}],
              "final_norm": {"w": rng.standard_normal((8,)).astype(np.float32)},
              "tok_embed": rng.standard_normal((16, 8)).astype(np.float32)}
    grads = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape) * s).astype(np.float32),
                          params) for s in (3.0, 0.01, 0.5)]  # clipped, then not
    return params, grads


def test_adamw_matches_reference_on_numpy_trees():
    """Three steps on a tree with a stacked (L, D) norm leaf, a stacked
    (L, D, F) matrix, an unstacked (D,) norm and a (V, D) matrix: the first
    step clips, the warmup runs; parameters, moments, grad_norm and lr
    agree.  The stacked norm is decayed (its reference ndim is 2) and the
    final norm is not: the port's tensor ndims alone would not decay it."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    params, grads = _opt_trees()
    jp, js = params, j_adamw.adamw_init(params)
    tp = _port_tree(params)
    ts = adamw_init(tp)
    naive = {k: v.clone() for k, v in tp.items()}
    ns = adamw_init(naive)
    ndims = reference_ndims(tp)
    assert ndims["stacks.0.1.norm.w"] == 2 and ndims["final_norm.w"] == 1
    j_update = jax.jit(j_adamw.adamw_update, static_argnums=0)
    for g in grads:
        jp, js, jm = j_update(jcfg, jp, g, js)
        tp, ts, tm = adamw_update(cfg, tp, _port_tree(g), ts, ndims=ndims)
        naive, ns, _ = adamw_update(cfg, naive, _port_tree(g), ns)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        _assert_state_close(_ref_leaves(jp), tp, "params")
        _assert_state_close(_ref_leaves(js["m"]), ts["m"], "m")
        _assert_state_close(_ref_leaves(js["v"]), ts["v"], "v")
    assert int(ts["step"]) == int(js["step"]) == 3
    ref = _ref_leaves(jp)
    assert not np.allclose(naive["stacks.0.1.norm.w"].numpy(), ref["stacks.0.1.norm.w"],
                           rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_array_equal(naive["final_norm.w"].numpy(), tp["final_norm.w"].numpy())


def test_schedule_and_global_norm_match_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = j_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(schedule(cfg, torch.tensor(step))),
                                   float(j_adamw.schedule(jcfg, jnp.asarray(step))),
                                   rtol=1e-6, err_msg=str(step))
    params, grads = _opt_trees(3)
    np.testing.assert_allclose(float(global_norm(_port_tree(grads[0]))),
                               float(j_adamw.global_norm(grads[0])), rtol=1e-6)


# ---- counterparts of tests/test_substrate.py ----------------------------------


def test_adamw_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200,
                      min_lr_ratio=1.0)
    state = adamw_init(params)
    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw_update(cfg, params, {"w": g}, state)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(schedule(cfg, 10)) == pytest.approx(1.0, abs=0.02)
    assert float(schedule(cfg, 100)) == pytest.approx(0.1, abs=0.01)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=0)
    state = adamw_init(params)
    _, state, m = adamw_update(cfg, params, {"w": torch.full((4,), 1e9)}, state)
    assert float(m["grad_norm"]) > 1e8  # reported pre-clip
    assert float(params["w"].abs().max()) <= 1.01e-2


def test_pipeline_deterministic_and_resumable():
    pipe = TokenPipeline(vocab_size=1000, batch=4, seq=32, seed=7)
    a, b, c = pipe.batch_at(5), pipe.batch_at(5), pipe.batch_at(6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert not np.array_equal(a["tokens"], pipe.batch_at(5, host=1)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])  # label shift
    assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (4, 32)


def test_pipeline_distribution_matches_reference():
    """The same Zipf-by-quantised-uniform unigram and p = 0.3 repeats: the
    rank histogram's head, the mean log-rank and the repeat rate of
    64 x 512 tokens agree with the reference's within sampling noise."""
    v = 1000
    t = TokenPipeline(vocab_size=v, batch=64, seq=512, seed=3).batch_at(0)["tokens"]
    j = np.asarray(JTokenPipeline(vocab_size=v, batch=64, seq=512, seed=3)
                   .batch_at(0)["tokens"])
    for x in (t, j):
        assert x.min() >= 0 and x.max() < v
    for stat in (lambda x: np.mean(x == 0), lambda x: np.mean(x < 10),
                 lambda x: np.mean(np.log1p(x)) / np.log(v),
                 lambda x: np.mean(x[:, 1:] == x[:, :-1])):
        assert abs(stat(t) - stat(j)) < 0.01, (stat(t), stat(j))


def _ck_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "h": (torch.arange(6.0) / 3).to(torch.bfloat16)},
            "step": torch.tensor(3)}


def _assert_tree_equal(x, y):
    if isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _assert_tree_equal(x[k], y[k])
        return
    assert x.dtype == y.dtype and x.shape == y.shape
    assert torch.equal(x, y)


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = _ck_tree()
    mgr.save(10, t)
    _assert_tree_equal(t, mgr.restore(10, t))


def test_checkpoint_async_snapshot_and_retention(tmp_path):
    """An asynchronous save writes the values at the call, not later ones:
    the train step updates its tensors in place while the writer runs."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _ck_tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
        t["a"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    out = mgr.restore(4, t)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(12.0).reshape(3, 4) + 3)


def test_checkpoint_corruption_detected_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _ck_tree())
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    path = os.path.join(str(tmp_path), "step_000000001", "leaf_00000.npy")
    data = bytearray(open(path, "rb").read())
    data[-4] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="digest"):
        mgr.restore(1, _ck_tree())


def test_bf16_leaves_cross_load_between_packages(tmp_path):
    """The reference writes a bfloat16 leaf as its raw bits (a ``|V2``
    array, ``"dtype": "bfloat16"``): the port writes the same bytes and
    metadata, reads the reference's step, and the reference's
    ``restore_named`` reads the port's bits with its digests checked.  The
    reference's own ``restore`` refuses a bfloat16 leaf (``|V2`` is no JAX
    dtype), its own included: reference behaviour, recorded here."""
    vals = (np.arange(-6, 6, dtype=np.float32) / 7).reshape(3, 4)
    jtree = {"h": jnp.asarray(vals, jnp.bfloat16), "s": jnp.asarray(7, jnp.int32)}
    ttree = {"h": torch.tensor(vals).to(torch.bfloat16), "s": torch.tensor(7, dtype=torch.int32)}
    jm = JManager(str(tmp_path / "ref"), async_save=False)
    tm = CheckpointManager(str(tmp_path / "port"), async_save=False)
    jm.save(1, jtree)
    tm.save(1, ttree)
    step = "step_000000001"
    for name in ("tree.json", "leaf_00000.npy", "leaf_00001.npy"):
        assert (tmp_path / "ref" / step / name).read_bytes() == \
            (tmp_path / "port" / step / name).read_bytes(), name
    assert json.loads((tmp_path / "port" / step / "tree.json").read_text())[
        "leaves"][0]["dtype"] == "bfloat16"
    # the reference's step in the port (a port manager on its directory)
    _assert_tree_equal(ttree, CheckpointManager(str(tmp_path / "ref"), async_save=False)
                       .restore(1, ttree))
    # the port's named bf16 artifact in the reference
    tm.save_named(2, {"h": ttree["h"]})
    out, _ = JManager(str(tmp_path / "port"), async_save=False).restore_named(2)
    np.testing.assert_array_equal(out["h"].view(np.uint16),
                                  np.asarray(jtree["h"]).view(np.uint16))
    with pytest.raises(TypeError):
        jm.restore(1, jtree)


def _make_runner(tmp_path, ckpt_every=5):
    def step_fn(state, batch):
        s = {"step": state["step"] + 1,
             "acc": state["acc"] + float(np.sum(batch["tokens"]) % 97)}
        return s, {"acc": s["acc"]}

    pipe = TokenPipeline(vocab_size=100, batch=2, seq=8, seed=1)
    return TrainRunner(step_fn=step_fn, batch_fn=pipe.batch_at,
                       ckpt=CheckpointManager(str(tmp_path), async_save=False),
                       ckpt_every=ckpt_every)


def test_runner_recovers_from_injected_failures_with_clean_history(tmp_path):
    s0 = {"step": 0, "acc": 0.0}
    ref_state, ref_info = _make_runner(tmp_path / "clean").run(dict(s0), num_steps=20)
    state, info = _make_runner(tmp_path / "faulty").run(dict(s0), num_steps=20,
                                                        fail_at={3: 1, 13: 2})
    assert info["restarts"] == 3
    assert state == ref_state
    assert info["history"] == ref_info["history"] and len(info["history"]) == 20


def test_runner_gives_up_after_max_restarts(tmp_path):
    r = _make_runner(tmp_path)
    r.max_restarts = 2
    with pytest.raises(RuntimeError, match="injected"):
        r.run({"step": 0, "acc": 0.0}, num_steps=10, fail_at={3: 99})


def test_straggler_monitor_flags_outliers_and_excludes_warmup():
    m = StragglerMonitor(deadline_factor=3.0, warmup=2)
    for i, dt in enumerate([0.1, 0.1, 0.1, 0.1, 0.1, 1.0, 0.1]):
        m.observe(i, dt)
    assert m.straggler_steps == [5] and m.p50 == pytest.approx(0.1, rel=0.05)
    m = StragglerMonitor(deadline_factor=3.0, warmup=3)
    for i, dt in enumerate([5.0, 5.0, 5.0, 0.1, 0.1, 0.1, 0.1]):
        m.observe(i, dt)
    assert m.straggler_steps == [] and m.p50 == pytest.approx(0.1, rel=0.05)
    assert m.p95 < 1.0
    early = StragglerMonitor(warmup=3)
    early.observe(0, 2.0)
    assert early.p50 == pytest.approx(2.0)


def test_straggler_monitor_bridges_registry():
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    m = StragglerMonitor(deadline_factor=3.0, warmup=2, registry=reg)
    for i, dt in enumerate([0.1, 0.1, 0.1, 0.1, 1.0]):
        m.observe(i, dt)
    assert reg.counter("runtime.straggler.stragglers").value == 1
    assert reg.gauge("runtime.straggler.p50_ms").value == pytest.approx(m.p50 * 1e3)
    assert reg.histogram("runtime.straggler.step_ms").count == 5


def _lm_runner(tmp_path, model, opt, ckpt_every):
    pipe = TokenPipeline(vocab_size=model.cfg.vocab_size, batch=2, seq=16, seed=0)

    def step_fn(state, batch):
        p, s, mets = train_step(model, opt, state[0], state[1], batch)
        return (p, s), {"loss": float(mets["loss"])}

    return TrainRunner(step_fn=step_fn, batch_fn=pipe.batch_at,
                       ckpt=CheckpointManager(str(tmp_path), async_save=False),
                       ckpt_every=ckpt_every)


def test_runner_failure_before_first_checkpoint_restarts_from_initial_state(tmp_path):
    """The train step moves the state in place; a failure before the first
    checkpoint must restart from the true initial state (the runner's host
    copy), and a failure after one from the checkpoint: both end equal to
    an uninterrupted run, bit for bit, with its loss history."""
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    finals = []
    for name, fail_at in (("clean", None), ("early", {1: 1}), ("late", {4: 1})):
        model = build_model(reduced_config("gemma-2b"), device="cpu").requires_grad_(True)
        params = dict(model.named_parameters())
        state, info = _lm_runner(tmp_path / name, model, opt, 3).run(
            (params, adamw_init(params)), num_steps=6, fail_at=fail_at)
        assert info["restarts"] == (fail_at is not None)
        finals.append((state, [h["loss"] for h in info["history"]]))
    (ref, ref_hist), *others = finals
    for state, hist in others:
        assert hist == ref_hist
        for k in ref[0]:
            assert torch.equal(state[0][k], ref[0][k]), k
        assert int(state[1]["step"]) == int(ref[1]["step"]) == 6


def test_elastic_restore_refuses_by_name(tmp_path):
    """A one-process checkpoint of a reduced model's (params, opt_state)
    restored onto each rank of a (2, 1) data mesh (``elastic_restore`` with
    that rank's shardings): the two ranks' pieces tile every leaf, and a
    leaf whose ``embed_fsdp`` dimension does not divide stays whole."""
    from _torch_dist import rank_view
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.optim.adamw import opt_state_axes

    model = build_model(reduced_config("gemma-2b"), device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    state = (params, adamw_init(params))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    axes = (model.param_axes(), opt_state_axes(model.param_axes()))
    got = []
    for r in range(2):
        mesh = rank_view((2, 1), ("data", "model"), (r, 0))
        got.append(elastic_restore(mgr, 1, state,
                                   tree_shardings(axes, (params, state[1]), mesh)))
    sh = tree_shardings(axes[0], params, rank_view((2, 1), ("data", "model"), (0, 0)))
    split = 0
    for k, p in params.items():
        spec = sh[k].spec
        dim = next((i for i, part in enumerate(spec) if part and "data" in part), None)
        if dim is None:
            assert all(torch.equal(g[0][k], p) for g in got), k
            continue
        split += 1
        assert torch.equal(torch.cat([g[0][k] for g in got], dim=dim), p), k
    assert split > 0 and all(int(g[1]["step"]) == 0 for g in got)
    assert elastic_restore(mgr, 1, state, None)[0]["tok_embed"].shape == params[
        "tok_embed"].shape


# ---- a reduced dense model's steps against the reference ----------------------


def test_dense_train_steps_match_reference():
    """codeqwen1.5-7b at reduced config (grad_accum 1): step 1's loss and
    every gradient, then the parameters and both moments after 3 steps of
    ``train_step`` against the reference's ``value_and_grad`` +
    ``adamw_update`` on the reference pipeline's batches."""
    jm, params, model = reference_model("codeqwen1.5-7b", cfgset={"grad_accum": 1})
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    opt, jopt = AdamWConfig(**kw), j_adamw.AdamWConfig(**kw)
    pipe = JTokenPipeline(vocab_size=model.cfg.vocab_size, batch=2, seq=64, seed=5)

    @jax.jit
    def j_step(p, s, batch):
        (loss, _), g = jax.value_and_grad(jm.loss_fn, has_aux=True)(p, batch)
        p, s, om = j_adamw.adamw_update(jopt, p, g, s)
        return p, s, loss, g

    tp = dict(model.named_parameters())
    ts = adamw_init(tp)
    jp, js = params, j_adamw.adamw_init(params)
    flippable = None
    for step in range(3):
        batch = jax.tree.map(np.asarray, pipe.batch_at(step))
        if step == 0:
            _, _, grads = port_grads(model, batch)
        jp, js, j_loss, j_g = j_step(jp, js, batch)
        tp, ts, mets = train_step(model, opt, tp, ts, batch)
        np.testing.assert_allclose(float(mets["loss"]), float(j_loss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"step {step} loss")
        g = _ref_leaves(jax.tree.map(np.asarray, j_g))
        if step == 0:
            assert_grads_close(jax.tree.map(np.asarray, j_g), grads, "step 0")
        tiny = {k: np.abs(v) <= NEAR_ZERO * np.abs(v).max() for k, v in g.items()}
        flippable = tiny if flippable is None else {k: flippable[k] | tiny[k] for k in g}
    excused = _assert_state_close(_ref_leaves(jp), tp, "params", flippable, lr=opt.lr)
    _assert_state_close(_ref_leaves(js["m"]), ts["m"], "m")
    _assert_state_close(_ref_leaves(js["v"]), ts["v"], "v")
    assert int(ts["step"]) == 3
    assert excused <= NEAR_ZERO_SHARE * sum(p.numel() for p in tp.values())


def _reduced_cfgset(arch: str) -> dict:
    full, red = get_config(arch), reduced_config(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def test_grad_accum_through_build_cell_matches_reference_scan():
    """gemma-2b's grad_accum 2 (its reduced config keeps it): the reference's
    ``build_cell(...)`` train step (its scan over two microbatches, gradients
    summed in float32) runs one step; its parameters and optimizer state
    carry into the port (``lm_from_arrays``, ``adamw_state_from_arrays``),
    and the second step runs in both: loss, metrics, parameters and
    moments agree."""
    arch, cfgset = "gemma-2b", _reduced_cfgset("gemma-2b")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcell = j_build_cell(arch, "train_4k", make_host_mesh(), cfgset=cfgset,
                         opt=j_adamw.AdamWConfig(**kw))
    cell = build_cell(arch, "train_4k", device="cpu", cfgset=cfgset, opt=AdamWConfig(**kw))
    assert cell.kind == "train" and cell.model.cfg.grad_accum == 2
    assert cell.args[2]["tokens"].shape == (256, 4096) and cell.args[0].keys() == dict(
        cell.model.named_parameters()).keys()
    params, _ = jcell.model.init(jax.random.PRNGKey(0))
    pipe = JTokenPipeline(vocab_size=cell.model.cfg.vocab_size, batch=4, seq=64, seed=2)
    j_step = jax.jit(jcell.step_fn)
    jp, js, _ = j_step(params, j_adamw.adamw_init(params), pipe.batch_at(0))
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    tp = dict(lm_from_arrays(cell.model.cfg, jp, device="cpu").named_parameters())
    ts = adamw_state_from_arrays(cell.model.cfg, js, device="cpu")
    assert int(ts["step"]) == 1 and ts["m"].keys() == tp.keys()
    batch = jax.tree.map(np.asarray, pipe.batch_at(1))
    jp, js, jm = j_step(jp, js, batch)
    tp, ts, tm = cell.step_fn(tp, ts, batch)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=k)
    _assert_state_close(_ref_leaves(jax.tree.map(np.asarray, jp)), tp, "params")
    _assert_state_close(_ref_leaves(js["m"]), ts["m"], "m")
    _assert_state_close(_ref_leaves(js["v"]), ts["v"], "v")
    # the cell's model computes with the carried tensors
    assert cell.model.tok_embed.data_ptr() == tp["tok_embed"].data_ptr()


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_remat_on_equals_off(arch):
    """Recomputing the layers, the hybrid's shared block, the vlm's cross
    blocks, the attention q-chunks (4 of 32 rows) and the loss chunks (2 of
    64 positions) changes no gradient."""
    cfg = reduced_config(arch)
    batch = train_inputs(cfg, b=1, s=128)
    out = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), seed=3,
                            device="cpu").requires_grad_(True)
        out.append(port_grads(model, batch))
    assert out[0][0] == out[1][0]
    for k, g in out[0][2].items():
        np.testing.assert_allclose(out[1][2][k], g, rtol=1e-6, atol=1e-7, err_msg=k)


def test_remat_streamed_loss_matches_reference():
    """gemma-2b with remat on in both packages over 128 positions: the loss
    streams over two 64-position chunks and attention over four q-chunks."""
    jm, params, model = reference_model("gemma-2b", cfgset={"remat": True})
    batch = train_inputs(model.cfg, b=2, s=128, seed=4)
    (j_loss, _), j_g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = port_grads(model, batch)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert_grads_close(jax.tree.map(np.asarray, j_g), grads, "gemma-2b remat")


def test_ssd_masked_exponent_keeps_gradients_finite():
    """A fast-decaying SSD chunk (A_log = 2, 128-token chunks) overflows
    ``exp(cum_i - cum_j)`` above the diagonal: the reference's masked
    product then back-propagates 0 * inf = NaN into every gradient up to
    the embedding.  The port masks the exponent first: the same loss, the
    same gradients where the reference's are finite (the head), and finite
    everywhere."""
    cfgset = {"ssm_chunk": 128}
    jm, params, _ = reference_model("mamba2-130m", cfgset=cfgset)
    params["stacks"][0]["ssm"]["A_log"] = np.full_like(params["stacks"][0]["ssm"]["A_log"], 2.0)
    model = lm_from_arrays(dataclasses.replace(reduced_config("mamba2-130m"), **cfgset),
                           params, device="cpu").requires_grad_(True)
    batch = train_inputs(model.cfg, b=2, s=128, seed=1)
    (j_loss, _), j_g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = port_grads(model, batch)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    ref = _ref_leaves(jax.tree.map(np.asarray, j_g))
    assert np.isnan(ref["tok_embed"]).any()  # the reference's fault
    for k, g in grads.items():
        assert np.isfinite(g).all(), k
        if np.isfinite(ref[k]).all():
            np.testing.assert_allclose(g, ref[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(ref[k]).max(), err_msg=k)
    assert np.isfinite(ref["final_norm.w"]).all()


# ---- the driver ---------------------------------------------------------------


@pytest.mark.parametrize("fail_at", [3, 7])
def test_train_cli_restarts_and_matches_uninterrupted_run(tmp_path, capsys, fail_at):
    """``launch/train.py --arch mamba2-130m --reduced --device cpu`` with
    ``--fail-at``: one restart, before the first checkpoint (from the
    initial state) or after it (from the checkpoint at step 5), the loss
    improves, and the final parameters and history equal an uninterrupted
    run's bit for bit."""
    base = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--steps", "10",
            "--batch", "4", "--seq", "32", "--lr", "3e-3", "--ckpt-every", "5"]
    state, info = t_train.main(base + ["--fail-at", str(fail_at),
                                       "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "restarts=1" in out and info["restarts"] == 1
    ref, ref_info = t_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert ref_info["restarts"] == 0 and len(info["history"]) == 10
    losses = [h["loss"] for h in info["history"]]
    assert losses[-1] < losses[0] and losses == [h["loss"] for h in ref_info["history"]]
    for k in ref[0]:
        assert torch.equal(state[0][k], ref[0][k]), k
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [5, 10]


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--grad-compress"]])
def test_train_cli_refuses_multi_device_flags_by_name(flags, tmp_path, capsys):
    """The reference's multi-device flags, served: ``--devices 2`` (2 gloo
    CPU ranks) trains as one process does, its losses and grad norms within
    1e-5 and its step-4 checkpoint within float32 rounding (a near-zero
    gradient's sign may flip Adam's step: at most 1e-3 of a leaf, by at
    most 2 lr a step); ``--grad-compress`` in one process checkpoints its
    error buffer beside the state, and a run restarted from it after a
    failure ends equal to an uninterrupted one bit for bit."""
    base = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--lr", "3e-3"]
    model = build_model(reduced_config("mamba2-130m"), device="cpu")
    full = {k: v.detach() for k, v in model.named_parameters()}
    if flags[0] == "--devices":
        base += ["--steps", "4", "--ckpt-every", "4"]
        _, info = t_train.main(base + flags + ["--ckpt-dir", str(tmp_path / "a")])
        out = capsys.readouterr().out
        assert info["restarts"] == 0 and len(info["history"]) == 4
        mgr = CheckpointManager(str(tmp_path / "a"))
        assert "[ranks] 2 ranks over gloo on cpu" in out
        _, one = t_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([h[key] for h in info["history"]],
                                       [h[key] for h in one["history"]], rtol=1e-5, atol=1e-5)
        like = (full, adamw_init(full), None)
        got = mgr.restore(4, like)
        want = CheckpointManager(str(tmp_path / "b")).restore(4, like)
        for k in full:
            g, w = got[0][k].numpy(), want[0][k].numpy()
            bad = ~np.isclose(g, w, rtol=1e-5, atol=1e-5)
            assert bad.sum() <= 1e-3 * g.size and np.abs(g - w).max() <= 2 * 3e-3 * 4, k
        return
    base += ["--steps", "10", "--ckpt-every", "5"] + flags
    state, info = t_train.main(base + ["--fail-at", "7", "--ckpt-dir", str(tmp_path / "a")])
    ref, ref_info = t_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert info["restarts"] == 1 and ref_info["restarts"] == 0
    assert [h["loss"] for h in info["history"]] == [h["loss"] for h in ref_info["history"]]
    for part in (0, 2):  # the parameters and the error buffer
        assert all(torch.equal(state[part][k], ref[part][k]) for k in full)
    zeros = {k: torch.zeros(v.shape) for k, v in full.items()}
    _, opt, ebuf = CheckpointManager(str(tmp_path / "a")).restore(
        10, (full, adamw_init(full), zeros))
    assert int(opt["step"]) == 10 and any(float(e.abs().max()) > 0 for e in ebuf.values())
    assert all(torch.equal(ebuf[k], ref[2][k]) for k in full)
