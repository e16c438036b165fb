"""The port's "pod" mesh axis against the reference's partitioned steps.

The reference puts ``batch`` over ("pod", "data") by its prefix rule,
keeps ``embed_fsdp`` on "data" (so "pod" is pure data parallelism between
pods) and spreads long_500k's ``kv_seq`` over ("model", "data", "pod").
The reference side is two subprocesses (half the cases each) on a forced
8-device CPU mesh: for each case it jits the reference's train step
(``loss_fn`` under ``use_rules``, the microbatch scan at ``grad_accum`` 2,
``adamw_update``), its ``prefill`` and its decode steps with
``in_shardings`` from ``tree_shardings`` under the case's rule overrides,
on a (2, 1, 2) or a (2, 2, 2) ("pod", "data", "model") mesh.  The port
side runs the same cases on gloo CPU ranks
(``tests/_torch_dist.pod_parity_rank``): ``launch.steps.DataParallel`` over
``launch.mesh.make_mesh(shape, ("pod", "data", "model"), "cpu")``, a
4-rank and an 8-rank group spawned once for all their cases.

Held, at reduced config in float32, at ``tests/test_torch_tensor_parallel.py``'s
tolerances: the loss and metrics within 1e-5, every summed gradient leaf
within rtol 1e-4 (atol 1e-4 x the leaf's max |g|), the parameters and both
moments after one step within 1e-5 (a near-zero gradient's flipped sign
excused, at most 1e-3 of a leaf), the prefill and decode logits within rtol
1e-5, every cache leaf within the LM harness's 1e-4; each rank's pieces of
``local_shape`` of the reference's spec.  The cases: codeqwen (GQA,
grad_accum 2), mixtral (its MoE counts summed over pod x data, and at
grad_accum 2), mamba2, a batch of 2 rows on (2, 2, 2) that the prefix rule
splits over "pod" alone, and gemma2-9b's long_500k decode with its slots on
all 8 ranks, the decode positions crossing their blocks.  Besides: a
one-process checkpoint restored onto both meshes and back bit for bit, the
compressed all-reduce equal on every rank and to one process, build_cell's
long_500k decode cell against one process, and the dry run's
``rank_collectives`` against what a live rank's ``Traffic`` counted for
the same step (kept here, beside the 8-rank group it reuses).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_lm import ATOL, INT8_NEAR_TIES, LOSS_TOL, RTOL, lm_inputs, train_inputs  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.distributed.collectives import compressed_grad_allreduce  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, local_shape, local_slice  # noqa: E402
from repro_torch.interop import lm_caches_close  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.steps import RULE_OVERRIDES, build_cell  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
LOGIT_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATE_TOL = 1e-5
NEAR_SHARE = 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LONG = RULE_OVERRIDES["long_500k"]
S, CACHE_LEN = 32, 16
# (architecture, config changes, rule overrides, (pod, data, model), rows,
#  train and prefill too, decode from, decode steps)
CASES = [("codeqwen1.5-7b", {"grad_accum": 2}, None, (2, 2, 2), 8, True, 6, 4),
         ("mixtral-8x7b", {"grad_accum": 1}, None, (2, 2, 2), 4, True, 6, 4),
         # 2 rows: the prefix rule splits them over "pod" alone
         ("codeqwen1.5-7b", {"grad_accum": 1}, None, (2, 2, 2), 2, True, 6, 4),
         # one row, 16 slots in 8 blocks of 2: positions 5..10 cross four
         ("gemma2-9b", {}, LONG, (2, 2, 2), 1, False, 5, 6),
         ("mamba2-130m", {"grad_accum": 1}, None, (2, 1, 2), 4, True, 6, 4),
         ("mixtral-8x7b", {"grad_accum": 2}, None, (2, 1, 2), 8, True, 6, 4)]
CASE_IDS = [f"{a}-ga{c.get('grad_accum', 1)}-b{b}{'-long_500k' if o else ''}-"
            f"{'x'.join(map(str, m))}" for a, c, o, m, b, *_ in CASES]
TRAIN = [c for c, case in enumerate(CASES) if case[5]]

_REF = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    import dataclasses
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import reduced_config
    from repro.distributed.sharding import tree_shardings, use_rules
    from repro.launch.mesh import make_mesh_compat
    from repro.models.model import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update, opt_state_axes
    from repro_torch.interop import lm_param_map

    a = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    out = {}

    def named(prefix, tree):
        for name, leaf, layer in lm_param_map(jax.tree.map(np.asarray, tree)):
            out[f"{prefix}/{name}"] = leaf if layer is None else leaf[layer]

    def caches_out(prefix, caches):
        for key, c in caches.items():
            for field, leaf in zip(c._fields, c):
                out[f"{prefix}/{key}/{field}"] = np.asarray(leaf)

    def spec_of(sh, ndim):
        parts = [None if p is None else (p,) if isinstance(p, str) else tuple(p)
                 for p in sh.spec]
        return parts + [None] * (ndim - len(parts))

    class Leaf:
        def __init__(self, sh, shape):
            self.spec, self.shape = sh.spec, shape

    for case in cases:
        c = case["c"]
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfgset"])
        rules = {k: tuple(v) for k, v in (case["overrides"] or {}).items()}
        mesh = make_mesh_compat(tuple(case["mesh"]), ("pod", "data", "model"))
        model = build_model(cfg)
        params, axes = model.init(jax.random.PRNGKey(c))
        param_sh = tree_shardings(axes, params, mesh, rules)
        for name, leaf, _ in lm_param_map(jax.tree.map(lambda sh, p: Leaf(sh, p.shape),
                                                       param_sh, params)):
            out[f"{c}/spec/{name}"] = np.asarray(json.dumps(spec_of(leaf, len(leaf.shape))))
        pkeys = [k[len(f"{c}/p/"):] for k in a if k.startswith(f"{c}/p/")]
        prompt = {k: a[f"{c}/p/{k}"] for k in pkeys}
        prompt_sh = tree_shardings({k: ("batch",) + (None,) * (v.ndim - 1)
                                    for k, v in prompt.items()}, prompt, mesh, rules)
        if case["train"]:
            opt = AdamWConfig(**case["opt"])
            opt_state = adamw_init(params)
            opt_sh = tree_shardings(opt_state_axes(axes), opt_state, mesh, rules)
            bkeys = [k[len(f"{c}/b/"):] for k in a if k.startswith(f"{c}/b/")]
            batch = {k: a[f"{c}/b/{k}"] for k in bkeys}
            batch_sh = tree_shardings({k: ("batch",) + (None,) * (v.ndim - 1)
                                       for k, v in batch.items()}, batch, mesh, rules)
            ga = max(cfg.grad_accum, 1)

            def train(params, opt_state, batch):
                with use_rules(mesh, rules):
                    if ga == 1:
                        (loss, mets), grads = jax.value_and_grad(
                            model.loss_fn, has_aux=True)(params, batch)
                    else:
                        mb = jax.tree.map(
                            lambda x: x.reshape(ga, x.shape[0] // ga, *x.shape[1:]), batch)

                        def body(carry, b_i):
                            gsum, lsum = carry
                            (l, mets_i), g = jax.value_and_grad(
                                model.loss_fn, has_aux=True)(params, b_i)
                            gsum = jax.tree.map(lambda x, y: x + y.astype(jnp.float32),
                                                gsum, g)
                            return (gsum, lsum + l), mets_i

                        zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                        (gsum, lsum), mets = jax.lax.scan(
                            body, (zeros, jnp.zeros((), jnp.float32)), mb)
                        grads = jax.tree.map(lambda g: g / ga, gsum)
                        loss = lsum / ga
                        mets = jax.tree.map(lambda m: m[-1], mets)
                    new_p, new_s, om = adamw_update(opt, params, grads, opt_state)
                return new_p, new_s, grads, loss, mets, om

            p, s, grads, loss, mets, om = jax.jit(
                train, in_shardings=(param_sh, opt_sh, batch_sh))(params, opt_state, batch)
            out[f"{c}/loss"] = np.asarray(loss)
            for k, v in {**mets, **om}.items():
                out[f"{c}/{k}"] = np.asarray(v)
            named(f"{c}/grads", grads)
            named(f"{c}/params", p)
            named(f"{c}/m", s["m"])
            named(f"{c}/v", s["v"])

            def prefill(params, prompt):
                with use_rules(mesh, rules):
                    return model.prefill(params, prompt)

            logits, caches = jax.jit(prefill, in_shardings=(param_sh, prompt_sh))(params,
                                                                                prompt)
            out[f"{c}/prefill_logits"] = np.asarray(logits)
            caches_out(f"{c}/prefill_caches", caches)

        rows = prompt["tokens"].shape[0]
        caches, cache_axes = model.init_caches(rows, case["cache_len"])
        cache_sh = tree_shardings(cache_axes, caches, mesh, rules)
        tok = jax.ShapeDtypeStruct((rows, 1), jnp.int32)
        token_sh = tree_shardings(("batch", "seq"), tok, mesh, rules)
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

        def serve(params, token, caches, pos):
            with use_rules(mesh, rules):
                return model.decode_step(params, token, caches, pos)

        step = jax.jit(serve, in_shardings=(param_sh, token_sh, cache_sh, repl))
        for t in range(case["decode_steps"]):
            lg, caches = step(params, jnp.asarray(prompt["tokens"][:, t:t + 1]), caches,
                              jnp.asarray(case["decode_at"] + t, jnp.int32))
            out[f"{c}/decode_logits/{t}"] = np.asarray(lg)
        caches_out(f"{c}/decode_caches", caches)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_process_checkpoint(path):
    """A one-process checkpoint of a reduced gemma-2b's (params, opt_state)."""
    model = build_model(reduced_config("gemma-2b"), seed=3, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt = adamw_init(params)
    for k, m in opt["m"].items():
        m.copy_(torch.randn(m.shape, generator=torch.Generator().manual_seed(len(k))))
    opt["step"].fill_(4)
    CheckpointManager(str(path), async_save=False).save(4, (params, opt))
    return params, opt


def _codec_inputs():
    rng = np.random.default_rng(11)
    shapes = {"a": (33, 7), "b": (5,), "c": (2, 3, 4)}
    return {"g": {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()},
            "e": {k: 1e-3 * rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two subprocesses and the port's 4-rank and 8-rank
    groups, run side by side."""
    tmp = tmp_path_factory.mktemp("pod")
    inputs, spec, by_world = {}, [], {4: {}, 8: {}}
    for c, (arch, cfgset, overrides, mesh, rows, train, at, steps) in enumerate(CASES):
        jcfg = dataclasses.replace(j_reduced_config(arch), **cfgset)
        prompt = lm_inputs(jcfg, b=rows, s=S, seed=100 + c)
        inputs.update({f"{c}/p/{k}": v for k, v in prompt.items()})
        case = dict(c=c, arch=arch, cfgset=cfgset, overrides=overrides, mesh=mesh, opt=OPT,
                    cache_len=CACHE_LEN, decode_at=at, decode_steps=steps, train=train,
                    prefill=train)
        if train:
            batch = train_inputs(jcfg, b=rows, s=S, seed=c)
            inputs.update({f"{c}/b/{k}": v for k, v in batch.items()})
            case["batch"] = batch
        spec.append({k: v for k, v in case.items() if k != "batch"})
        by_world[int(np.prod(mesh))][c] = dict(case, prompt=prompt)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "in.npz"), str(tmp / f"out{part}.npz"),
         json.dumps(spec[part::2])], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for part in range(2)]
    groups = {}
    try:
        for world, cases in by_world.items():
            for c, case in cases.items():
                jcfg = dataclasses.replace(j_reduced_config(case["arch"]), **case["cfgset"])
                case["params"] = jax.tree.map(
                    np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(c))[0])
                case["opt_state"] = jax.tree.map(np.asarray, j_adamw_init(case["params"]))
        one = _one_process_checkpoint(tmp / "one")
        codec = _codec_inputs()
        for world, cases in by_world.items():
            with open(tmp / f"cases{world}.pkl", "wb") as f:
                pickle.dump(cases, f)
            groups[world] = spawn(_torch_dist.pod_parity_rank, world, backend="gloo",
                                  init_file=str(tmp / f"init{world}"), device="cpu",
                                  args=(str(tmp / f"cases{world}.pkl"),
                                        (str(tmp / "one"), "gemma-2b"), codec))
        port = {world: g.join(timeout_s=300) for world, g in groups.items()}
        errs = [p.communicate(timeout=300)[1] for p in ref_procs]
    finally:
        for g in groups.values():
            g.terminate()
        for p in ref_procs:
            p.kill()
            p.wait()
    for p, err in zip(ref_procs, errs):
        assert p.returncode == 0, err[-4000:]
    ref = {}
    for part in range(2):
        ref.update(np.load(tmp / f"out{part}.npz"))
    return ref, port, one, codec, tmp


def _ref_tree(ref, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


def _close(got: dict, ref: dict, what: str, rtol, atol_of, excusable=None):
    """Every leaf of ``got`` against ``ref``; elements off tolerance must
    lie in ``excusable[name]``, at most NEAR_SHARE of the leaf."""
    assert got.keys() == ref.keys(), (what, sorted(got.keys() ^ ref.keys())[:4])
    for k, r in ref.items():
        g = np.asarray(got[k], np.float32)
        r = np.asarray(r, np.float32)
        bad = ~np.isclose(g, r, rtol=rtol, atol=atol_of(k))
        ok = np.zeros_like(bad) if excusable is None else excusable[k]
        assert not (bad & ~ok).any(), (
            f"{what} {k}: {int((bad & ~ok).sum())} of {r.size} differ, up to "
            f"{float(np.abs(g - r)[bad & ~ok].max()):.3e}")
        assert (bad & ok).sum() <= NEAR_SHARE * r.size, (what, k, int((bad & ok).sum()))


def _world(c):
    return int(np.prod(CASES[c][3]))


def _ranks(port, c):
    return [port[_world(c)][r]["cases"][c] for r in range(_world(c))]


@pytest.mark.parametrize("c", TRAIN, ids=[CASE_IDS[c] for c in TRAIN])
def test_pod_train_step_matches_reference(runs, c):
    """Loss, metrics, every summed gradient leaf and the state after one
    step, gathered from the ranks' pieces, against the reference's
    partitioned step; every rank, both pods alike, agrees."""
    ref, port, *_ = runs
    ranks = _ranks(port, c)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], float(ref[f"{c}/loss"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for k in ("nll", "aux", "grad_norm", "lr"):
        val = got["mets"][k] if k in got["mets"] else got["om"][k]
        np.testing.assert_allclose(val, float(ref[f"{c}/{k}"]), rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=k)
    rgrads = _ref_tree(ref, f"{c}/grads")
    gmax = {k: float(np.abs(r).max()) for k, r in rgrads.items()}
    _close(got["grads"], rgrads, "gradient", GRAD_RTOL, lambda k: GRAD_RTOL * gmax[k])
    flippable = {k: np.abs(r) <= GRAD_RTOL * gmax[k] for k, r in rgrads.items()}
    for part in ("params", "m", "v"):
        _close(got[part], _ref_tree(ref, f"{c}/{part}"), part, STATE_TOL,
               lambda k: STATE_TOL, flippable)
    for other in ranks[1:]:
        assert other["loss"] == got["loss"] and other["om"] == got["om"]
        for part in ("params", "m", "v"):
            for k, v in got[part].items():
                assert np.array_equal(v, other[part][k]), (part, k)


@pytest.mark.parametrize("c", TRAIN, ids=[CASE_IDS[c] for c in TRAIN])
def test_pod_rank_pieces_have_the_reference_local_shapes(runs, c):
    """Each rank's parameter and moment pieces have ``local_shape`` of the
    reference's spec (no leaf split over "pod": replicated between pods),
    and equal ``interop.local_state_from_arrays`` of its arrays."""
    ref, port, *_ = runs
    mesh = AbstractMesh(CASES[c][3], AXES)
    for r, got in enumerate(_ranks(port, c)):
        assert got["pieces_equal"], r
        for name, shape in got["shapes"].items():
            spec = [tuple(p) if p else None for p in json.loads(str(ref[f"{c}/spec/{name}"]))]
            full = ref[f"{c}/params/{name}"].shape
            spec = spec[len(spec) - len(full):]
            assert not any(p and "pod" in p for p in spec), (name, spec)
            want = local_shape(full, tuple(spec), mesh)
            assert shape == want and got["moment_shapes"][name] == want, (r, name, shape, want)


@pytest.mark.parametrize("c", range(len(CASES)), ids=CASE_IDS)
def test_pod_prefill_and_decode_match_reference(runs, c):
    """The prefill's logits and caches (where the case prefills), then its
    decode steps' logits and the caches after them, gathered from the
    ranks' pieces, against the reference's partitioned prefill and decode;
    long_500k's slots lie in 8 blocks, one a rank, in the reference's
    (model, data, pod) order."""
    ref, port, *_ = runs
    for got in _ranks(port, c):
        if CASES[c][5]:
            want = ref[f"{c}/prefill_logits"]
            np.testing.assert_allclose(got["prefill_logits"], want, rtol=LOGIT_RTOL,
                                       atol=LOGIT_RTOL * float(np.abs(want).max()))
        assert len(got["decode_logits"]) == CASES[c][7]
        for t, lg in enumerate(got["decode_logits"]):
            want = ref[f"{c}/decode_logits/{t}"]
            np.testing.assert_allclose(lg, want, rtol=LOGIT_RTOL,
                                       atol=LOGIT_RTOL * float(np.abs(want).max()),
                                       err_msg=f"decode step {t}")
        for phase in ("prefill_caches", "decode_caches") if CASES[c][5] else ("decode_caches",):
            mine = got[phase]
            theirs = {key: type(cv)(*(ref[f"{c}/{phase}/{key}/{f}"] for f in cv._fields))
                      for key, cv in mine.items()}
            lm_caches_close(theirs, mine, rtol=RTOL, atol=ATOL, near_ties=INT8_NEAR_TIES,
                            what=phase)
        if CASES[c][2] is LONG:
            blocks = got["cache_blocks"]["kv1"]
            assert blocks[0] == (2, ("model", "data", "pod")), blocks  # (layers, B, S, ...)


def test_batch_of_two_splits_over_pod_alone(runs):
    """The prefix rule: 2 rows on (2, 2, 2) split over "pod" and are
    replicated over "data", so the gradients sum over "pod" (and "model")
    only; 8 rows split over pod x data."""
    _, port, *_ = runs
    two = port[8][0]["cases"][2]["traffic"]
    eight = port[8][0]["cases"][0]["traffic"]
    assert any(k.startswith("pod gradient") for k in two), two
    assert not any(k.startswith("pod+data") for k in two), two
    assert any(k.startswith("pod+data gradient") for k in eight), eight


@pytest.mark.parametrize("world", [4, 8], ids=["2x1x2", "2x2x2"])
def test_one_process_checkpoint_restores_onto_pod_mesh_and_back(runs, world):
    """A one-process checkpoint restored onto a (2, 1, 2) and a (2, 2, 2)
    mesh: each rank's pieces are its ``local_slice`` of the full leaves,
    equal on both pods; saved back from the mesh it restores in one
    process equal bit for bit."""
    _, port, (params, opt), _, tmp = runs
    shape = (2, world // 4, 2)
    mesh = AbstractMesh(shape, AXES)
    for r in range(world):
        p_r, m_r, step = port[world][r]["restored"]
        assert step == 4
        coord = np.unravel_index(r, shape)
        for k, full in params.items():
            spec = port[world][r]["specs"][k]
            assert np.array_equal(p_r[k], local_slice(full, spec, mesh, coord).numpy()), k
            assert np.array_equal(m_r[k], local_slice(opt["m"][k], spec, mesh, coord).numpy())
        other = port[world][(r + world // 2) % world]["restored"]  # the other pod's twin
        assert all(np.array_equal(p_r[k], other[0][k]) for k in params)
    like = ({k: torch.zeros(v.shape) for k, v in params.items()},
            adamw_init({k: torch.zeros(v.shape) for k, v in params.items()}))
    back = CheckpointManager(f"{tmp / 'one'}-back{world}", async_save=False)
    p2, o2 = back.restore(back.latest_step(), like)
    for k in params:
        assert torch.equal(p2[k], params[k]), k
        assert torch.equal(o2["m"][k], opt["m"][k]), k
    assert int(o2["step"]) == 4


@pytest.mark.parametrize("world", [4, 8], ids=["2x1x2", "2x2x2"])
def test_compressed_allreduce_over_pod_and_data_equal_on_every_rank(runs, world):
    """``compressed_grad_allreduce`` over the batch's ranks (pod x data: 2
    or 4 of them) from the same arrays on every rank: every rank returns
    the same mean and error feedback, equal to one process's (a power-of-2
    group sums the equal codes exactly)."""
    _, port, _, codec, _ = runs
    g = {k: torch.as_tensor(v) for k, v in codec["g"].items()}
    e = {k: torch.as_tensor(v) for k, v in codec["e"].items()}
    mean, new_e = compressed_grad_allreduce(g, e)
    for r in range(world):
        got = port[world][r]
        assert got["codec_ranks"] == world // 2
        for k in g:
            assert np.array_equal(got["codec"][0][k], mean[k].numpy()), (r, k)
            assert np.array_equal(got["codec"][1][k], new_e[k].numpy()), (r, k)


def test_build_cell_long_500k_decode_over_every_axis(runs):
    """``build_cell("gemma2-9b", "long_500k")`` over (2, 2, 2): one row, the
    global layers' 16 slots in 8 blocks of 2 over (model, data, pod); 12
    decode steps, the windowed rings wrapping, equal one process's."""
    _, port, *_ = runs
    for r in range(8):
        got = port[8][r]
        assert got["long_blocks"] == (2, ("model", "data", "pod")), got["long_blocks"]
        assert got["long_500k"] < 1e-5, got["long_500k"]


@pytest.mark.parametrize("world", [4, 8], ids=["2x1x2", "2x2x2"])
def test_axis_comm_over_every_axis_gathers_in_index_order(runs, world):
    """An ``AxisComm`` over ("model", "data", "pod"), model major (the
    order of long_500k's slot blocks), gathers every rank's piece at its
    ``index``, though its group orders the ranks (pod, data, model)."""
    _, port, *_ = runs
    for r in range(world):
        assert port[world][r]["gather_order"] == list(range(world)), r


def test_dryrun_gradient_traffic_equals_live_rank(runs):
    """``dryrun.rank_collectives`` of codeqwen's reduced train step at
    grad_accum 2 on 8 rows over a (2, 2, 2) layout against what a live
    rank's ``Traffic`` counted for the same step and rows, kind by kind:
    the gradient all-reduce's bytes equal (the pod+data group, and
    pod+data+model for the leaves the model axis replicates).  Two kinds
    differ by design: ``param all-gather`` counts the gathered whole in the
    dry run (XLA's output convention) and the pieces a rank sends in
    ``Traffic``, a factor of the data axis; the loss, metric and
    grad-norm scalars' all-reduces are not in the dry run (a few bytes)."""
    _, port, *_ = runs
    c = 0
    arch, cfgset, _, shape, rows, *_ = CASES[c]
    mesh = AbstractMesh(shape, AXES)
    full = dataclasses.asdict(reduced_config(arch))
    full.pop("arch_id")
    cell = build_cell(arch, "train_4k", mesh=mesh, device="meta", cfgset={**full, **cfgset})
    params, opt_state, batch = cell.args
    cell.args = (params, opt_state, {k: torch.empty((rows, S), dtype=v.dtype, device="meta")
                                     for k, v in batch.items()})
    coll = dryrun.rank_collectives(cell, mesh, {"coll_by_kind": {}, "coll_count_by_kind": {}})
    dp = coll["data_parallel"]
    for r in range(8):
        live = port[8][r]["cases"][c]["traffic"]
        grads = {k: v for k, v in live.items() if k.endswith("gradient all-reduce")}
        assert set(grads) == {"pod+data gradient all-reduce",
                              "pod+data+model gradient all-reduce"}, live
        assert sum(grads.values()) == dp["gradient all-reduce"] > 0
        assert live["data param all-gather"] * shape[1] == dp["param all-gather"] > 0
        scalars = {k for k in live if k not in grads and not k.startswith("model all-")}
        assert scalars == {"data param all-gather", "pod+data+model loss all-reduce",
                           "model grad-norm all-reduce"}, live
