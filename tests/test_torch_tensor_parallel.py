"""The port's tensor parallelism (the "model" mesh axis) against the
reference's partitioned steps.

The reference side is three subprocesses (a third of the cases each) on a forced
4-device CPU mesh: for each case it jits the reference's train step (``loss_fn`` under
``use_rules``, the microbatch scan at ``grad_accum`` 2, ``adamw_update``),
its ``prefill`` and 4 ``decode_step`` calls (at positions that cross from
model rank 0's block of ``kv_seq`` cache slots into rank 1's, so both
ranks own ring writes and valid slots in the flash-decoding combine),
each with ``in_shardings``
from ``tree_shardings`` under the case's rule overrides, on a (1, 2) or a
(2, 2) ("data", "model") mesh, as ``src/repro/launch/steps.py`` composes
them.  The port side runs the same cases on gloo CPU ranks
(``tests/_torch_dist.tp_parity_rank``): ``launch.steps.DataParallel`` over
``make_host_mesh(D, M)``, each rank holding its pieces.  A 2-rank and a
4-rank group are spawned once for all their cases, beside the
subprocesses; each also runs every reduced architecture's cells from
``build_cell`` over its mesh and restores a one-process checkpoint.

Held, at reduced config in float32: the loss and metrics within 1e-5,
every summed gradient leaf within rtol 1e-4 (atol 1e-4 x the leaf's max
|g|), the parameters and both moments after one step within 1e-5 (a
near-zero gradient's sign may flip Adam's first step: such elements are
excused where the reference gradient is zero to that tolerance, at most
1e-3 of a leaf), the prefill logits and 4 decode steps' logits within
rtol 1e-5 (atol 1e-5 x the step's max |logit|), every prefill and decode
cache leaf within the LM harness's 1e-4 (int8 codes but for near-ties),
and each rank's parameter and moment pieces of ``local_shape`` of the
reference's spec.  Besides: a mesh the rules cannot express (an axis they
do not name) raises by name, a one-process checkpoint restores onto a (1, 2) and a (2, 2) mesh
and back bit for bit, and ``build_cell`` over either mesh gives runnable
train, prefill and decode cells for every reduced architecture.
"""

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
from _torch_lm import (ATOL, INT8_NEAR_TIES, LOSS_TOL, RTOL, lm_inputs,  # noqa: E402
                       train_inputs)
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.distributed.sharding import (AbstractMesh, RankView, local_shape,  # noqa: E402
                                              local_slice, use_rules)
from repro_torch.interop import lm_caches_close, lm_param_map  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.steps import DataParallel  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATE_TOL = 1e-5
NEAR_SHARE = 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
EP = {"expert": ("model",)}
# (architecture, config changes, rule overrides, (data, model) mesh)
CASES = [("codeqwen1.5-7b", {"grad_accum": 1}, None, (1, 2)),  # GQA, int8 KV cache
         ("codeqwen1.5-7b", {"grad_accum": 2}, None, (2, 2)),
         # MQA, tied vocab; remat'd query and loss chunks (their collectives rerun)
         ("gemma-2b", {"grad_accum": 1, "remat": True, "q_chunk": 16, "loss_chunk": 16}, None,
          (1, 2)),
         ("mixtral-8x7b", {"grad_accum": 1}, None, (2, 2)),  # TP-in-expert
         ("mixtral-8x7b", {"grad_accum": 1}, EP, (1, 2)),  # expert parallel
         ("mamba2-130m", {"grad_accum": 1}, None, (1, 2)),
         # the heads kept whole: the decode state split along ssm_state
         ("mamba2-130m", {"grad_accum": 1}, {"ssm_heads": ()}, (1, 2)),
         ("zamba2-1.2b", {"grad_accum": 1}, None, (2, 2)),
         ("whisper-small", {"grad_accum": 1}, None, (1, 2))]
CASE_IDS = [f"{a}-ga{c['grad_accum']}{''.join('-' + k for k in o or ())}-{d}x{m}"
            for a, c, o, (d, m) in CASES]
B, S, CACHE_LEN = 4, 32, 16
DECODE_AT = CACHE_LEN // 2 - 2  # decode positions 6..9: slots on both model ranks' blocks

_REF = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
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

    def spec_of(sh, ndim):
        parts = [None if p is None else (p,) if isinstance(p, str) else tuple(p)
                 for p in sh.spec]
        return parts + [None] * (ndim - len(parts))

    def caches_out(prefix, caches):
        for key, c in caches.items():
            for field, leaf in zip(c._fields, c):
                out[f"{prefix}/{key}/{field}"] = np.asarray(leaf)

    for case in cases:
        c = case["c"]
        cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfgset"])
        rules = {k: tuple(v) for k, v in (case["overrides"] or {}).items()}
        mesh = make_mesh_compat(tuple(case["mesh"]), ("data", "model"))
        model = build_model(cfg)
        params, axes = model.init(jax.random.PRNGKey(c))
        opt = AdamWConfig(**case["opt"])
        param_sh = tree_shardings(axes, params, mesh, rules)
        class Leaf:
            def __init__(self, sh, shape):
                self.spec, self.shape = sh.spec, shape

        for name, leaf, _ in lm_param_map(jax.tree.map(lambda sh, p: Leaf(sh, p.shape),
                                                       param_sh, params)):
            out[f"{c}/spec/{name}"] = np.asarray(json.dumps(spec_of(leaf, len(leaf.shape))))
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
                        gsum = jax.tree.map(lambda x, y: x + y.astype(jnp.float32), gsum, g)
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

        pkeys = [k[len(f"{c}/p/"):] for k in a if k.startswith(f"{c}/p/")]
        prompt = {k: a[f"{c}/p/{k}"] for k in pkeys}
        prompt_sh = tree_shardings({k: ("batch",) + (None,) * (v.ndim - 1)
                                    for k, v in prompt.items()}, prompt, mesh, rules)

        def prefill(params, prompt):
            with use_rules(mesh, rules):
                return model.prefill(params, prompt)

        logits, caches = jax.jit(prefill, in_shardings=(param_sh, prompt_sh))(params, prompt)
        out[f"{c}/prefill_logits"] = np.asarray(logits)
        caches_out(f"{c}/prefill_caches", caches)

        caches, cache_axes = model.init_caches(prompt["tokens"].shape[0], case["cache_len"])
        cache_sh = tree_shardings(cache_axes, caches, mesh, rules)
        tok = jax.ShapeDtypeStruct((prompt["tokens"].shape[0], 1), jnp.int32)
        token_sh = tree_shardings(("batch", "seq"), tok, mesh, rules)
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

        def serve(params, token, caches, pos):
            with use_rules(mesh, rules):
                return model.decode_step(params, token, caches, pos)

        step = jax.jit(serve, in_shardings=(param_sh, token_sh, cache_sh, repl))
        for t in range(4):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 2-rank and 4-rank groups,
    run side by side."""
    import dataclasses
    tmp = tmp_path_factory.mktemp("tp")
    inputs, spec, by_world = {}, [], {2: {}, 4: {}}
    for c, (arch, cfgset, overrides, mesh) in enumerate(CASES):
        jcfg = dataclasses.replace(j_reduced_config(arch), **cfgset)
        batch = train_inputs(jcfg, b=B, s=S, seed=c)
        prompt = lm_inputs(jcfg, b=B, s=S, seed=100 + c)
        inputs.update({f"{c}/b/{k}": v for k, v in batch.items()})
        inputs.update({f"{c}/p/{k}": v for k, v in prompt.items()})
        spec.append(dict(c=c, arch=arch, cfgset=cfgset, overrides=overrides, mesh=mesh,
                         opt=OPT, cache_len=CACHE_LEN, decode_at=DECODE_AT))
        by_world[mesh[0] * mesh[1]][c] = dict(spec[-1], batch=batch, prompt=prompt)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    # three reference processes, a third of the cases each: their compiles dominate
    ref_procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "in.npz"), str(tmp / f"out{part}.npz"),
         json.dumps(spec[part::3])], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for part in range(3)]
    groups = {}
    try:
        for world, cases in by_world.items():
            for c, case in cases.items():
                jcfg = dataclasses.replace(j_reduced_config(case["arch"]), **case["cfgset"])
                case["params"] = jax.tree.map(
                    np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(c))[0])
                case["opt_state"] = jax.tree.map(np.asarray, j_adamw_init(case["params"]))
        one = _one_process_checkpoint(tmp / "one")
        for world, cases in by_world.items():
            ckpt = (str(tmp / "one"), "gemma-2b")
            with open(tmp / f"cases{world}.pkl", "wb") as f:
                pickle.dump(cases, f)
            groups[world] = spawn(_torch_dist.tp_parity_rank, world, backend="gloo",
                                  init_file=str(tmp / f"init{world}"), device="cpu",
                                  args=(str(tmp / f"cases{world}.pkl"), ckpt))
        port = {world: g.join(timeout_s=240) for world, g in groups.items()}
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
    for part in range(3):
        ref.update(np.load(tmp / f"out{part}.npz"))
    return ref, port, one, tmp


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


def _ranks(port, c):
    d, m = CASES[c][3]
    return [port[d * m][r]["cases"][c] for r in range(d * m)]


@pytest.mark.parametrize("c", range(len(CASES)), ids=CASE_IDS)
def test_partitioned_train_step_matches_reference(runs, c):
    """Loss, metrics, every summed gradient leaf and the state after one
    step, gathered from the ranks' pieces, against the reference's
    partitioned step; every rank agrees."""
    ref, port, _, _ = runs
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
    # within the gradient's tolerance a gradient's sign is not determined
    flippable = {k: np.abs(r) <= GRAD_RTOL * gmax[k] for k, r in rgrads.items()}
    for part in ("params", "m", "v"):
        _close(got[part], _ref_tree(ref, f"{c}/{part}"), part, STATE_TOL,
               lambda k: STATE_TOL, flippable)
    for other in ranks[1:]:
        assert other["loss"] == got["loss"] and other["om"] == got["om"]
        for part in ("params", "m", "v"):
            for k, v in got[part].items():
                assert np.array_equal(v, other[part][k]), (part, k)


@pytest.mark.parametrize("c", range(len(CASES)), ids=CASE_IDS)
def test_rank_pieces_have_the_reference_local_shapes(runs, c):
    """Each rank's parameter and moment pieces have ``local_shape`` of the
    reference's spec for that leaf (a layer of a stacked leaf: its spec
    without the 'layers' entry), the model axis splits some of them, and
    they equal ``interop.local_state_from_arrays`` of the reference's
    arrays."""
    ref, port, _, _ = runs
    d, m = CASES[c][3]
    mesh = AbstractMesh((d, m), ("data", "model"))
    split = 0
    for r, got in enumerate(_ranks(port, c)):
        assert got["pieces_equal"], r
        for name, shape in got["shapes"].items():
            spec = [tuple(p) if p else None for p in json.loads(str(ref[f"{c}/spec/{name}"]))]
            full = ref[f"{c}/params/{name}"].shape
            spec = spec[len(spec) - len(full):]
            want = local_shape(full, tuple(spec), mesh)
            assert shape == want, (r, name, shape, want, spec)
            assert got["moment_shapes"][name] == want, (r, name)
            split += any(p and "model" in p for p in spec)
    assert split > 0


@pytest.mark.parametrize("c", range(len(CASES)), ids=CASE_IDS)
def test_partitioned_prefill_and_decode_match_reference(runs, c):
    """The prefill's logits and caches, then 4 decode steps' logits and the
    caches after them (positions ``DECODE_AT`` on: the writes land on both
    model ranks' blocks of a ``kv_seq``-split cache), gathered from the
    ranks' pieces, against the reference's partitioned prefill and
    decode."""
    ref, port, _, _ = runs
    for got in _ranks(port, c):
        want = ref[f"{c}/prefill_logits"]
        np.testing.assert_allclose(got["prefill_logits"], want, rtol=LOGIT_RTOL,
                                   atol=LOGIT_RTOL * float(np.abs(want).max()))
        for t, lg in enumerate(got["decode_logits"]):
            want = ref[f"{c}/decode_logits/{t}"]
            np.testing.assert_allclose(lg, want, rtol=LOGIT_RTOL,
                                       atol=LOGIT_RTOL * float(np.abs(want).max()),
                                       err_msg=f"decode step {t}")
        for phase in ("prefill_caches", "decode_caches"):
            mine = got[phase]
            theirs = {key: type(cv)(*(ref[f"{c}/{phase}/{key}/{f}"] for f in cv._fields))
                      for key, cv in mine.items()}
            lm_caches_close(theirs, mine, rtol=RTOL, atol=ATOL, near_ties=INT8_NEAR_TIES,
                            what=phase)


def test_unexpressible_mesh_raises_by_name():
    """A layout the port does not execute fails by name, never computes
    whole layers on every rank: a mesh axis of size > 1 that the rules do
    not name (a "pod" axis is executed: ``tests/test_torch_pod.py``), and
    an activation whose rules split one dimension over 'model' and 'data'
    together (only a decode cache's slots may be: long_500k)."""
    model = build_model(reduced_config("gemma-2b"), device="meta")
    with pytest.raises(ValueError, match=r"\['replica'\] cannot be expressed"):
        DataParallel(RankView((2, 2, 2), ("replica", "data", "model"), (0, 0, 0)), {})
    view = RankView((2, 2), ("data", "model"), (0, 1))
    tokens = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    with use_rules(view, {"act_seq": ("model", "data")}):
        with pytest.raises(NotImplementedError, match=r"split over 'model' and \['data'\]"):
            model.prefill({"tokens": tokens})


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_one_process_checkpoint_restores_onto_model_axis_and_back(runs, world):
    """A one-process checkpoint restored onto a (1, 2) and a (2, 2) mesh:
    each rank's pieces are its ``local_slice`` of the full leaves (the
    model axis splits some); saved back from the mesh it restores in one
    process equal bit for bit."""
    _, port, (params, opt), tmp = runs
    mesh = AbstractMesh((world // 2, 2), ("data", "model"))
    sliced = 0
    for r in range(world):
        p_r, m_r, step = port[world][r]["restored"]
        assert step == 4
        coord = (r // 2, r % 2)
        for k, full in params.items():
            spec = port[world][r]["specs"][k]
            sliced += any(part and "model" in part for part in spec)
            want = local_slice(full, spec, mesh, coord).numpy()
            assert np.array_equal(p_r[k], want), k
            assert np.array_equal(m_r[k], local_slice(opt["m"][k], spec, mesh, coord).numpy()), k
    assert sliced > 0
    like = ({k: torch.zeros(v.shape) for k, v in params.items()},
            adamw_init({k: torch.zeros(v.shape) for k, v in params.items()}))
    back = CheckpointManager(f"{tmp / 'one'}-back{world}", async_save=False)
    p2, o2 = back.restore(back.latest_step(), like)
    for k in params:
        assert torch.equal(p2[k], params[k]), k
        assert torch.equal(o2["m"][k], opt["m"][k]), k
    assert int(o2["step"]) == 4


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_build_cell_over_rank_mesh_runs_every_reduced_arch(runs, world):
    """``build_cell(arch, shape, mesh=make_host_mesh(D, 2), cfgset=reduced)``
    returns train, prefill and decode cells that run one step on every
    rank: a finite loss, the rank's piece of finite logits; and gemma2-9b's
    long_500k decode cell, its cache slots split over every rank, equals
    one process's decode."""
    _, port, _, _ = runs
    from repro_torch.configs import LM_ARCHS
    for r in range(world):
        cells = port[world][r]["cells"]
        assert set(cells) == set(LM_ARCHS)
        for arch, got in cells.items():
            assert np.isfinite(got["train"]), (r, arch)
            rows = 8 // (world // 2)
            vocab = reduced_config(arch).vocab_padded // 2
            assert got["prefill"] == ((rows, vocab), True), (r, arch, got["prefill"])
            assert got["decode"] == ((rows, vocab), True), (r, arch, got["decode"])
        # long_500k's rules split the slots over 'model' and 'data' at once:
        # 16 slots of the global layers' cache in 2 x (world / 2) blocks;
        # 12 steps, wrapping the windowed rings, against one process
        long = cells["gemma2-9b"]
        assert long["long_blocks"] == 16 // world, long
        assert long["long_500k"] < 1e-5, long

