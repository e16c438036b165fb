"""The port's LM serving path against the reference (``repro.models``,
``repro.configs``, ``repro.launch.specs`` / ``steps``): the configs field
by field; for every architecture at FULL config the parameter tree, the
caches and the cell inputs on ``device="meta"`` against ``jax.eval_shape``
(nothing allocated); and the dense and MoE families at reduced config,
prefill and decode, through ``interop.lm_from_arrays`` on the reference's
parameters (tolerance and int8 near-tie rule in ``tests/_torch_lm.py``).
The other four families are in ``tests/test_torch_lm_families.py``."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import check_lm_parity  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.launch.steps import _cache_shapes_of  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import lm_param_map  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402


def test_registry_matches_reference():
    assert configs.LM_ARCHS == j_configs.LM_ARCHS
    assert configs.list_archs() == j_configs.list_archs()
    assert "dade-ivf" in configs.list_archs()


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# The port's flat route serves int8 codes by default (the fused route's
# stage 1); the reference's service config leaves ``quant`` to the caller.
_PORT_DEFAULTS = {"dade-ivf": {"quant": ("none", "int8")}}
# Fields of the port's ``ArchConfig`` that the reference's lacks, with each
# arch's value by the rule the reference applies inline instead
# (``repro.models.blocks``: qwen2moe's top-k gates are not renormalised).
_PORT_ONLY = {"moe_renorm": lambda arch: arch != "qwen2-moe-a2.7b"}


@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_config_fields_match_reference(arch):
    for get in ("get_config", "reduced_config"):
        ref, got = _fields(getattr(j_configs, get)(arch)), _fields(getattr(configs, get)(arch))
        if arch != "dade-ivf":
            for name, rule in _PORT_ONLY.items():
                assert got.pop(name) == rule(arch), (arch, get, name)
        assert ref.keys() == got.keys(), (arch, get)
        for name, (r_val, p_val) in _PORT_DEFAULTS.get(arch, {}).items():
            assert (ref.pop(name), got.pop(name)) == (r_val, p_val), (arch, name)
        assert got == ref, (arch, get)
    if arch != "dade-ivf":
        cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
        assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"
        assert (cfg.hdim, cfg.qkv_dim, cfg.kv_dim, cfg.vocab_padded, cfg.d_inner,
                cfg.ssm_heads, cfg.layer_windows()) == (
            jcfg.hdim, jcfg.qkv_dim, jcfg.kv_dim, jcfg.vocab_padded, jcfg.d_inner,
            jcfg.ssm_heads, jcfg.layer_windows())


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _tree_specs(tree) -> list:
    """(path, shape, dtype) of every leaf of a cache tree or batch dict."""
    out = []
    for key, leaf in tree.items():
        parts = zip(leaf._fields, leaf) if hasattr(leaf, "_fields") else [("", leaf)]
        out += [(f"{key}.{f}", tuple(t.shape), _dtype(t)) for f, t in parts]
    return sorted(out)


@pytest.mark.parametrize("arch", j_configs.LM_ARCHS)
def test_full_config_meta_trees_match_reference(arch):
    """At FULL config: the port's parameter tree on ``meta`` equals the
    reference's ``jax.eval_shape(LM.init)`` name for name, shape for shape,
    dtype for dtype; so do the decode caches and every cell's inputs."""
    cfg, jm = configs.get_config(arch), j_build_model(j_configs.get_config(arch))
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    cell = build_cell(arch, "decode_32k", device="meta")
    model = cell.model
    assert all(p.is_meta for p in model.parameters())
    want = {n: (tuple(p.shape), _dtype(p)) for n, p in model.named_parameters()}
    got = {n: (tuple(leaf.shape[1:] if layer is not None else leaf.shape), str(leaf.dtype))
           for n, leaf, layer in lm_param_map(shapes)}
    assert want == got

    spec = specs.SHAPES["decode_32k"]
    j_caches, _ = _cache_shapes_of(jm, spec.global_batch, spec.seq)
    token, caches, pos = cell.args
    assert all(t.is_meta for c in caches.values() for t in c)
    assert _tree_specs(caches) == _tree_specs(j_caches)
    assert (tuple(token.shape), _dtype(token), tuple(pos.shape)) == (
        (spec.global_batch, 1), "int32", ())

    for shape in specs.SHAPES:
        j_spec, j_batch, _ = j_specs.input_specs(j_configs.get_config(arch), shape)
        p_spec, batch, baxes = specs.input_specs(cfg, shape)
        assert dataclasses.asdict(p_spec) == dataclasses.asdict(j_spec)
        assert baxes == j_specs.input_specs(j_configs.get_config(arch), shape)[2]
        assert _tree_specs(batch) == _tree_specs(j_batch)
    (batch,) = build_cell(arch, "prefill_32k", device="meta").args
    assert _tree_specs(batch) == _tree_specs(j_specs.input_specs(
        j_configs.get_config(arch), "prefill_32k")[1])


@pytest.mark.parametrize("arch", j_configs.LM_ARCHS)
def test_train_cell_is_refused_by_name(arch, tmp_path):
    """The train cell is built for every architecture at full config (on
    ``meta``): the train step with the model bound, parameter and float32
    moment specs of the model's shapes, the train_4k batch.  Nothing of the
    multi-device half is refused any more: a restored leaf is placed on a
    data mesh as its rank's piece."""
    cell = build_cell(arch, "train_4k", device="meta")
    params, opt_state, batch = cell.args
    own = dict(cell.model.named_parameters())
    assert cell.kind == "train" and callable(cell.step_fn)
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in own.items()}
    assert all(opt_state[m][k].shape == v.shape and opt_state[m][k].dtype == torch.float32
               for m in ("m", "v") for k, v in own.items())
    assert batch["labels"].shape == batch["tokens"].shape == (256, 4096)
    assert all(p.requires_grad for p in own.values())
    from _torch_dist import rank_view
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import tree_shardings
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"a": torch.arange(4.0)})
    sh = tree_shardings({"a": ("batch",)}, {"a": (4,)}, rank_view((2, 1), ("data", "model"),
                                                                 (1, 0)))
    assert torch.equal(mgr.restore(0, {"a": torch.zeros(2)}, shardings=sh)["a"],
                       torch.tensor([2.0, 3.0]))


@pytest.mark.parametrize("shape", list(j_specs.SHAPES))
@pytest.mark.parametrize("arch", j_configs.LM_ARCHS)
def test_cell_is_runnable_matches_reference(arch, shape):
    assert specs.cell_is_runnable(configs.get_config(arch), shape) == \
        j_specs.cell_is_runnable(j_configs.get_config(arch), shape)
    assert specs.LONG_OK == j_specs.LONG_OK


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma-2b", "gemma2-9b",
                                  "mixtral-8x7b"])
def test_dense_and_moe_prefill_decode_match_reference(arch):
    """Prefill over 64 tokens (two 32-row query chunks: deepseek's heads
    padded from 8 to 64 run the chunk loop), then 12 decode steps into
    16-slot caches: gemma2's and mixtral's 8-token windows wrap the ring.
    gemma2's 4 layers run as the reference runs them, both windowed layers
    (its first stack) before both global ones: an interleaved port fails
    here."""
    assert check_lm_parity(arch) == 0


def test_int8_kv_cache_matches_reference():
    """codeqwen's int8 KV cache: codes equal but for counted near-ties,
    scales and logits within tolerance."""
    check_lm_parity("codeqwen1.5-7b")


def test_moe_capacity_overflow_matches_reference():
    """qwen2-moe with one row of identical tokens: every token picks the
    same 4 experts, so 64 pairs go to each against a capacity of 40 and 24
    are dropped; the other row routes freely."""
    cfg = configs.reduced_config("qwen2-moe-a2.7b")
    assert _capacity(cfg, 64) == 40
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    toks[0] = 7
    assert check_lm_parity("qwen2-moe-a2.7b", tokens=toks) == 0


@pytest.mark.parametrize("name", ["_sdpa", "_flat_sdpa"])
def test_bf16_attention_keeps_float32_scores(name):
    """bf16 q, k and v whose scores spread over about +-60 under gemma2's
    softcap of 50: the reference takes QK^T and PV with float32 output.
    Scores rounded to bf16 first (steps of 0.125-0.25 at that size) move
    the probabilities by up to a quarter and fail here; the outputs agree
    to about one bf16 step (rtol = atol = 1e-2)."""
    rng = np.random.default_rng(5)
    grouped = name == "_sdpa"
    b, sq, skv, h, dh = 2, 8, 32, 4, 64
    q = rng.standard_normal((b, sq, h, dh)) * 5.5
    k = rng.standard_normal((b, skv, 2 if grouped else h, dh)) * 5.5
    v = rng.standard_normal(k.shape)
    if grouped:
        q = q.reshape(b, sq, 2, h // 2, dh)
    mask = np.tril(np.ones((sq, skv), bool), k=skv - sq)
    ref = getattr(j_attention, name)(*(jax.numpy.asarray(x, jax.numpy.bfloat16)
                                        for x in (q, k, v)), jax.numpy.asarray(mask), 50.0)
    got = getattr(attention, name)(*(torch.tensor(x, dtype=torch.bfloat16)
                                     for x in (q, k, v)), torch.tensor(mask), 50.0)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
