"""Shared harness of the LM parity tests (``tests/test_torch_lm.py``,
``test_torch_lm_families.py``, ``test_torch_train.py`` and
``test_torch_train_families.py``): one reduced architecture through the
reference's ``LM`` under ``jax.jit`` and through the port's, from the same
parameters (``interop.lm_from_arrays``) on the same seeded numpy inputs.

Tolerance: rtol = atol = 1e-4 on float32 logits and cache leaves; on the
training path rtol = atol = 1e-5 on the loss and its metrics, and every
gradient leaf within rtol 1e-4, atol 1e-4 x that reference leaf's max |g|.  int8 KV
codes are compared exactly except for near-ties, which are counted: a code
may differ by one where ``x / scale`` lies within float32 rounding of a
half, and at most ``INT8_NEAR_TIES`` of each leaf's codes may do so
(``repro_torch.interop.lm_caches_close``, the rule the card checks use).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models.model import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.interop import lm_caches_close, lm_from_arrays

RTOL = ATOL = 1e-4
INT8_NEAR_TIES = 1e-3  # share of int8 codes allowed to differ by one


def assert_caches_close(ref, got, what: str) -> int:
    """Every leaf of ``got`` against ``ref``; returns the int8 near-ties."""
    return lm_caches_close(ref, got, rtol=RTOL, atol=ATOL, near_ties=INT8_NEAR_TIES,
                           what=what)[1]


def lm_inputs(cfg, *, b: int, s: int, seed: int = 0, tokens=None) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            if tokens is None else np.asarray(tokens, np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (b, cfg.vision_seq, cfg.vision_dim)).astype(np.float32)
    return batch


def check_lm_parity(arch: str, *, b: int = 2, s: int = 64, cache_len: int = 16,
                    decode_steps: int = 12, pos0: int = 0, tokens=None, seed: int = 0):
    """Prefill logits and every cache leaf, then ``decode_steps`` decode
    steps from zeroed caches of ``cache_len`` at positions ``pos0``,
    ``pos0 + 1``, ... (logits each step, every cache leaf after the last),
    port against reference.  ``pos0`` also offsets the prefill's decoder
    positions (whisper's ``pos0``).  Returns the int8 near-ties seen."""
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    jm = j_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    model = lm_from_arrays(cfg, jax.tree.map(np.asarray, params), device="cpu")
    batch = lm_inputs(cfg, b=b, s=s, seed=seed, tokens=tokens)
    if pos0:
        batch["pos0"] = pos0

    j_logits, j_caches = jax.jit(jm.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, caches = model.prefill({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=RTOL, atol=ATOL,
                               err_msg=f"{arch} prefill logits")
    ties = assert_caches_close(j_caches, caches, f"{arch} prefill")

    j_caches, _ = jm.init_caches(b, cache_len)
    caches, _ = model.init_caches(b, cache_len)
    j_step = jax.jit(jm.decode_step)
    toks = batch["tokens"]
    for t in range(decode_steps):
        tok = toks[:, t % s:t % s + 1]
        j_lg, j_caches = j_step(params, jnp.asarray(tok), j_caches,
                                jnp.asarray(pos0 + t, jnp.int32))
        pos = pos0 + t if t % 2 else torch.tensor(pos0 + t, dtype=torch.int32)  # both forms
        lg, caches = model.decode_step(torch.as_tensor(tok), caches, pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch} decode step {t}")
    return ties + assert_caches_close(j_caches, caches, f"{arch} decode")


# ---- training: loss and gradients -------------------------------------------

LOSS_TOL = 1e-5  # rtol = atol on the float32 loss
GRAD_RTOL = 1e-4  # and atol = GRAD_RTOL x the reference leaf's max |g|


def train_inputs(cfg, *, b: int, s: int, seed: int = 0) -> dict[str, np.ndarray]:
    """``lm_inputs`` plus next-token ``labels`` drawn alike."""
    batch = lm_inputs(cfg, b=b, s=s, seed=seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def reference_model(arch: str, *, seed: int = 0, cfgset: dict | None = None):
    """(reference LM, its parameters as numpy, the port's LM holding them on
    the CPU with gradients on) at reduced config (+ ``cfgset``)."""
    import dataclasses
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    if cfgset:
        jcfg, cfg = dataclasses.replace(jcfg, **cfgset), dataclasses.replace(cfg, **cfgset)
    jm = j_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    return jm, params, lm_from_arrays(cfg, params, device="cpu").requires_grad_(True)


def port_grads(model, batch) -> tuple[float, dict, dict]:
    """(loss, metrics, {name: gradient}) of the port's ``loss_fn``."""
    loss, mets = model.loss_fn({k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    names, plist = zip(*model.named_parameters())
    gs = torch.autograd.grad(loss, plist, allow_unused=True)
    return float(loss.detach()), {k: float(v.detach()) for k, v in mets.items()}, {
        n: (torch.zeros_like(p) if g is None else g).numpy()
        for n, p, g in zip(names, plist, gs)}


def assert_grads_close(ref_grads, grads: dict, what: str) -> None:
    """Every port gradient against the reference tree's leaf (its layer
    slice for stacked leaves): rtol GRAD_RTOL, atol GRAD_RTOL x that
    reference leaf's max |g|."""
    from repro_torch.interop import lm_param_map
    seen = set()
    for name, leaf, layer in lm_param_map(ref_grads):
        leaf = np.asarray(leaf, np.float32)
        ref = leaf if layer is None else leaf[layer]
        assert np.isfinite(grads[name]).all(), f"{what} {name}: non-finite gradient"
        np.testing.assert_allclose(
            grads[name], ref, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * float(np.abs(leaf).max()), err_msg=f"{what} grad {name}")
        seen.add(name)
    assert seen == grads.keys(), (what, sorted(grads.keys() - seen))


def check_train_parity(arch: str, *, b: int = 2, s: int = 64, seed: int = 0,
                       cfgset: dict | None = None) -> dict:
    """Loss, its metrics and every gradient leaf, port against reference
    (``jax.value_and_grad`` under ``jax.jit``) on the same parameters and
    seeded batch.  Returns the port's metrics."""
    jm, params, model = reference_model(arch, seed=seed, cfgset=cfgset)
    batch = train_inputs(model.cfg, b=b, s=s, seed=seed)
    (j_loss, j_mets), j_grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, mets, grads = port_grads(model, batch)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_TOL, atol=LOSS_TOL,
                               err_msg=f"{arch} loss")
    for k in ("nll", "aux"):
        np.testing.assert_allclose(mets[k], float(j_mets[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"{arch} {k}")
    assert_grads_close(jax.tree.map(np.asarray, j_grads), grads, arch)
    return mets
