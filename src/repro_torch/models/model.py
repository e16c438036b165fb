"""Model assembly: embeddings, layer plans, prefill and decode steps.

The port of ``repro.models.model``.  One ``LM`` covers all six families:

  dense     llama-style decoder (deepseek, codeqwen, gemma, gemma2)
  moe       mixtral / qwen2-moe (router blocks in the stack)
  ssm       mamba2 (pure SSD stack)
  hybrid    zamba2 (mamba backbone + one weight-shared attention block
            invoked every ``attn_every`` layers)
  encdec    whisper (stub frame embeddings -> encoder; decoder w/ cross)
  vlm       llama-3.2-vision (gated cross-attn blocks between groups of
            ``cross_every`` self-attn layers; stub patch embeddings)

``LM`` is an ``nn.Module`` whose parameter tree carries the reference's
names (``stacks.<pattern position>.<layer>.attn.wq``, ...); its entry
points are ``loss_fn`` (next-token cross-entropy streamed over
``loss_chunk`` + the MoE aux loss, differentiable: the training path),
``prefill`` (forward returning the per-layer KV/SSM caches),
``decode_step`` (one token against the caches), ``init_caches`` (zeroed
caches and their logical axes) and ``param_axes`` (each parameter's
logical axes, the reference's ``init`` axes tree with a stack's leading
'layers' entry dropped, as the port unrolls the stacks).  Where
``cfg.remat`` is set and gradients are on, every place the reference
wraps in ``jax.checkpoint`` (each layer of a stack, the vlm's cross
blocks, the hybrid's shared block, each loss chunk; the attention
q-chunks in ``attention``) runs under ``torch.utils.checkpoint``, so its
activations are recomputed in the backward pass.  Parameters are drawn
with ``requires_grad=False`` for serving; the training path turns
gradients on (``launch.steps.train_step``).

Under ``sharing(DataShare(...))`` the loss is one data-parallel rank's
additive share of the global batch's (``models.common.DataShare``).

Under ``distributed.sharding.use_rules`` over a live mesh with a model
axis (the step binds each rank's pieces of the parameters), the model
executes the reference's partition: the vocabulary-parallel embedding
lookup (partial sums reduce-scattered onto the residual's sequence
pieces), the residual stream split along ``act_seq`` between blocks, the
logits of the rank's vocabulary piece, the loss as a vocabulary-parallel
log-softmax (max and sum reduced over the model ranks), and the caches
that prefill returns placed as decode takes them (``init_caches``' axes).
Then ``loss_fn`` returns this rank's partial sum of the loss (terms that
every rank computes alike count on model rank 0), as the gradient
convention of ``distributed.collectives`` asks; the step sums it.

``decode_step`` updates the caches IN PLACE and returns the same tensors:
the reference returns new caches, but a copy of a full cache per token
(about 25 GB for gemma2-9b at batch 4 and 32k) would cost more than the
step.  A cache tree passed to ``decode_step`` is therefore
consumed: callers that need the old values copy them first.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache, QuantKVCache, cross_memory
from repro_torch.distributed.collectives import reduce_all
from repro_torch.distributed.sharding import cache_split, comm_over, constrain, model_dim
from repro_torch.models.common import (ArchConfig, DataShare, Initializer, embed_lookup,
                                       mark_split, remat, softcap)
from repro_torch.models.ssm import SSMCache, conv_dim

__all__ = ["LM", "build_model", "STACKED", "reference_ndims", "reference_leaves"]

# The parameter-tree keys whose segments the reference stacks along a
# leading 'layers' axis (``blocks.init_stack``); the port unrolls that axis
# into ``<key>.<segment>.<layer>``.
STACKED = ("stacks", "enc_stacks", "cross_stacks")

# The reference's learned decoder positions table (whisper) has this many
# rows at every config; positions past it clamp to the last row, as
# ``lax.dynamic_slice_in_dim`` clamps.
DEC_POS_ROWS = 32768


def _pattern(cfg: ArchConfig) -> tuple[tuple[str, int], ...]:
    """Repeating (kind, window) pattern of the layer stack."""
    if cfg.family == "moe":
        w = cfg.sliding_window if cfg.window_pattern == "all" else 0
        return (("moe", w),)
    if cfg.family == "ssm":
        return (("mamba", 0),)
    if cfg.window_pattern == "alternate":
        return (("dense", cfg.sliding_window), ("dense", 0))
    if cfg.window_pattern == "all":
        return (("dense", cfg.sliding_window),)
    return (("dense", 0),)


def _stack_kv(kvs: list[KVCache]) -> KVCache:
    return KVCache(k=torch.stack([c.k for c in kvs]), v=torch.stack([c.v for c in kvs]))


def _layer(caches, i: int):
    """Layer ``i``'s views of a stacked cache (writes go to the stack),
    each with its stack's placement (``common.mark_split``)."""
    return type(caches)(*(_row(t, i) for t in caches))


def _row(t: torch.Tensor, i: int) -> torch.Tensor:
    v = t[i]
    if hasattr(t, "_model_split"):
        mark_split(v, None if t._model_split is None else t._model_split - 1, t._split_axes)
    return v


def reference_ndims(params: dict) -> dict[str, int]:
    """The ndim of each parameter as a leaf of the reference's tree: one
    more inside the layer stacks (their leading 'layers' axis).  AdamW's
    weight-decay rule reads it (``optim.adamw.adamw_update(ndims=...)``)."""
    return {name: p.ndim + (name.split(".")[0] in STACKED) for name, p in params.items()}


def reference_leaves(names) -> dict[str, list[str]]:
    """{a leaf of the reference's tree: the port's parameter names that form
    it, in layer order}.  The layers of a stacked segment
    (``stacks.i.<layer>.<path>``) form one leaf (``stacks.i.<path>``, their
    stack along a leading 'layers' axis); every other name is a leaf of its
    own."""
    out: dict[str, list[str]] = {}
    for name in names:
        parts = name.split(".")
        key = ".".join(parts[:2] + parts[3:]) if parts[0] in STACKED else name
        out.setdefault(key, []).append(name)
    return out


class LM(nn.Module):
    """The reference's ``LM`` facade for one ``ArchConfig``, with its
    parameters drawn from ``seed`` on ``device`` (``"meta"``: shapes only)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        init = Initializer(gen, cfg.param_dtype, dev)
        self.cfg = cfg
        vp, d = cfg.vocab_padded, cfg.d_model
        self.tok_embed = init.dense((vp, d), ("vocab", "embed_fsdp"), scale=0.02)
        self.final_norm = B._init_norm(init, cfg)
        if not cfg.tie_embeddings:
            self.lm_head = init.dense((d, vp), ("embed_fsdp", "vocab"), scale=0.02)

        fam = cfg.family
        if fam in ("dense", "moe", "ssm"):
            pat = _pattern(cfg)
            groups = cfg.num_layers // len(pat)
            self.stacks = B.init_stack(init, cfg, tuple(k for k, _ in pat), groups)
        elif fam == "hybrid":
            self.stacks = B.init_stack(init, cfg, ("mamba",), cfg.num_layers)
            self.shared_attn = B.init_block(init, cfg, "dense")
        elif fam == "encdec":
            self.enc_pos = init.dense((cfg.encoder_seq, d), ("frames", "embed_fsdp"), scale=0.02)
            self.dec_pos = init.dense((DEC_POS_ROWS, d), ("seq", "embed_fsdp"), scale=0.02)
            self.enc_stacks = B.init_stack(init, cfg, ("enc",), cfg.encoder_layers)
            self.stacks = B.init_stack(init, cfg, ("dec",), cfg.num_layers)
            self.enc_norm = B._init_norm(init, cfg)
        elif fam == "vlm":
            if cfg.num_layers % cfg.cross_every:
                raise ValueError(f"{cfg.arch_id}: num_layers {cfg.num_layers} is not a "
                                 f"multiple of cross_every {cfg.cross_every}")
            n_cross = cfg.num_layers // cfg.cross_every
            self.stacks = B.init_stack(init, cfg, ("dense",), cfg.num_layers)
            self.cross_stacks = B.init_stack(init, cfg, ("cross",), n_cross)
        else:
            raise ValueError(fam)
        self._param_axes = {n: p.logical_axes for n, p in self.named_parameters()}
        self._param_shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        self.data_share: DataShare | None = None

    def param_axes(self) -> dict[str, tuple]:
        """{parameter name: the reference's logical axes of that leaf}; a
        leaf unrolled out of a layer stack drops the stack's leading
        'layers' entry."""
        return dict(self._param_axes)

    @contextlib.contextmanager
    def sharing(self, share: DataShare | None):
        """Inside the block, ``loss_fn``'s batch is one data-parallel rank's
        share (None: the whole batch).  The setting is the model's, not the
        thread's, so a recomputation in the backward pass sees it too."""
        prev, self.data_share = self.data_share, share
        try:
            yield
        finally:
            self.data_share = prev

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    # ---- shared helpers ----------------------------------------------------

    def _split(self, name: str) -> int | None:
        """The dimension of a top-level parameter that this rank holds a
        piece of, under the rules in force."""
        return model_dim(self._param_axes[name], self._param_shapes[name])

    def _act(self, tokens: torch.Tensor) -> int | None:
        """The residual stream's dimension split over the model axis
        (``act_seq``) for a (B, S) ``tokens`` batch, or None."""
        b, s = tokens.shape[:2]
        return model_dim(("batch", "act_seq", "embed"), (b, s, self.cfg.d_model))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        split = self._split("tok_embed")
        h = embed_lookup(self.tok_embed, tokens, split)
        if cfg.embed_scale:
            # the constant rounds to the parameter dtype first, as the
            # reference's jnp.asarray(sqrt(d), h.dtype) does (bf16: 60.0)
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
        # the residual stream is sequence-split (Megatron SP); decode's one
        # position keeps it whole (the divisibility rule)
        return constrain(h, "batch", "act_seq", "embed", partial=split is not None)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """(B, S, D) whole -> float32 logits of this rank's vocabulary piece
        (all of it without a model axis), padded entries at -1e30."""
        cfg = self.cfg
        w = self.tok_embed.T if cfg.tie_embeddings else self.lm_head
        logits = softcap((h @ w.to(h.dtype)).float(), cfg.final_softcap)
        v = logits.shape[-1]
        lo = 0 if v == cfg.vocab_padded else comm_over().index * v
        vmask = torch.arange(lo, lo + v, device=h.device) < cfg.vocab_size
        return torch.where(vmask, logits, -1e30)

    def _own(self) -> float:
        """1.0 where this rank counts the terms every model rank computes
        alike (model rank 0; every rank without a model axis), else 0.0."""
        comm = comm_over()
        return 1.0 if comm is None or comm.index == 0 else 0.0

    def _run_stack(self, stack, x, kind: str, window: int, *, collect: bool,
                   memory: KVCache | None = None, act: int | None = None):
        """Run a stack's layers in order.  ``memory`` (if given) is a stacked
        per-layer KVCache; ``act``: the residual's split dimension.  Returns
        (x, stacked caches | None, aux)."""
        cfg = self.cfg
        n = len(stack)
        caches = None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(stack):
            mem = None if memory is None else _layer(memory, i)
            if collect:
                x, cache, a = B.block_train(layer, x, cfg, kind, window=window,
                                            memory=mem, collect_cache=True, act=act)
            else:  # the reference's scanned body, rematerialised
                x, a = remat(cfg, self._layer_body, layer, x, kind, window, mem, act)
            aux = aux + a
            if collect:
                if caches is None:  # one stacked buffer per leaf, written layer by layer
                    caches = type(cache)(*(torch.empty((n, *t.shape), dtype=t.dtype,
                                                       device=t.device) for t in cache))
                for dst, src in zip(caches, cache):
                    dst[i] = src
        return x, caches, aux

    def _layer_body(self, layer, x, kind: str, window: int, mem, act):
        x, _, a = B.block_train(layer, x, self.cfg, kind, window=window, memory=mem,
                                share=self.data_share, act=act)
        return x, a

    def _run_stack_decode(self, stack, x, caches, pos, kind: str, window: int, *,
                          first: int = 0, memory: KVCache | None = None):
        """Decode through a stack's layers; layer i uses slot ``first + i`` of
        the stacked ``caches`` (updated in place)."""
        for i, layer in enumerate(stack):
            mem = None if memory is None else _layer(memory, i)
            x, _ = B.block_decode(layer, x, _layer(caches, first + i), pos, self.cfg, kind,
                                  window=window, memory=mem)
        return x

    # ---- forward (prefill) -------------------------------------------------

    def _backbone(self, batch, *, collect: bool):
        """Token embeddings -> final hidden states (this rank's piece of the
        residual, placed by ``_act``) (+caches if collect)."""
        cfg = self.cfg
        fam = cfg.family
        x = self._embed(batch["tokens"])
        act = self._act(batch["tokens"])
        caches: dict[str, Any] = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        if fam in ("dense", "moe", "ssm"):
            for i, ((kind, window), stack) in enumerate(zip(_pattern(cfg), self.stacks)):
                x, c, a = self._run_stack(stack, x, kind, window, collect=collect, act=act)
                aux = aux + a
                if collect:
                    caches[f"kv{i}"] = c
        elif fam == "hybrid":
            x, caches, aux = self._hybrid_fwd(x, collect, act)
        elif fam == "encdec":
            frames = batch["frames"].to(x.dtype)
            e = frames + self.enc_pos[None, :frames.shape[1]].to(x.dtype)
            e_act = model_dim(("batch", "act_seq", "embed"), tuple(e.shape))
            e = constrain(e, "batch", "act_seq", "embed")
            e, _, _ = self._run_stack(self.enc_stacks[0], e, "enc", 0, collect=False,
                                      act=e_act)
            e = constrain(B._norm(self.enc_norm, e, cfg), "batch", "frames", "embed",
                          src=e_act)
            mem = _stack_kv([cross_memory(lp["cross"], e, cfg) for lp in self.stacks[0]])
            s = batch["tokens"].shape[1]
            start = min(max(int(batch.get("pos0", 0)), 0), DEC_POS_ROWS - s)
            x = x + constrain(self.dec_pos[start:start + s][None].to(x.dtype),
                              "batch", "act_seq", "embed")
            x, c, _ = self._run_stack(self.stacks[0], x, "dec", 0, collect=collect,
                                      memory=mem, act=act)
            if collect:
                caches["kv0"] = c
                caches["cross_mem"] = mem
        elif fam == "vlm":
            vis = batch["vision"].to(x.dtype)
            mem = _stack_kv([cross_memory(cp["cross"], vis, cfg)
                             for cp in self.cross_stacks[0]])
            every = cfg.cross_every
            for g, cp in enumerate(self.cross_stacks[0]):
                x = remat(cfg, self._cross_body, cp, x, _layer(mem, g), act)
                x, c, _ = self._run_stack(self.stacks[0][g * every:(g + 1) * every], x,
                                          "dense", 0, collect=collect, act=act)
                if collect:
                    caches[f"kv{g}"] = c
            if collect:
                caches["cross_mem"] = mem
        else:
            raise ValueError(fam)

        return B._norm(self.final_norm, x, cfg), caches, aux

    def _cross_body(self, cp, x, mem, act):
        return B.block_train(cp, x, self.cfg, "cross", memory=mem, act=act)[0]

    def _shared_body(self, x, act):
        return B.block_train(self.shared_attn, x, self.cfg, "dense", act=act)[0]

    def _hybrid_fwd(self, x, collect: bool, act: int | None):
        """zamba2: mamba backbone + shared attn every ``attn_every`` layers."""
        cfg = self.cfg
        every = cfg.attn_every
        n_shared = cfg.num_layers // every
        stack = self.stacks[0]
        ssm_parts, shared_parts = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(n_shared):
            x, c, _ = self._run_stack(stack[g * every:(g + 1) * every], x, "mamba", 0,
                                      collect=collect, act=act)
            ssm_parts.append(c)
            if collect:
                x, kv, _ = B.block_train(self.shared_attn, x, cfg, "dense",
                                         collect_cache=True, act=act)
                shared_parts.append(kv)
            else:  # the shared block sits outside the stack: its own remat
                x = remat(cfg, self._shared_body, x, act)
        if cfg.num_layers > n_shared * every:
            x, c, _ = self._run_stack(stack[n_shared * every:], x, "mamba", 0,
                                      collect=collect, act=act)
            ssm_parts.append(c)
        if not collect:
            return x, {}, aux
        # group caches back into one (L, ...) stack, as the reference does
        caches = {"ssm": SSMCache(*(torch.cat(ts) for ts in zip(*ssm_parts))),
                  "shared_kv": _stack_kv(shared_parts)}
        return x, caches, aux

    # ---- public entry points ----------------------------------------------

    def _chunk_nll(self, hc: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
        """Summed next-token NLL of one (B, c) chunk, in float32: over a
        split vocabulary, this rank's partial sum of it (its vocabulary
        piece's target logits; the log-sum-exp, whose max and sum are
        reduced over the model ranks, counted on model rank 0)."""
        logits = self._logits(hc)
        if logits.shape[-1] == self.cfg.vocab_padded:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, lb[..., None].long())[..., 0]
            nll = torch.sum(lse - tgt)
            return nll if comm_over() is None else nll * self._own()
        comm = comm_over()
        m = comm.maximum(torch.amax(logits, dim=-1, keepdim=True))
        lse = m[..., 0] + torch.log(reduce_all(torch.sum(torch.exp(logits - m), dim=-1), comm))
        local = lb.long() - comm.index * logits.shape[-1]
        inside = (local >= 0) & (local < logits.shape[-1])
        tgt = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
        return torch.sum(lse * self._own() - torch.where(inside, tgt, 0.0))

    def loss_fn(self, batch: dict[str, torch.Tensor]):
        """batch: ``tokens`` and ``labels`` (B, S) int (+ ``frames`` /
        ``vision``) -> (loss, {"nll", "aux"}): the mean next-token
        cross-entropy, streamed over ``loss_chunk`` positions at a time so
        that the (B, S, vocab) logits never exist at once, plus 0.01 x the
        MoE load-balance loss.  Differentiable with respect to the
        parameters (turn their ``requires_grad`` on).  Under a
        :class:`DataShare` of n ranks, the NLL's divisor is the global
        token count (n x this batch's) and ``aux`` is divided by n: the
        ranks' losses and metrics sum to the global batch's."""
        cfg = self.cfg
        h, _, aux = self._backbone(batch, collect=False)
        h = constrain(h, "batch", "seq", "embed", src=self._act(batch["tokens"]))
        labels = batch["labels"]
        s = h.shape[1]
        lc = min(cfg.loss_chunk, s)
        nch = s // lc if s % lc == 0 else 1
        c = s // nch
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(nch):
            total = total + remat(cfg, self._chunk_nll, h[:, i * c:(i + 1) * c],
                                  labels[:, i * c:(i + 1) * c])
        n = 1 if self.data_share is None else self.data_share.size
        nll = total / (labels.numel() * n)
        aux = aux / n if comm_over() is None else aux / n * self._own()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def bind_params(self, params: dict[str, torch.Tensor]) -> None:
        """Make the model compute with ``params`` (its parameter names ->
        tensors, e.g. a restored checkpoint's): each parameter that is not
        already that tensor's storage becomes a parameter aliasing it, so
        in-place updates through either are seen by both."""
        own = dict(self.named_parameters())
        for name, t in params.items():
            p = own[name]
            if p.data_ptr() == t.data_ptr() and p.shape == t.shape and p.dtype == t.dtype:
                continue
            if p.shape != t.shape or p.dtype != t.dtype or p.device != t.device:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} does "
                                 f"not fit {tuple(p.shape)} {p.dtype} on {p.device}")
            mod, _, leaf = name.rpartition(".")
            self.get_submodule(mod)._parameters[leaf] = nn.Parameter(
                t.detach(), requires_grad=p.requires_grad)

    @torch.no_grad()
    def prefill(self, batch: dict[str, torch.Tensor]):
        """batch: ``tokens`` (B, S) int (+ ``frames`` / ``vision``) ->
        (last-position logits (B, vocab_padded) float32, caches); over a
        model axis, this rank's vocabulary piece of the logits and its
        pieces of the caches."""
        h, caches, _ = self._backbone(batch, collect=True)
        act = self._act(batch["tokens"])
        last = h[:, -1:, :]
        if act is not None:  # the last position is the last rank's
            last = constrain(last, "batch", "seq", "embed", src=act)[:, -1:]
        return self._logits(last)[:, 0], self._place_caches(caches)

    def _place_caches(self, caches: dict) -> dict:
        """Prefill's caches (every position; a rank's K/V and SSM heads where
        they split) placed as decode takes them: ``init_caches``' axes."""
        if comm_over() is None:
            return caches
        cfg = self.cfg
        axes = self._cache_plan(1, 1)[1]
        out = {}
        for key, c in caches.items():
            placed = []
            for name, t, ax in zip(c._fields, c, axes[key]):
                heads = {"k": (3, cfg.n_kv_heads), "v": (3, cfg.n_kv_heads),
                         "state": (2, cfg.ssm_heads)}.get(name)
                src = heads[0] if heads and t.shape[heads[0]] != heads[1] else None
                whole = list(t.shape)
                if src is not None:
                    whole[src] *= comm_over().size
                placed.append(mark_split(constrain(t, *ax, src=src), model_dim(ax, whole)))
            out[key] = type(c)(*placed)
        return out

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: dict, pos):
        """token: (B, 1) int; pos: the current length (a Python int or a 0-d
        integer tensor).  Returns (logits, caches), the caches updated in
        place (the same tensors as given); over a model axis the caches are
        this rank's pieces (from ``init_caches`` or ``prefill`` under the
        same rules) and the logits its vocabulary piece."""
        cfg = self.cfg
        fam = cfg.family
        pos = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        x = self._embed(token)  # one position: whole on every rank

        if fam in ("dense", "moe", "ssm"):
            for i, ((kind, window), stack) in enumerate(zip(_pattern(cfg), self.stacks)):
                x = self._run_stack_decode(stack, x, caches[f"kv{i}"], pos, kind, window)
        elif fam == "hybrid":
            every = cfg.attn_every
            n_shared = cfg.num_layers // every
            stack = self.stacks[0]
            for g in range(n_shared):
                x = self._run_stack_decode(stack[g * every:(g + 1) * every], x,
                                           caches["ssm"], pos, "mamba", 0, first=g * every)
                x, _ = B.block_decode(self.shared_attn, x, _layer(caches["shared_kv"], g),
                                      pos, cfg, "dense")
            if cfg.num_layers > n_shared * every:
                x = self._run_stack_decode(stack[n_shared * every:], x, caches["ssm"], pos,
                                           "mamba", 0, first=n_shared * every)
        elif fam == "encdec":
            row = torch.clamp(pos, 0, DEC_POS_ROWS - 1).reshape(1)
            x = x + self.dec_pos.index_select(0, row)[None].to(x.dtype)
            x = self._run_stack_decode(self.stacks[0], x, caches["kv0"], pos, "dec", 0,
                                       memory=caches["cross_mem"])
        elif fam == "vlm":
            mem = caches["cross_mem"]
            every = cfg.cross_every
            for g, cp in enumerate(self.cross_stacks[0]):
                x, _, _ = B.block_train(cp, x, cfg, "cross", memory=_layer(mem, g))
                x = self._run_stack_decode(self.stacks[0][g * every:(g + 1) * every], x,
                                           caches[f"kv{g}"], pos, "dense", 0)
        else:
            raise ValueError(fam)

        x = B._norm(self.final_norm, x, cfg)
        return self._logits(x)[:, 0], caches

    # ---- cache construction -------------------------------------------------

    def _kv_shape(self, b: int, s: int) -> tuple[int, ...]:
        cfg = self.cfg
        return (b, s, cfg.n_kv_heads, cfg.hdim)

    def _cache_len(self, window: int, cache_len: int) -> int:
        return min(window, cache_len) if window > 0 else cache_len

    def _cache_plan(self, b: int, cache_len: int) -> tuple[dict, dict]:
        """({key: cache of (shape, dtype) pairs}, {key: cache of logical
        axes}): the whole caches of ``init_caches``."""
        cfg = self.cfg
        dt = cfg.param_dtype
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        mem_axes = KVCache(k=("layers", "batch", "frames", "kv_heads", "head_dim"),
                           v=("layers", "batch", "frames", "kv_heads", "head_dim"))

        def kv(n, s):
            shape = (n, *self._kv_shape(b, s))
            if cfg.kv_cache_dtype == "int8":
                sc = (n, b, s, cfg.n_kv_heads)
                sc_axes = ("layers", "batch", "kv_seq", "kv_heads")
                return (QuantKVCache(k=(shape, torch.int8), v=(shape, torch.int8),
                                     k_scale=(sc, torch.float32), v_scale=(sc, torch.float32)),
                        QuantKVCache(k=kv_axes, v=kv_axes, k_scale=sc_axes, v_scale=sc_axes))
            return KVCache(k=(shape, dt), v=(shape, dt)), KVCache(kv_axes, kv_axes)

        fam = cfg.family
        plan: dict[str, Any] = {}
        axes: dict[str, Any] = {}
        if fam in ("dense", "moe"):
            pat = _pattern(cfg)
            groups = cfg.num_layers // len(pat)
            for i, (_, window) in enumerate(pat):
                plan[f"kv{i}"], axes[f"kv{i}"] = kv(groups, self._cache_len(window, cache_len))
        elif fam == "ssm":
            plan["kv0"], axes["kv0"] = self._ssm_cache(cfg.num_layers, b)
        elif fam == "hybrid":
            plan["ssm"], axes["ssm"] = self._ssm_cache(cfg.num_layers, b)
            plan["shared_kv"], axes["shared_kv"] = kv(cfg.num_layers // cfg.attn_every,
                                                      cache_len)
        elif fam == "encdec":
            plan["kv0"], axes["kv0"] = kv(cfg.num_layers, cache_len)
            m = (cfg.num_layers, *self._kv_shape(b, cfg.encoder_seq))
            plan["cross_mem"], axes["cross_mem"] = KVCache(k=(m, dt), v=(m, dt)), mem_axes
        elif fam == "vlm":
            n_cross = cfg.num_layers // cfg.cross_every
            for g in range(n_cross):
                plan[f"kv{g}"], axes[f"kv{g}"] = kv(cfg.cross_every, cache_len)
            m = (n_cross, *self._kv_shape(b, cfg.vision_seq))
            plan["cross_mem"], axes["cross_mem"] = KVCache(k=(m, dt), v=(m, dt)), mem_axes
        else:
            raise ValueError(fam)
        return plan, axes

    def init_caches(self, b: int, cache_len: int) -> tuple[dict, dict]:
        """(zeroed caches on the model's device, their logical axes): the
        reference's two parallel trees.  Every cache leaf is its own tensor,
        since decode writes into them.  Over a model axis each leaf is this
        rank's piece (``b`` is the rank's rows), marked with its split
        (``common.mark_split``)."""
        plan, axes = self._cache_plan(b, cache_len)
        caches = {}
        for key, c in plan.items():
            leaves = []
            for (shape, dtype), ax in zip(c, axes[key]):
                dim, names = cache_split(ax, shape)
                if dim is not None:
                    n = comm_over(names).size
                    shape = tuple(d // n if i == dim else d for i, d in enumerate(shape))
                t = torch.zeros(shape, dtype=dtype, device=self.device)
                leaves.append(t if comm_over() is None else mark_split(t, dim, names))
            caches[key] = type(c)(*leaves)
        return caches, axes

    def _ssm_cache(self, n: int, b: int) -> tuple[SSMCache, SSMCache]:
        cfg = self.cfg
        return (SSMCache(
            state=((n, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
            conv=((n, b, cfg.ssm_conv - 1, conv_dim(cfg)), cfg.param_dtype)),
            SSMCache(state=("layers", "batch", "ssm_heads", None, "ssm_state"),
                     conv=("layers", "batch", None, "inner")))


def build_model(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> LM:
    """The ``LM`` of ``cfg`` with parameters drawn from ``seed`` on
    ``device`` (default the card; ``"meta"`` builds shapes only)."""
    return LM(cfg, seed=seed, device=device)
