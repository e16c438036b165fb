"""Carry state built by the reference package into the port.

Every function takes the reference's state as numpy arrays (callers apply
``np.asarray`` to the reference's objects) and returns the port's objects
on the requested device, so search parity can run on reference-built
artifacts: the reference's builds draw from random streams the port cannot
replay.  Nothing here imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.calibration import EpsilonTable
from repro_torch.core.estimators import Estimator
from repro_torch.core.transforms import OrthogonalTransform
from repro_torch.index.flat import FlatIndex
from repro_torch.index.graph import GraphIndex
from repro_torch.index.ivf import IVFIndex
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import LM, STACKED
from repro_torch.quant.scalar import QuantConfig

__all__ = ["transform_from_arrays", "table_from_arrays", "estimator_from_arrays",
           "flat_from_arrays", "ivf_from_arrays", "graph_from_arrays", "lm_param_map",
           "lm_from_arrays", "adamw_state_from_arrays", "local_state_from_arrays",
           "lm_caches_close"]


def _t(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def transform_from_arrays(basis, variances, cum_variances, *,
                          device="cuda") -> OrthogonalTransform:
    dev = resolve_device(device)
    return OrthogonalTransform(basis=_t(basis, dev, torch.float32),
                               variances=_t(variances, dev, torch.float32),
                               cum_variances=_t(cum_variances, dev, torch.float32))


def table_from_arrays(dims, eps, scale, eps_lo, *, device="cuda") -> EpsilonTable:
    dev = resolve_device(device)
    return EpsilonTable(dims=_t(dims, dev, torch.int32), eps=_t(eps, dev, torch.float32),
                        scale=_t(scale, dev, torch.float32),
                        eps_lo=_t(eps_lo, dev, torch.float32))


def estimator_from_arrays(method: str, transform: dict, table: dict, *,
                          quant: bool = False, device="cuda") -> Estimator:
    """``transform``: basis/variances/cum_variances arrays; ``table``:
    dims/eps/scale/eps_lo arrays."""
    return Estimator(method=method,
                     transform=transform_from_arrays(**transform, device=device),
                     table=table_from_arrays(**table, device=device),
                     quant=QuantConfig() if quant else None)


def flat_from_arrays(estimator: Estimator, corpus_rot, corpus, corpus_q=None,
                     qscales=None, device="cuda") -> FlatIndex:
    """The reference's ``FlatIndex`` arrays (the int8 mirror optional) as
    the port's index."""
    dev = resolve_device(device)
    return FlatIndex(
        estimator=estimator, corpus_rot=_t(corpus_rot, dev, torch.float32),
        corpus=_t(corpus, dev, torch.float32),
        corpus_q=None if corpus_q is None else _t(corpus_q, dev, torch.int8),
        qscales=None if qscales is None else _t(qscales, dev, torch.float32))


def ivf_from_arrays(estimator: Estimator, *, centroids, bucket_sizes, starts,
                    flat_rot, flat_codes, flat_ids, bscales, qbuckets, qscales,
                    max_bucket: int, scan_block_d: int, device="cuda") -> IVFIndex:
    """The reference's fused-layout ``IVFIndex`` arrays as the port's index.

    ``qbuckets`` (Nc, cap, D) — the reference's per-dimension codes in its
    padded bucket layout — are laid into the flat layout (row
    ``starts[c] + j`` holds bucket c's j-th code row), where the port's
    threshold seed reads them.
    """
    dev = resolve_device(device)
    sizes = np.asarray(bucket_sizes, np.int64)
    st = np.asarray(starts, np.int64)
    qb = np.asarray(qbuckets)
    seed_codes = np.zeros((np.asarray(flat_rot).shape[0], qb.shape[2]), np.int8)
    for c, size in enumerate(sizes):
        seed_codes[st[c]: st[c] + size] = qb[c, :size]
    return IVFIndex(
        estimator=estimator, centroids=_t(centroids, dev, torch.float32),
        bucket_sizes=_t(sizes, dev, torch.int32), starts=_t(st, dev, torch.int32),
        flat_rot=_t(flat_rot, dev, torch.float32),
        flat_codes=_t(flat_codes, dev, torch.int8),
        flat_ids=_t(flat_ids, dev, torch.int32), bscales=_t(bscales, dev, torch.float32),
        seed_codes=_t(seed_codes, dev, torch.int8),
        qscales=_t(qscales, dev, torch.float32),
        max_bucket=int(max_bucket), scan_block_d=int(scan_block_d))


def graph_from_arrays(estimator: Estimator, *, corpus_rot, neighbors, entry,
                      corpus_q, qscales, adj_rot, adj_codes, adj_ids, gscales,
                      adj_block: int, scan_block_d: int,
                      device="cuda") -> GraphIndex:
    """The reference's int8 ``GraphIndex`` arrays as the port's index.

    ``adj_rot`` keeps its dtype: float32, or bfloat16 carried as float32
    (every bfloat16 value is exact in float32) and rounded back here, which
    is the identity on such values.
    """
    dev = resolve_device(device)
    rot = np.asarray(adj_rot)
    adj_dtype = torch.bfloat16 if rot.dtype.name == "bfloat16" else torch.float32
    return GraphIndex(
        estimator=estimator, corpus_rot=_t(corpus_rot, dev, torch.float32),
        neighbors=_t(neighbors, dev, torch.int32), entry=int(np.asarray(entry)),
        corpus_q=_t(corpus_q, dev, torch.int8), qscales=_t(qscales, dev, torch.float32),
        adj_rot=_t(rot.astype(np.float32), dev, torch.float32).to(adj_dtype),
        adj_codes=_t(adj_codes, dev, torch.int8), adj_ids=_t(adj_ids, dev, torch.int32),
        gscales=_t(gscales, dev, torch.float32), adj_block=int(adj_block),
        scan_block_d=int(scan_block_d))


def _leaves(tree, prefix: str):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}")
    else:
        yield prefix, tree


def lm_param_map(params):
    """(port parameter name, reference leaf, layer) for every parameter of
    the reference's ``LM.init`` tree ``params`` (nested dicts and lists of
    arrays or shape structs).  ``layer`` indexes the leaf's leading
    'layers' axis for stacked segments (``stacks[i]`` -> the port's
    ``stacks.i.<layer>``) and is None elsewhere."""
    for key, sub in params.items():
        if key in STACKED:
            for i, seg in enumerate(sub):
                for path, leaf in _leaves(seg, ""):
                    for layer in range(leaf.shape[0]):
                        yield f"{key}.{i}.{layer}{path}", leaf, layer
        else:
            for path, leaf in _leaves(sub, key):
                yield path, leaf, None


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def lm_from_arrays(cfg: ArchConfig, params, *, device="cuda") -> LM:
    """The port's ``LM`` holding the values of the reference's parameter
    tree ``params`` (from ``LM.init``, leaves as numpy arrays).  Every
    parameter must be present with the port's shape and dtype."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta")
    want = dict(model.named_parameters())
    state = {}
    for name, leaf, layer in lm_param_map(params):
        t = _tensor(np.asarray(leaf if layer is None else leaf[layer]), dev)
        if name not in want or want[name].shape != t.shape or want[name].dtype != t.dtype:
            ref = want.get(name)
            raise ValueError(f"reference parameter {name} {tuple(t.shape)} {t.dtype} "
                             f"does not fit the port's "
                             f"{None if ref is None else (tuple(ref.shape), ref.dtype)}")
        state[name] = torch.nn.Parameter(t, requires_grad=False)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def adamw_state_from_arrays(cfg: ArchConfig, opt_state, *, device="cuda") -> dict:
    """The port's AdamW state (``optim.adamw``: ``m`` and ``v`` keyed by
    the port's parameter names, ``step`` a 0-d int32) holding the values
    of the reference's ``{"m", "v", "step"}`` tree (numpy leaves), its
    stacked moments unstacked as :func:`lm_from_arrays` unstacks the
    parameters."""
    dev = resolve_device(device)
    want = dict(LM(cfg, device="meta").named_parameters())
    out = {"step": _t(opt_state["step"], dev, torch.int32)}
    for key in ("m", "v"):
        moments = {}
        for name, leaf, layer in lm_param_map(opt_state[key]):
            t = _tensor(np.asarray(leaf if layer is None else leaf[layer]), dev)
            if name not in want or want[name].shape != t.shape or t.dtype != torch.float32:
                raise ValueError(f"reference moment {key}.{name} {tuple(t.shape)} {t.dtype} "
                                 f"does not fit the port's parameters")
            moments[name] = t
        if moments.keys() != want.keys():
            raise ValueError(f"reference moments {key} miss "
                             f"{sorted(want.keys() - moments.keys())[:4]}")
        out[key] = {name: moments[name] for name in want}
    return out


def local_state_from_arrays(cfg: ArchConfig, params, opt_state, shardings: dict, *,
                            device="cuda") -> tuple[dict, dict]:
    """This rank's pieces (copies) of the reference's parameter tree and
    AdamW state (numpy leaves), as ``launch.steps.DataParallel`` holds
    them: each leaf sliced by ``sharding.local_slice`` under
    ``shardings[name]`` (a ``Sharding`` per port parameter name, over a
    ``DeviceMesh`` or a ``RankView``), the moments as their parameters,
    the step whole."""
    from repro_torch.distributed.sharding import local_slice

    def pieces(tree):
        return {k: local_slice(v.detach(), shardings[k].spec, shardings[k].mesh).clone()
                for k, v in tree.items()}

    state = adamw_state_from_arrays(cfg, opt_state, device=device)
    return (pieces(dict(lm_from_arrays(cfg, params, device=device).named_parameters())),
            {"m": pieces(state["m"]), "v": pieces(state["v"]), "step": state["step"]})


def lm_caches_close(ref, got, *, rtol: float, atol: float, near_ties: float = 1e-3,
                    what: str = "") -> tuple[float, int]:
    """Hold every leaf of the LM cache tree ``got`` against ``ref`` (dicts of
    cache tuples, as ``LM.prefill`` and ``LM.init_caches`` return them;
    leaves of either may be numpy arrays or tensors on any device).  Shapes
    and dtypes must be equal, float leaves close at ``rtol`` / ``atol``, and
    int8 KV codes equal but for near-ties: a code one apart where ``x /
    scale`` lies within rounding of a half, at most ``near_ties`` of each
    leaf's codes.  Raises AssertionError; returns (the largest absolute
    difference of a float leaf, the int8 near-ties counted)."""
    assert ref.keys() == got.keys(), (what, ref.keys(), got.keys())
    worst, ties = 0.0, 0
    for key in ref:
        assert tuple(ref[key]._fields) == tuple(got[key]._fields), (what, key)
        for field, r, g in zip(ref[key]._fields, ref[key], got[key]):
            r, g = (x.cpu() if isinstance(x, torch.Tensor) else _tensor(np.asarray(x), "cpu")
                    for x in (r, g))
            name = f"{what} {key}.{field}".strip()
            assert r.shape == g.shape and r.dtype == g.dtype, (name, r.shape, g.shape,
                                                              r.dtype, g.dtype)
            if r.dtype == torch.int8:
                diff = (r.int() - g.int()).abs()
                n = int(diff.count_nonzero())
                assert int(diff.max()) <= 1 and n <= near_ties * r.numel(), (
                    f"{name}: {n} of {r.numel()} int8 codes differ, by up to "
                    f"{int(diff.max())}")
                ties += n
            else:
                torch.testing.assert_close(g, r, rtol=rtol, atol=atol, msg=name)
                worst = max(worst, (g.float() - r.float()).abs().max().item())
    return worst, ties
