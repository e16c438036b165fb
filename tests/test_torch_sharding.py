"""The port's logical-axis sharding rules (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``) on the same meshes
and shapes: ``tests/test_sharding.py``'s cases on a 16 x 16 ("data",
"model") ``AbstractMesh`` and its port counterpart, hypothesis over shapes,
meshes and rule tables, and every architecture's full-config parameter
axes and cell ``in_shardings`` (train_4k, decode_32k, long_500k with its
override) against the reference's ``build_cell`` through ``jax.eval_shape``
and ``device="meta"``.  Specs are compared with each entry normalised to
None or a tuple of mesh-axis names."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.configs import LM_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as J  # noqa: E402
from repro.launch.steps import _axes_of  # noqa: E402
from repro.launch.steps import build_cell as j_build_cell  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.interop import lm_param_map  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

MESH_AXES = ("pod", "data", "model")


def _j_mesh(sizes, names):
    # jax >= 0.5 takes (shape, names); 0.4.x a name -> size tuple
    try:
        return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


@pytest.fixture(scope="module")
def meshes():
    return _j_mesh((16, 16), ("data", "model")), S.AbstractMesh((16, 16), ("data", "model"))


def _norm(spec) -> tuple:
    """A spec's entries as None or tuples of mesh-axis names."""
    return tuple(None if not p else ((p,) if isinstance(p, str) else tuple(p)) for p in spec)


def _rules(meshes, table=None):
    table = dict(table or J.DEFAULT_RULE_TABLE)
    return J.Rules(mesh=meshes[0], table=table), S.Rules(mesh=meshes[1], table=table)


# tests/test_sharding.py's cases: (logical axes, shape, the expected spec)
SHARDING_CASES = [
    (("embed_fsdp", "ffn"), (7168, 19200), (("data",), ("model",))),
    (("batch", "seq", "heads", "head_dim"), (16, 4096, 56, 128), (("data",), None, None, None)),
    (("batch", "seq", "kv_heads", "head_dim"), (16, 4096, 8, 128), (("data",), None, None, None)),
    (("batch", "seq", "kv_heads", "head_dim"), (16, 4096, 32, 128),
     (("data",), None, ("model",), None)),
    (("batch", "seq"), (256, 4096), (("data",), None)),
    (("batch", "seq"), (1, 4096), (None, None)),
    (("vocab",), (50280,), (None,)),
    (("vocab",), (50432,), (("model",),)),
]


@pytest.mark.parametrize("axes,shape,want", SHARDING_CASES)
def test_logical_to_spec_matches_reference_cases(meshes, axes, shape, want):
    jr, pr = _rules(meshes)
    assert _norm(J.logical_to_spec(axes, shape, jr)) == want
    assert S.logical_to_spec(axes, shape, pr) == want


def test_tree_shardings_and_spec_bytes_match_reference(meshes):
    axes = {"w": ("embed_fsdp", "ffn"), "scale": ("embed",)}
    j_shapes = {"w": jax.ShapeDtypeStruct((256, 512), jax.numpy.float32),
                "scale": jax.ShapeDtypeStruct((256,), jax.numpy.float32)}
    shapes = {"w": torch.empty((256, 512), device="meta"),
              "scale": torch.empty((256,), device="meta")}
    j_sh, sh = J.tree_shardings(axes, j_shapes, meshes[0]), S.tree_shardings(axes, shapes,
                                                                            meshes[1])
    from torch.distributed.tensor import Replicate, Shard
    for k in axes:
        assert sh[k].spec == _norm(j_sh[k].spec)
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert sh["scale"].placements == (Replicate(), Replicate())
    for spec in (P(("data",), ("model",)), P(None, None), P("model", None)):
        assert S.spec_bytes(shapes["w"], _norm(spec), meshes[1]) == J.spec_bytes(
            j_shapes["w"], spec, meshes[0])
    assert S.spec_bytes(shapes["w"], (("data",), ("model",)), meshes[1]) == 16 * 32 * 4


_MESHES = [((16, 16), ("data", "model")), ((2, 1), ("data", "model")),
           ((2, 4, 4), MESH_AXES), ((3, 2), ("data", "model")), ((8,), ("data",))]


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_rules_match_reference_property(data):
    """Random meshes, rule tables (overrides of random logical axes to
    ordered subsets of the mesh axes), logical axes and dimensions: equal
    specs, per-device bytes, and placements naming the sharded dimension."""
    sizes, names = data.draw(st.sampled_from(_MESHES))
    meshes = (_j_mesh(sizes, names), S.AbstractMesh(sizes, names))
    logical = sorted(J.DEFAULT_RULE_TABLE)
    table = dict(J.DEFAULT_RULE_TABLE)
    for ax in data.draw(st.lists(st.sampled_from(logical), max_size=4, unique=True)):
        table[ax] = tuple(data.draw(st.lists(st.sampled_from(MESH_AXES), max_size=3,
                                             unique=True)))
    ndim = data.draw(st.integers(1, 4))
    axes = tuple(data.draw(st.lists(st.sampled_from(logical + [None]), min_size=ndim,
                                    max_size=ndim)))
    shape = tuple(data.draw(st.lists(st.sampled_from([1, 2, 3, 6, 8, 12, 16, 48, 64, 96, 256]),
                                     min_size=ndim, max_size=ndim)))
    jr, pr = _rules(meshes, table)
    want = _norm(J.logical_to_spec(axes, shape, jr))
    got = S.logical_to_spec(axes, shape, pr)
    assert got == want
    dtype = data.draw(st.sampled_from([(jax.numpy.float32, torch.float32),
                                       (jax.numpy.bfloat16, torch.bfloat16)]))
    assert S.spec_bytes(torch.empty(shape, dtype=dtype[1], device="meta"), got, meshes[1]) \
        == J.spec_bytes(jax.ShapeDtypeStruct(shape, dtype[0]), P(*want), meshes[0])
    sh = S.tree_shardings(axes, shape, meshes[1], {k: v for k, v in table.items()
                                                   if J.DEFAULT_RULE_TABLE.get(k) != v})
    assert sh.spec == want
    for name, pl in zip(names, sh.placements):
        dims = [i for i, p in enumerate(want) if p and name in p]
        assert (pl.is_shard() and [pl.dim] == dims) or (pl.is_replicate() and not dims)


class _Leaf:
    """A reference leaf's shape and what the test carries on it."""

    def __init__(self, shape, val):
        self.shape, self.val = shape, val


def _by_name(shapes, tree, is_leaf=None) -> dict:
    """{port parameter name: (the value at that leaf of ``tree``, stacked?)}
    for a tree parallel to the reference's parameter ``shapes``."""
    carried = jax.tree.map(lambda s, v: _Leaf(s.shape, v), shapes, tree, is_leaf=is_leaf)
    return {name: (leaf.val, layer is not None) for name, leaf, layer in lm_param_map(carried)}


def _unstacked(spec, stacked: bool) -> tuple:
    spec = _norm(spec)
    if stacked:  # the 'layers' axis resolves to no mesh axis
        assert spec[0] is None
        return spec[1:]
    return spec


def _same_tree(j_tree, p_tree, what):
    """Two sharding trees of one structure (the port's leaves ``Sharding``)."""
    jl, jdef = jax.tree.flatten(j_tree)
    pl, pdef = jax.tree.flatten(p_tree)
    assert len(jl) == len(pl), what
    for i, (j, p) in enumerate(zip(jl, pl)):
        assert p.spec == _norm(j.spec), (what, i, p.spec, j.spec)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_axes_and_cell_shardings_match_reference(meshes, arch):
    """At FULL config: each parameter's logical axes (a stacked leaf's less
    its 'layers' entry), and the in_shardings of train_4k (parameters,
    both moments and the step, batch), decode_32k (parameters, token,
    caches, position; its out_shardings) and long_500k (the cache seq
    spread by its override) equal the reference's on the 16 x 16 mesh."""
    j_mesh, mesh = meshes
    shapes, j_axes = _axes_of(j_build_model(j_get_config(arch)))
    is_axes = lambda t: isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                                     for e in t)
    ref_axes = _by_name(shapes, j_axes, is_leaf=is_axes)
    got = build_model(get_config(arch), device="meta").param_axes()
    assert got.keys() == ref_axes.keys()
    for name, (axes, stacked) in ref_axes.items():
        assert got[name] == (axes[1:] if stacked else axes), name
        if stacked:
            assert axes[0] == "layers"

    jt = j_build_cell(arch, "train_4k", j_mesh)
    pt = build_cell(arch, "train_4k", mesh=mesh, device="meta")
    j_par = _by_name(shapes, jt.in_shardings[0])
    for name, sh in pt.in_shardings[0].items():
        assert sh.spec == _unstacked(j_par[name][0].spec, j_par[name][1]), name
    for m in ("m", "v"):
        j_mom = _by_name(shapes, jt.in_shardings[1][m])
        for name, sh in pt.in_shardings[1][m].items():
            assert sh.spec == _unstacked(j_mom[name][0].spec, j_mom[name][1]), (m, name)
    assert pt.in_shardings[1]["step"].spec == _norm(jt.in_shardings[1]["step"].spec) == ()
    _same_tree(jt.in_shardings[2], pt.in_shardings[2], "train batch")

    for shape in ("decode_32k", "long_500k"):
        jd = j_build_cell(arch, shape, j_mesh)
        pd = build_cell(arch, shape, mesh=mesh, device="meta")
        j_par = _by_name(shapes, jd.in_shardings[0])
        for name, sh in pd.in_shardings[0].items():
            assert sh.spec == _unstacked(j_par[name][0].spec, j_par[name][1]), (shape, name)
        for i, what in ((1, "token"), (2, "caches"), (3, "pos")):
            _same_tree(jd.in_shardings[i], pd.in_shardings[i], f"{shape} {what}")
        _same_tree(jd.out_shardings, pd.out_shardings, f"{shape} out")
        j_bytes = sum(J.spec_bytes(s, sh.spec, j_mesh) for s, sh in zip(
            jax.tree.leaves(jd.args[2]), jax.tree.leaves(jd.in_shardings[2])))
        p_bytes = sum(S.spec_bytes(t, sh.spec, mesh) for t, sh in zip(
            jax.tree.leaves(pd.args[1]), jax.tree.leaves(pd.in_shardings[2])))
        assert p_bytes == j_bytes, (shape, "per-device cache bytes")


def test_constrain_is_a_noop_and_use_rules_nests(meshes):
    x = torch.ones(3)
    assert S.current_rules() is None
    with S.use_rules(meshes[1], {"batch": ("data",)}):
        assert S.current_rules().table["batch"] == ("data",)
        with S.use_rules(meshes[1]):
            assert S.current_rules().table["batch"] == ("pod", "data")
        assert S.constrain(x, "batch") is x
    assert S.current_rules() is None


def test_local_slice_tiles_the_tensor():
    """The pieces every coordinate of a (2, 3) mesh takes tile the tensor, a
    dimension split over (data, model) data-major, as the reference's."""
    mesh = S.AbstractMesh((2, 3), ("data", "model"))
    x = torch.arange(12 * 5).reshape(12, 5)
    spec = (("data", "model"), None)
    pieces = {(d, m): S.local_slice(x, spec, mesh, (d, m)) for d in range(2) for m in range(3)}
    assert S.local_shape(x.shape, spec, mesh) == (2, 5)
    got = torch.cat([pieces[(d, m)] for d in range(2) for m in range(3)])
    assert torch.equal(got, x)
    np.testing.assert_array_equal(pieces[(1, 0)].numpy(), x[6:8].numpy())
