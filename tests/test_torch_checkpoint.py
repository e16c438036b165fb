"""The port's checkpoint manager and index snapshots
(``repro_torch.checkpoint.manager`` / ``index_io``) against the
reference's: retention and the sweep of torn step directories; nested
trees saved by one package restored by the other; a graph index and an
estimator snapshotted by the reference loaded in the port, and the
reverse, every array equal; a stale config refused; and the
``slab_corruption`` drill's flipped byte caught by the digest, which names
the leaf.  Every comparison is exact."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_estimator, carry_graph  # noqa: E402
from repro.checkpoint.index_io import load_estimator as j_load_estimator  # noqa: E402
from repro.checkpoint.index_io import load_graph_index as j_load_graph  # noqa: E402
from repro.checkpoint.index_io import save_estimator as j_save_estimator  # noqa: E402
from repro.checkpoint.index_io import save_graph_index as j_save_graph  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.estimators import build_estimator  # noqa: E402
from repro.runtime.chaos import corrupt_checkpoint_leaf as j_corrupt  # noqa: E402
from repro_torch.checkpoint.index_io import (  # noqa: E402
    load_estimator, load_graph_index, save_estimator, save_graph_index)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.runtime.chaos import corrupt_checkpoint_leaf  # noqa: E402

GRAPH_ARRAYS = ("corpus_rot", "neighbors", "corpus_q", "qscales", "adj_rot",
                "adj_codes", "adj_ids", "gscales")
EST_ARRAYS = (("transform", "basis"), ("transform", "variances"),
              ("transform", "cum_variances"), ("table", "dims"), ("table", "eps"),
              ("table", "scale"), ("table", "eps_lo"))


def _tree():
    return {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": np.array([1, -2], np.int32)},
            "steps": [np.int64(7), np.ones((2, 2), np.float32)],
            "opt": (np.zeros(3, np.float32),)}


def test_retention_keeps_last_n_and_sweeps_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (1, 2, 3):
        mgr.save(step, _tree())
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(tmp_path / "step_000000009")  # torn: no tree.json
    os.makedirs(tmp_path / "step_000000004.tmp")  # an interrupted write
    assert mgr.all_steps() == [2, 3]
    mgr.save(5, _tree(), blocking=True)
    assert not os.path.exists(tmp_path / "step_000000009")
    assert mgr.all_steps() == [3, 5]


def test_async_save_waits_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"a": torch.arange(5.0), "b": [torch.ones(2, dtype=torch.int32)]}
    mgr.save(1, tree)
    mgr.wait()
    out = mgr.restore(1, tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0], tree["b"][0])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tree_saved_by_one_package_restores_in_the_other(tmp_path, writer):
    tree = _tree()
    if writer == "port":
        CheckpointManager(str(tmp_path), async_save=False).save(4, tree)
        out = JManager(str(tmp_path), async_save=False).restore(4, tree)
        leaves, like = jax.tree.leaves(out), jax.tree.leaves(tree)
    else:
        JManager(str(tmp_path), async_save=False).save(4, tree)
        out = CheckpointManager(str(tmp_path), async_save=False).restore(4, tree)
        leaves = [out["opt"][0], out["params"]["b"], out["params"]["w"], out["steps"][0],
                  out["steps"][1]]
        like = [tree["opt"][0], tree["params"]["b"], tree["params"]["w"], tree["steps"][0],
                tree["steps"][1]]
    for a, b in zip(leaves, like):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (tmp_path / "step_000000004" / "tree.json").read_text().count("sha256") == 5


def test_tree_metadata_equals_the_references(tmp_path):
    """Paths, shapes, dtypes and digests of the port's tree.json are the
    reference's for the same tree."""
    import json
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(1, _tree())
    JManager(str(tmp_path / "j"), async_save=False).save(1, _tree())
    p = json.loads((tmp_path / "p" / "step_000000001" / "tree.json").read_text())
    j = json.loads((tmp_path / "j" / "step_000000001" / "tree.json").read_text())
    assert p == j


def test_restore_refuses_shardings_and_shape_drift(tmp_path):
    """``shardings=`` places each rank's piece of a stored leaf (a template
    of the piece's shape or the full one), a bf16 leaf too; a template of
    any other shape is refused, with shardings or without."""
    from _torch_dist import rank_view
    from repro_torch.distributed.sharding import tree_shardings

    mgr = CheckpointManager(str(tmp_path), async_save=False)
    full = {"a": torch.arange(24.0).reshape(4, 6),
            "h": (torch.arange(8.0) / 3).to(torch.bfloat16)}
    mgr.save(1, full)
    axes = {"a": ("embed_fsdp", "ffn"), "h": ("embed_fsdp",)}
    pieces = []
    for r in range(2):
        mesh = rank_view((2, 3), ("data", "model"), (r, 1))
        sh = tree_shardings(axes, full, mesh)
        like = {"a": torch.zeros(2, 2), "h": torch.zeros(8, dtype=torch.bfloat16)}
        got = mgr.restore(1, like, shardings=sh)
        assert torch.equal(got["a"], full["a"][2 * r:2 * r + 2, 2:4])
        assert torch.equal(got["h"], full["h"][4 * r:4 * r + 4])
        pieces.append(got["h"])
        with pytest.raises(ValueError, match="shape"):
            mgr.restore(1, {"a": torch.zeros(3, 2), "h": like["h"]}, shardings=sh)
    assert torch.equal(torch.cat(pieces), full["h"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": np.zeros((4, 7)), "h": np.zeros(8)})


@pytest.fixture(scope="module")
def ref_graph(graph_idx):
    return graph_idx[1]


def _same_graph(port, ref):
    assert port.entry == int(np.asarray(ref.entry))
    assert (port.adj_block, port.scan_block_d) == (ref.adj_block, ref.scan_block_d)
    for name in GRAPH_ARRAYS:
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert str(a.numpy().dtype) == str(b.dtype), name
    for part, name in EST_ARRAYS:
        np.testing.assert_array_equal(
            getattr(getattr(port.estimator, part), name).numpy(),
            np.asarray(getattr(getattr(ref.estimator, part), name)), err_msg=name)
    assert port.estimator.method == ref.estimator.method
    assert (port.estimator.quant is None) == (ref.estimator.quant is None)


def test_graph_snapshot_of_the_reference_loads_in_the_port(ref_graph, tmp_path):
    cfg = {"corpus": 1200, "m": 12}
    j_save_graph(str(tmp_path), ref_graph, config=cfg)
    port = load_graph_index(str(tmp_path), expect_config=cfg, device="cpu")
    _same_graph(port, ref_graph)
    assert load_graph_index(str(tmp_path), expect_config={"corpus": 1}, device="cpu") is None


def test_graph_snapshot_of_the_port_loads_in_the_reference(ref_graph, tmp_path):
    cfg = {"corpus": 1200, "m": 12}
    port = carry_graph(ref_graph)
    save_graph_index(str(tmp_path), port, config=cfg)
    back = j_load_graph(str(tmp_path), expect_config=cfg)
    _same_graph(port, back)
    assert j_load_graph(str(tmp_path), expect_config={"m": 3}) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_estimator_snapshot_crosses_packages(aniso_corpus, tmp_path, writer):
    est = build_estimator("adsampling", jnp.asarray(np.asarray(aniso_corpus)[:400]),
                          jax.random.PRNGKey(2), delta_d=16, quant="int8")
    cfg = {"corpus": 400, "method": "adsampling"}
    if writer == "port":
        save_estimator(str(tmp_path), carry_estimator(est), config=cfg)
        back = j_load_estimator(str(tmp_path), expect_config=cfg)
    else:
        j_save_estimator(str(tmp_path), est, config=cfg)
        back = load_estimator(str(tmp_path), expect_config=cfg, device="cpu")
    for part, name in EST_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(getattr(back, part), name)),
                                      np.asarray(getattr(getattr(est, part), name)))
    assert back.method == "adsampling" and back.quant.bits == 8
    assert load_estimator(str(tmp_path), expect_config={}, device="cpu") is None


@pytest.mark.parametrize("corrupter", ["port", "reference"])
def test_slab_corruption_names_the_leaf(ref_graph, tmp_path, corrupter):
    """One flipped payload byte: the file still loads as an array, and
    only the digest catches it — in either package, naming the leaf."""
    save_graph_index(str(tmp_path), carry_graph(ref_graph))
    names = sorted(["corpus_rot", "neighbors", "entry", "est.basis", "est.variances",
                    "est.cum_variances", "est.dims", "est.eps", "est.scale", "est.eps_lo",
                    "corpus_q", "qscales", "adj_rot", "adj_codes", "adj_ids", "gscales"])
    leaf = names.index("adj_rot")
    step_dir = str(tmp_path / "step_000000000")
    path = (corrupt_checkpoint_leaf if corrupter == "port" else j_corrupt)(step_dir, leaf=leaf)
    assert path.endswith(f"leaf_{leaf:05d}.npy")
    np.load(path)  # still a loadable array
    with pytest.raises(IOError, match=rf"leaf {leaf} \(adj_rot\): digest mismatch"):
        load_graph_index(str(tmp_path), device="cpu")
    with pytest.raises(IOError, match="adj_rot"):
        j_load_graph(str(tmp_path))
