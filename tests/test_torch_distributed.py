"""The port's multi-rank serving on the CPU, each rank a gloo process
(``launch.mesh.spawn``, rank functions in ``tests/_torch_dist.py``):

  * ``hierarchical_topk`` on a 2 x 2 mesh against the reference's, run
    under nested ``jax.vmap`` with named axes (where its ``all_gather``
    works without a forced-device subprocess), ties included;
  * the process-group sharded graph engine at 2 and 4 ranks against the
    host-simulated walk, bit for bit, with every rank's merged window and
    bitmap equal after every wave, and a dead-shard drill against the
    surviving-corpus oracle;
  * the flat step over 2 ranks against the one-process
    ``build_search_step(shards=4)``, and its input specs;
  * a CPU ``serve --graph-shards 2`` whose metrics pass the schema check;
  * the int8 codec against the reference's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_carry import carry_graph  # noqa: E402
from repro.distributed.collectives import (  # noqa: E402
    dequantize_int8 as j_dequantize, hierarchical_topk as j_htopk,
    quantize_int8 as j_quantize)
from repro_torch.checkpoint.index_io import save_graph_index  # noqa: E402
from repro_torch.configs.dade_ivf import ServiceConfig  # noqa: E402
from repro_torch.distributed.collectives import dequantize_int8, quantize_int8  # noqa: E402
from repro_torch.index.graph import dead_shard_tombstones, search_graph_sharded  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.annservice import build_search_step, sharded_graph_engine  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.runtime.chaos import parse_chaos, use_chaos  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ranks(fn, world, tmp_path, *args):
    return spawn(fn, world, backend="gloo", init_file=str(tmp_path / "init"),
                 args=args, device="cpu").join(timeout_s=120)


def test_hierarchical_topk_matches_reference(tmp_path):
    """Every rank of the 2 x 2 mesh returns the reference's merged window for
    its mesh position; distances drawn from few values, so ties cross ranks.
    The ranks also build ``make_host_mesh(2, 2)`` and see (4, 2) refused."""
    rng = np.random.default_rng(0)
    k, qn = 5, 3
    sq = np.sort(rng.choice(np.float32([0.5, 1.0, 1.5, 2.0, np.inf]), (2, 2, qn, k)), axis=-1)
    ids = rng.permutation(4 * qn * k).astype(np.int32).reshape(2, 2, qn, k)
    ref = jax.vmap(jax.vmap(lambda s, i: j_htopk(s, i, ("b", "a"), k), axis_name="b"),
                   axis_name="a")(jnp.asarray(sq), jnp.asarray(ids))
    out = _ranks(_torch_dist.topk_rank, 4, tmp_path, sq, ids, k)
    for r, (o_sq, o_ids, host, too_big) in out.items():
        a, b = divmod(r, 2)  # the mesh's row-major order
        np.testing.assert_array_equal(o_sq, np.asarray(ref[0])[a, b])
        np.testing.assert_array_equal(o_ids, np.asarray(ref[1])[a, b])
        assert host == ((2, 2), ("data", "model"))
        assert "(4, 2) mesh needs 8 ranks, the group has 4" in too_big


def test_int8_codec_matches_reference():
    x = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    q, s = quantize_int8(torch.as_tensor(x))
    qj, sj = j_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(float(s), float(sj), rtol=1e-7)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(j_dequantize(qj, sj)), rtol=1e-6)


@pytest.fixture(scope="module")
def snapshot(graph_idx, tmp_path_factory):
    """The fixture graph carried into the port and saved as the snapshot the
    ranks load their slabs from."""
    g = carry_graph(graph_idx[1])
    path = tmp_path_factory.mktemp("graph_snapshot")
    save_graph_index(str(path), g)
    return g, str(path)


@pytest.mark.parametrize("shards", [2, 4])
def test_process_group_engine_equals_host_walk(snapshot, queries, shards):
    """The engine over a gloo group returns the host-simulated walk's ids,
    distances and ledger; every rank ends every wave with the same window
    and bitmap (their digests agree wave by wave); with shard 1 dead the
    survivors return the surviving-corpus oracle, the dead rank handed no
    frontier node (it would raise)."""
    g, path = snapshot
    q = np.asarray(queries)[:8]
    with sharded_graph_engine(g, path, num_shards=shards, backend="gloo", k=10, ef=32,
                              record=True, device="cpu") as engine:
        d, i, st = engine(q)
        with use_chaos(parse_chaos("shard_death:shard=1:after=0")) as chaos:
            chaos.on_engine_step()
            d2, i2, st2 = engine(q)
    do, io, so = search_graph_sharded(g, q, num_shards=shards, k=10, ef=32, device="cpu")
    assert np.array_equal(i, io.numpy()) and np.array_equal(d, do.numpy()) and st == so
    tombs = dead_shard_tombstones(g.corpus_rot.shape[0], shards, [1])
    do, io, _ = search_graph_sharded(g, q, num_shards=1, k=10, ef=32, use_ref=True,
                                     device="cpu", tombstones=tombs)
    assert np.array_equal(i2, io.numpy()) and np.array_equal(d2, do.numpy())
    assert st2.dead_shards == (1,) and st2.shard_s1_tiles_fetched[1] == 0.0
    ranks = engine.ranks
    assert sorted(ranks) == list(range(shards))
    digests = ranks[0]["digests"]
    assert len(digests) == st.waves + st2.waves
    assert all(ranks[r]["digests"] == digests for r in ranks)
    assert all(ranks[r]["waves"] == len(digests) for r in ranks)


def _flat_service():
    svc = ServiceConfig(corpus_per_device=2048, dim=64, query_batch=16, k=10,
                        delta_d=16, wave=256, dtype="float32")
    srv = serve.prepare_service(svc, "dade", "cpu")
    q = srv.prep(np.random.default_rng(3).standard_normal((16, 64)).astype(np.float32))
    return svc, srv, q


def test_flat_step_over_ranks_equals_one_process(tmp_path):
    """Two ranks of 1,024 rows, two segments each, return the one-process
    four-segment step's ids and distances, and its scan counters; every
    rank returns the same results.  The specs describe the step's inputs
    over the 2-rank mesh."""
    svc, srv, q = _flat_service()
    d1, i1, scan1 = build_search_step(svc, with_stats=True, shards=4)(
        srv.rows, srv.codes, srv.bscales, q, srv.eps, srv.scale, srv.eps_lo)
    svc_rank = ServiceConfig(**{**svc.__dict__, "corpus_per_device": 1024})
    out = _ranks(_torch_dist.flat_rank, 2, tmp_path, svc_rank, srv.rows.numpy(),
                 srv.codes.numpy(), srv.bscales.numpy(), q.numpy(), srv.eps.numpy(),
                 srv.scale.numpy(), srv.eps_lo.numpy(), 4)
    for r, (d, i, scan, specs) in out.items():
        np.testing.assert_array_equal(i, i1.numpy())
        np.testing.assert_array_equal(d, d1.numpy())
        np.testing.assert_array_equal(scan, scan1.numpy())
        assert specs == [((2048, 64), "torch.float32", "Shard(0)"),
                         ((2048, 64), "torch.int8", "Shard(0)"),
                         ((4,), "torch.float32", "Replicate"),
                         ((16, 64), "torch.float32", "Replicate")] + [
                             ((4,), "torch.float32", "Replicate")] * 3


def test_serve_graph_shards_metrics_pass_schema(tmp_path):
    """``serve --index graph --graph-shards 2`` on the CPU (gloo): served,
    verified against the frozen-threshold oracle, its metrics through the
    schema check with the per-shard sum rule."""
    path = tmp_path / "m.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--index", "graph",
         "--device", "cpu", "--requests", "2", "--corpus", "1024", "--dim", "64",
         "--batch", "16", "--k", "10", "--delta-d", "16", "--graph-shards", "2",
         "--dist-backend", "gloo", "--verify-graph-oracle", "--metrics-json", str(path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "verify: shards=2 engine bit-identical" in out.stdout
    assert "backend=gloo" in out.stdout
    check = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                            str(path)], capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stdout + check.stderr
    doc = json.loads(path.read_text())
    m = doc["metrics"]
    assert m["graph.sharded.num_shards"]["value"] == 2
    # Two rank processes on the host: one device, not two.
    assert doc["config"]["rank_processes"] == 2 and doc["config"]["devices"] == 1
    assert doc["report"]["recall"] >= 0.9 and doc["report"]["backend"] == "gloo"
    assert m["graph.sharded.shard0.fetched_bytes"]["value"] > 0
    assert m["graph.sharded.shard1.fetched_bytes"]["value"] > 0
