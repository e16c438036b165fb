"""Port parity for the serving routes: the one-device int8 fused
``build_search_step`` of ``repro_torch.launch.annservice`` against the JAX
package's (one-device mesh, Pallas interpret mode), the port's serve CLI
end to end on the CPU, and its graph route's recall against the
reference's beam walk on the same corpus and queries."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dade_ivf import ServiceConfig as JServiceConfig  # noqa: E402
from repro.core import build_estimator, exact_knn  # noqa: E402
from repro.data.pipeline import synthetic_queries, synthetic_vectors  # noqa: E402
from repro.kernels.ops import block_table  # noqa: E402
from repro.launch.annservice import build_search_step as j_build_step  # noqa: E402
from repro.launch.annservice import search_input_specs  # noqa: E402
from repro.launch.mesh import make_mesh_compat  # noqa: E402
from repro.quant import fit_block_scales, quantize_block  # noqa: E402
from repro.index.graph import build_graph as j_build_graph  # noqa: E402
from repro.index.graph import search_graph_fused as j_search_graph  # noqa: E402
from repro_torch.configs.dade_ivf import ServiceConfig  # noqa: E402
from repro_torch.kernels.graph_scan import graph_scan_kernel_call  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call  # noqa: E402
from repro_torch.launch.annservice import FUSED_BLOCK_Q, build_search_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(corpus_per_device=2048, dim=64, query_batch=16, k=10, delta_d=16,
             wave=256, p_s=0.02, dtype="float32")


def test_fused_search_step_matches_reference():
    svc_j = JServiceConfig(quant="int8", **SMALL)
    corpus = synthetic_vectors(2048, 64, seed=0)
    queries = synthetic_queries(16, 64, corpus, seed=1)
    est = build_estimator("dade", corpus, jax.random.PRNGKey(0), p_s=0.02, delta_d=16)
    eps, scale, d_pad, eps_lo = block_table(est.table, 64, 16)
    c_rot = np.asarray(est.rotate(jnp.asarray(corpus)))
    q_rot = np.asarray(est.rotate(jnp.asarray(queries)))
    bscales = fit_block_scales(jnp.asarray(c_rot), 16)
    codes = quantize_block(jnp.asarray(c_rot), bscales, 16)

    mesh = make_mesh_compat((1,), ("data",))
    _, sh = search_input_specs(svc_j, mesh, quant="int8", fused=True)
    step_j = jax.jit(j_build_step(svc_j, mesh, quant="int8", fused=True,
                                  with_stats=True), in_shardings=sh)
    d_j, i_j, scan_j = step_j(jax.device_put(c_rot, sh[0]), jax.device_put(codes, sh[1]),
                              jax.device_put(bscales, sh[2]), jnp.asarray(q_rot),
                              eps, scale, eps_lo)

    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    step = build_search_step(ServiceConfig(**SMALL), with_stats=True, shards=1)
    launches = ivf_scan_kernel_call.launches
    d, i, scan = step(T(c_rot), T(codes), T(bscales), T(q_rot), T(eps), T(scale),
                      T(eps_lo))
    assert ivf_scan_kernel_call.launches == launches  # CPU tensors: plain path
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-5)
    # Per-query counters (0-3) do not depend on the query-tile width; the
    # tile-level fetch counters (4-5) are the reference's own at the port's
    # width (the reference's step picks 8 off the TPU, 32 on it).
    scan_j = np.asarray(scan_j, np.float64)
    np.testing.assert_array_equal(scan.numpy()[:4], scan_j[:4])
    np.testing.assert_array_equal(scan.numpy()[4:], _reference_fetch_counters(
        c_rot, codes, bscales, q_rot, eps, scale, svc_j, FUSED_BLOCK_Q))
    _, gt = exact_knn(jnp.asarray(queries), jnp.asarray(corpus), 10)
    gt = np.asarray(gt)
    rec = np.mean([len(set(i.numpy()[r]) & set(gt[r])) / 10 for r in range(16)])
    assert rec >= 0.95


def _reference_fetch_counters(c_rot, codes, bscales, q_rot, eps, scale, svc, block_q):
    """Stats columns 4-5 of the step's scan counted by the reference's oracle
    (``repro.kernels.ref.ivf_scan_ref``) at query-tile width block_q, from
    the step's seeded r0 (whose decisions the other columns hold equal)."""
    from repro.kernels.ref import ivf_scan_ref as j_ivf_scan_ref
    from repro.quant.scalar import quantize_queries_block
    from repro_torch.launch.annservice import seed_rsq

    q = q_rot.shape[0]
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    r0 = seed_rsq(ServiceConfig(**SMALL), T(c_rot), T(q_rot), T(eps)).numpy()
    qcodes, qscales = quantize_queries_block(jnp.asarray(q_rot), svc.delta_d)
    cap = svc.wave // 128
    waves = svc.corpus_per_device // svc.wave
    offs = jnp.broadcast_to(jnp.arange(waves * cap, dtype=jnp.int32).reshape(1, waves, cap),
                            (q // block_q, waves, cap))
    _, _, st = j_ivf_scan_ref(
        offs, qcodes, jnp.asarray(q_rot), qscales, jnp.asarray(r0),
        jnp.full((q, svc.k), jnp.inf, jnp.float32), jnp.full((q, svc.k), -1, jnp.int32),
        codes, jnp.asarray(c_rot), jnp.arange(svc.corpus_per_device, dtype=jnp.int32),
        bscales, eps, scale, k=svc.k, block_q=block_q, block_c=128, block_d=svc.delta_d,
        cap_tiles=cap)
    return np.asarray(st, np.float64)[::block_q, 4:].sum(0)


def _serve(*flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *flags],
                          capture_output=True, text=True, env=env, timeout=300)


def test_serve_cli_prints_report_line():
    out = _serve("--device", "cpu", "--requests", "2", "--corpus", "2048",
                 "--dim", "64", "--batch", "16", "--k", "10", "--wave", "256",
                 "--delta-d", "16")
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    for key in ("method=dade", "quant=int8", "QPS=", "recall@10=", "compile_ms=",
                "s2_fetched_B_per_wave=", "s2_skip_rate=", "device=cpu"):
        assert key in line, line
    assert float(line.split("recall@10=")[1].split()[0]) >= 0.9


@pytest.mark.parametrize("flag,value", [("--graph-shards", "2"), ("--quant", "none"),
                                        ("--fused", "off")])
def test_serve_cli_refuses_unported_routes(flag, value):
    out = _serve("--device", "cpu", flag, value)
    assert out.returncode != 0
    assert flag in out.stderr and value in out.stderr


def test_serve_graph_route_on_cpu(capsys):
    """``--index graph`` end to end at test size: the report's fields, and
    recall@10 within 0.02 of what the reference's beam walk reaches on the
    same corpus, queries and build settings (the two estimators are
    calibrated from different random draws, so equality is not asked)."""
    n, dim, batch = 1024, 64, 16
    launches = graph_scan_kernel_call.launches
    report = serve.main(["--index", "graph", "--device", "cpu", "--requests", "1",
                         "--corpus", str(n), "--dim", str(dim), "--batch", str(batch),
                         "--k", "10", "--delta-d", "16"])
    assert graph_scan_kernel_call.launches == launches  # CPU tensors: plain path
    line = capsys.readouterr().out.strip().splitlines()[-1]
    for key in ("index=graph", "ef=48", "expand=2", "m=16", "QPS=", "recall@10=",
                "waves=", "fetched_B_per_q=", "device=cpu"):
        assert key in line, line
    assert report["requests_served"] == 1 and report["waves"] > 0
    assert report["fetched_bytes_per_query"] > 0 and 0.0 <= report["s2_skip_rate"] < 1.0

    corpus = synthetic_vectors(n, dim, seed=0)
    nq = int(np.random.default_rng(9).integers(batch // 2, 2 * batch))
    assert report["queries"] == nq
    q = synthetic_queries(nq, dim, corpus, seed=100)
    est = build_estimator("dade", corpus[:50000], jax.random.PRNGKey(0), p_s=0.02,
                          delta_d=16)
    g = j_build_graph(corpus, estimator=est, m=16, ef_construction=96, quant="int8")
    _, ids, _ = j_search_graph(g, jnp.asarray(q), k=10, ef=48, expand=2, block_q=8,
                               use_ref=True)
    _, gt = exact_knn(jnp.asarray(q), jnp.asarray(corpus), 10)
    ids, gt = np.asarray(ids), np.asarray(gt)
    ref_recall = np.mean([len(set(ids[r]) & set(gt[r])) / 10 for r in range(nq)])
    assert abs(report["recall"] - ref_recall) <= 0.02, (report["recall"], ref_recall)


def _toy_step(calls):
    def step(qs):
        calls.append(qs.copy())
        if qs[0, 0] < 0:
            raise RuntimeError("poisoned batch")
        return qs[:, :1] * 2.0, np.arange(len(qs))[:, None] + 10 * len(calls)
    return step


def test_batch_scheduler_matches_reference_batching():
    """Same requests, same step: the port packs, pads and scatters exactly
    as the reference's scheduler does."""
    from repro.runtime.scheduler import BatchScheduler as JBatchScheduler
    from repro_torch.runtime.scheduler import BatchScheduler

    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal((n, 3)).astype(np.float32) + 5.0
                for n in (3, 5, 1, 4)]
    calls_j, calls_t = [], []
    ref = JBatchScheduler(_toy_step(calls_j), batch_size=4)
    port = BatchScheduler(_toy_step(calls_t), batch_size=4)
    reqs_j = [ref.submit(q) for q in payloads]
    reqs_t = [port.submit(q) for q in payloads]
    ref.drain(force=True)
    done = port.drain()
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert len(calls_t) == len(calls_j) == 4
    for a, b in zip(calls_t, calls_j):
        np.testing.assert_array_equal(a, b)
    for rt, rj, q in zip(reqs_t, reqs_j, payloads):
        assert rt.status == rj.status == "served"
        np.testing.assert_array_equal(rt.result[0], rj.result[0])
        np.testing.assert_array_equal(rt.result[1], rj.result[1])
        np.testing.assert_array_equal(rt.result[0], q[:, :1] * 2.0)
    for key in ("batches", "padded_rows", "rows", "submitted", "served"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["padded_rows"] == 3


def test_batch_scheduler_step_error_propagates():
    """A failing step's error propagates to the scheduler, which (no retries
    asked for) sheds the batch's requests as ``shed_error`` and counts them,
    as the reference's scheduler does; the next batch is served."""
    from repro_torch.runtime.scheduler import BatchScheduler

    calls = []
    sched = BatchScheduler(_toy_step(calls), batch_size=4)
    bad = sched.submit(-np.ones((4, 2)))  # fills the first batch
    good = sched.submit(np.ones((2, 2)))
    done = sched.drain()
    assert len(calls) == 2 and calls[0][0, 0] == -1.0
    assert bad.status == "shed_error" and bad.result is None
    assert done == [good] and good.status == "served"
    assert sched.stats["shed_error"] == 1 and sched.stats["retries"] == 0
