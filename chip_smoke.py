#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``src/repro_torch``) on the card at the full
width of the ``dade_ivf`` workload and fails (nonzero exit, no result line)
on any fault.  Phases, one line each:

  1. build: ``nvcc`` builds the ivf_scan kernel from ``csrc/``; the card's
     name and power limit as ``nvidia-smi`` reports them;
  2. parity: the kernel against its plain PyTorch version on identical
     inputs — awkward small shapes and one full-width slice;
  3. ivf: ``build_ivf`` + ``search_ivf_fused`` on a 2^20 x 256 corpus, the
     kernel held against the plain version on the search's own inputs;
  4. serve: the flat serving route (``repro_torch.launch.serve``) at the
     ``dade_ivf`` configuration, 3 requests, recall@100 >= 0.95;
  5. kernels: launches on the main path, worst deviation from the plain
     version, time at the serving shape beside its bound, the plain
     version's time (its output held against the kernel's at that shape)
     and one library call's time.

Kernel parity rule: the top-K ids, the squared distances and every stats
counter are equal bit for bit (tolerance zero): the kernel and its plain
version round every float operation alike, in the same order.  Float32
matmuls run in full float32 here: TF32 is switched off explicitly.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int):
    """(median milliseconds of ``fn()`` over ``reps`` runs, CUDA events;
    the last run's output)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def compare(name, args, kw):
    """Kernel vs plain version on identical inputs; see :func:`agree`."""
    from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call
    from repro_torch.kernels.ref import ivf_scan_ref

    out_k = ivf_scan_kernel_call(*args, **kw)
    out_p = ivf_scan_ref(*args, **kw)
    sync()
    return agree(name, out_k, out_p, kw["block_q"])


def agree(name, out_k, out_p, block_q):
    """Holds the kernel's (top_sq, top_ids, stats) against the plain
    version's on the same inputs; returns the largest absolute deviation of
    the squared distances (0 when they agree).

    The two evaluate every float operation in the same order with the same
    rounding (stage 1's int8 products are exact integers; stage 2 sums one
    dimension at a time with rounded multiplies and adds), so the windows,
    the squared distances and every stats counter must be equal bit for
    bit; the tolerance is zero."""
    import torch

    (sq_k, ids_k, st_k), (sq_p, ids_p, st_p) = out_k, out_p
    fin = torch.isfinite(sq_p)
    err = float((sq_k[fin] - sq_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    diff_ids = int((ids_k != ids_p).sum())
    diff_rows = int((st_k != st_p).any(dim=1).sum())
    log(f"parity {name}: ids_differ={diff_ids} stats_rows_differ={diff_rows} "
        f"max_abs_err={err:.3e} rows_passed={float(st_k[:, 3].sum()):.0f} "
        f"s2_slabs={float(st_k[::block_q, 4].sum()):.0f}")
    check(torch.equal(ids_k, ids_p), f"{name}: top-K ids differ")
    check(torch.equal(st_k, st_p), f"{name}: stats counters differ")
    check(torch.equal(torch.isfinite(sq_k), fin) and err == 0.0,
          f"{name}: squared distances differ")
    return err


def awkward_case(seed, *, k, block_q=8, block_c=128, n_rows=4096, dim=256,
                 block_d=64, qn=30, probes=6, bf16=False, seeded=False):
    """Unaligned windows, id holes, -1 steps, cross-gap tile reuse, padded
    query rows, optionally seeded windows and bf16 rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.quant.scalar import (
        fit_block_scales, quantize_block, quantize_queries_block)

    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    scales = torch.exp(-0.02 * torch.arange(dim, device=dev))
    rows = torch.randn((n_rows, dim), generator=g, device=dev) * scales
    ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    ids[torch.rand(n_rows, generator=g, device=dev) < 0.1] = -1
    ids[-2 * block_c:] = -1
    clean = torch.where(ids[:, None] >= 0, rows, torch.zeros_like(rows))
    bs = fit_block_scales(clean, block_d)
    codes = quantize_block(clean, bs, block_d)
    rows = torch.where(ids[:, None] >= 0, rows, torch.full_like(rows, 1e18))
    pick = torch.randint(0, n_rows // 2, (qn,), generator=g, device=dev)
    q = clean[pick] + 0.2 * torch.randn((qn, dim), generator=g, device=dev) * scales
    q_pad = ((qn + block_q - 1) // block_q) * block_q
    q = torch.cat([q, torch.zeros((q_pad - qn, dim), device=dev)])
    q_tiles = q_pad // block_q
    rng = np.random.default_rng(seed)
    ws = rng.integers(0, n_rows - 4 * block_c, (q_tiles, probes))
    wr = rng.integers(1, 3 * block_c, (q_tiles, probes))
    ws[:, 1] = ws[:, 1] // block_c * block_c + 3
    ws[:, 2], wr[:, 1], wr[:, 2] = ws[:, 1], 5, 5  # reuse across -1 steps
    ws[:, 4], wr[:, 4] = ws[:, 0], wr[:, 0]  # revisit after other tiles
    cap = ops.ivf_cap_tiles(int(wr.max()), block_c, starts_aligned=False)
    offs = ops.build_window_offsets(torch.as_tensor(ws, device=dev),
                                    torch.as_tensor(wr, device=dev),
                                    block_c=block_c, cap_tiles=cap, n_pad=n_rows)
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    eps = torch.linspace(0.4, 0.0, s, device=dev)
    scale = torch.linspace(float(s), 1.0, s, device=dev)
    d2 = torch.cdist(q, clean) ** 2
    r0 = torch.quantile(d2, 0.02, dim=1)
    r0[qn:] = 0.0  # pad query rows carry r² = 0
    r0[1] = float("inf")
    top0_sq = torch.full((q_pad, k), float("inf"), device=dev)
    top0_ids = torch.full((q_pad, k), -1, dtype=torch.int32, device=dev)
    if seeded:  # a window resumed from an earlier scan: sorted, some filled
        fill = max(k // 2, 1)
        vals, order = torch.sort(d2[:qn, 2048:2048 + fill], dim=1)
        top0_sq[:qn, :fill] = vals
        top0_ids[:qn, :fill] = 2048 + order.to(torch.int32)
    rows_in = rows.to(torch.bfloat16) if bf16 else rows
    args = (offs, qcodes, q, qscales, r0, top0_sq, top0_ids, codes, rows_in,
            ids, bs, eps, scale)
    return args, dict(k=k, block_q=block_q, block_c=block_c, block_d=block_d,
                      cap_tiles=cap)


def run(svc, *, n_clusters: int, n_queries: int, slice_rows: int,
        slice_queries: int, card: str) -> dict:
    """Phases 2-5 on ``DEV``; returns the kernels entry."""
    import torch
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.index.ivf import build_ivf, fused_search_inputs, search_ivf_fused
    from repro_torch.kernels import ivf_scan
    from repro_torch.kernels.ref import ivf_scan_ref
    from repro_torch.launch import serve
    from repro_torch.launch.annservice import fused_scan_inputs, seed_rsq

    kernel = ivf_scan.ivf_scan_kernel_call
    t_start = time.perf_counter()

    # ---- 2. parity: kernel vs plain on identical inputs ----
    max_err = 0.0
    cases = [
        ("k1", dict(seed=1, k=1)),
        ("k10_seeded", dict(seed=2, k=10, seeded=True)),
        ("k100_bf16", dict(seed=3, k=100, bf16=True)),
        ("k100_seeded_bf16", dict(seed=4, k=100, seeded=True, bf16=True)),
        ("k7_d128_bd32", dict(seed=5, k=7, dim=128, block_d=32)),
        ("k128_many_probes", dict(seed=6, k=128, n_rows=8192, probes=12)),
    ]
    for name, kw in cases:
        args, kkw = awkward_case(**kw)
        max_err = max(max_err, compare(name, args, kkw))

    t0 = time.perf_counter()
    srv = serve.prepare_service(svc, "dade", DEV)
    log(f"prepare: {svc.corpus_per_device}x{svc.dim} corpus rotated and encoded "
        f"in {time.perf_counter() - t0:.1f}s")
    qs = srv.prep(synthetic_queries(slice_queries, svc.dim, srv.corpus, seed=5))
    rows_s, codes_s = srv.rows[:slice_rows], srv.codes[:slice_rows]
    r0 = seed_rsq(svc, rows_s, qs, srv.eps)
    args, kw = fused_scan_inputs(svc, rows_s, codes_s, srv.bscales, qs,
                                 srv.eps, srv.scale, r0)
    max_err = max(max_err, compare(f"full_width_{slice_queries}x{slice_rows}", args, kw))

    # ---- 3. IVF search at full width ----
    t0 = time.perf_counter()
    idx = build_ivf(srv.corpus_t, n_clusters=n_clusters, scan_block_d=svc.delta_d, delta_d=svc.delta_d, p_s=svc.p_s,
                    generator=torch.Generator().manual_seed(0), device=DEV)
    sync()
    build_s = time.perf_counter() - t0
    queries = synthetic_queries(n_queries, svc.dim, srv.corpus, seed=1)
    _, gt = exact_knn(queries, srv.corpus_t, svc.k, device=DEV)
    args, kw, _ = fused_search_inputs(idx, queries, k=svc.k, n_probe=16)
    max_err = max(max_err, compare(f"ivf_search_{n_queries}q_probe16", args, kw))
    del args
    kernel.launches = 0
    t0 = time.perf_counter()
    d, ids, st = search_ivf_fused(idx, queries, k=svc.k, n_probe=16)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    ivf_launches = kernel.launches
    check(ivf_launches > 0, "search_ivf_fused launched no ivf_scan kernel")
    check(tuple(ids.shape) == (n_queries, svc.k) and bool(torch.isfinite(d).all()),
          "search_ivf_fused output malformed")
    ids_np, gt_np = ids.cpu().numpy(), gt.cpu().numpy()
    rec = sum(len(set(ids_np[i]) & set(gt_np[i])) for i in range(n_queries)) / (
        n_queries * svc.k)
    t0 = time.perf_counter()
    search_ivf_fused(idx, queries, k=svc.k, n_probe=16)
    sync()
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"ivf: build {build_s:.1f}s max_bucket={idx.max_bucket} recall@{svc.k}={rec:.4f} "
        f"fetched_B_per_query={st.fetched_bytes_per_query:.0f} "
        f"bytes_per_query={st.bytes_per_query:.0f} s2_skip_rate={st.s2_skip_rate:.3f} "
        f"search_ms(first)={first_ms:.1f} search_ms(warm)={warm_ms:.1f} "
        f"launches={ivf_launches}")
    # Right answers for what was returned: unique ids per row, ascending
    # distances, each the exact distance of its id (fp32 rounding).  Recall
    # at 16 of 1024 buckets with 8-query tile routing is a property of the
    # workload and is reported, not gated.
    rows_ok = all(len(set(r)) == svc.k for r in ids_np)
    check(rows_ok and bool((d[:, 1:] >= d[:, :-1]).all()), "ivf ids repeat or unsorted")
    exact = torch.linalg.vector_norm(
        srv.corpus_t[ids.long()] - torch.as_tensor(queries, device=DEV)[:, None, :], dim=-1)
    check(bool(torch.allclose(d, exact, rtol=1e-4, atol=1e-4)),
          "ivf distances are not the exact distances of the returned ids")
    del idx

    # ---- 4. serving route at the dade_ivf configuration ----
    kernel.launches = 0
    report = serve.main([
        "--device", DEV, "--requests", "3", "--corpus", str(svc.corpus_per_device),
        "--dim", str(svc.dim), "--k", str(svc.k), "--batch", str(svc.query_batch),
        "--wave", str(svc.wave), "--delta-d", str(svc.delta_d), "--dtype", svc.dtype,
        "--p-s", str(svc.p_s)])
    serve_launches = kernel.launches
    check(serve_launches > 0, "the serving route launched no ivf_scan kernel")
    check(report["recall"] >= 0.95, f"serving recall@{svc.k} {report['recall']} < 0.95")
    log(f"serve: ok recall@{svc.k}={report['recall']:.4f} qps={report['qps']:.1f} "
        f"launches={serve_launches}")

    # ---- 5. the kernel at the serving shape: time, bound, plain, library ----
    qb = srv.prep(synthetic_queries(svc.query_batch, svc.dim, srv.corpus, seed=7))
    r0 = seed_rsq(svc, srv.rows, qb, srv.eps)
    args, kw = fused_scan_inputs(svc, srv.rows, srv.codes, srv.bscales, qb,
                                 srv.eps, srv.scale, r0)
    kernel(*args, **kw)  # warm
    ms, out_k = cuda_ms(lambda: kernel(*args, **kw), 5)
    st_k = out_k[2]
    t0 = time.perf_counter()
    plain_ms, out_p = cuda_ms(lambda: ivf_scan_ref(*args, **kw), 1)
    log(f"plain: one call at the serving shape in {time.perf_counter() - t0:.1f}s")
    max_err = max(max_err, agree(f"serving_shape_{qb.shape[0]}x{srv.rows.shape[0]}",
                                 out_k, out_p, kw["block_q"]))
    del out_p
    a8, b8 = args[1], srv.codes
    library_ms, _ = cuda_ms(lambda: torch._int_mm(a8, b8.T), 3)

    qn, n, dim = qb.shape[0], srv.rows.shape[0], svc.dim
    bq, bc, bd = kw["block_q"], kw["block_c"], kw["block_d"]
    st = st_k.double()
    # Operations this run's data needs: one multiply-add per int8 dim each
    # (query, row) pair consumed before it retired (stats column 0) and per
    # fp dim stage 2 consumed (column 1), in float32 outside the tensor
    # cores (TF32 would not keep the distances exact).
    int8_ops = 2.0 * float(st[:, 0].sum())
    fp32_ops = 2.0 * float(st[:, 1].sum())
    ops_s = int8_ops / PEAK_INT8_OPS + fp32_ops / PEAK_FP32_FLOPS
    # Bytes: codes and ids once, the queries and their tables, the fp slabs
    # at least one query tile needed (the largest per-tile count bounds the
    # distinct slabs from below), and the outputs.
    slab_bytes = float(st[::bq, 4].max()) * bc * bd * srv.rows.element_size()
    in_bytes = (n * dim + 4 * n + qn * dim * 5 + qn * (dim // bd) * 4 + qn * 4
                + slab_bytes)
    out_bytes = qn * svc.k * 8 + qn * 6 * 4
    bytes_s = (in_bytes + out_bytes) / PEAK_BYTES
    entry = {
        "name": "ivf_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ivf_scan.cu",
        "replaces": "src/repro/kernels/ivf_scan.py:451",
        "launches": ivf_launches + serve_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": library_ms,
    }
    log(f"kernels: ivf_scan launches={entry['launches']} (ivf={ivf_launches} "
        f"serve={serve_launches}) max_abs_err={max_err:.3e} "
        f"ms={ms:.3f} plain_ms={plain_ms:.1f} bound_ms={entry['bound_ms']:.4f} "
        f"({entry['bound_by']}) library_ms(_int_mm {qn}x{n}x{dim})={library_ms:.3f} "
        f"on {card}; phases 2-5 took {time.perf_counter() - t_start:.0f}s")
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.dade_ivf import CONFIG
    from repro_torch.kernels import ivf_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib, ptxas = ivf_scan.build()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    res = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
    log(f"build: ok {lib.name} in {time.perf_counter() - t0:.1f}s; ptxas: {' | '.join(res)}")
    log(card)

    entry = run(CONFIG, n_clusters=1024, n_queries=1024, slice_rows=65536,
                   slice_queries=64, card=card)
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
