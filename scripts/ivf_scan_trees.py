#!/usr/bin/env python3
"""Kernels of another tree, run beside this tree's: the flat route's
``ivf_scan`` and the flat DCO screens.

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 scripts/ivf_scan_trees.py ab build/other
    python3 scripts/ivf_scan_trees.py dense-clocks build/other   # <commit> f95b08e
    python3 scripts/ivf_scan_trees.py screens-ab build/other
    python3 scripts/ivf_scan_trees.py screen-clocks .            # or another tree

Every mode builds the other tree's kernel with this tree's compiler flags
into the ignored ``src/repro_torch/kernels/build/``.  ``ab`` and
``dense-clocks`` run on the inputs of ``chip_smoke.py``'s phase 5: 1024
queries over the 2^20 x 256 ``dade_ivf`` corpus; ``screens-ab`` and
``screen-clocks`` on those of its phase 10.  Each prints the card's name and power limit first.
Needs one CUDA card and ``nvcc``.

``ab``: the served ``ivf_scan`` (16-query tiles in 4 segments, seeded as
the served step seeds them) of both trees through this tree's binding
(``ivf_scan_launch`` keeps one C interface), in rounds of other, this,
this, other; each run is the median of 5 launches timed with CUDA events,
and every run's outputs must equal the first's bit for bit.  Prints each
run and each library's median over its runs.

``dense-clocks``: commit f95b08e holds the dense walk of
``csrc/scan_walk.cuh``: one CTA per 8-query tile, in which every thread
screens its share of all 8 x 128 pairs of a candidate tile at every step,
whether or not they have retired.  The pair-list walk that replaced it
keeps a timing build (``csrc/ivf_scan_clocks.cu``); the dense walk has
none, so this mode stamps the dense walk's phases with ``clock64()`` at the
same boundaries (the tile wait, stage 1, the stage-1 votes, stage 2's slab
round trips and products, the duplicate scan, the merge, the rest) and
runs it as one walk of 8-query tiles (128 CTAs x 8,192 steps).  Its output
is held against the served kernel's at the same configuration, bit for
bit, and then the pair-list walk's timing build runs at that configuration
and as served.  Each run prints cycles per step and each phase's share of
the cycles.

``screens-ab``: ``dade_dco`` and ``quant_dco`` of both trees (both keep the
C interface ``<name>_launch``) at the flat screen's shape: ``build_flat``
(DADE, Δd = 64, p_s = 0.02, int8) of the 2^20 x 256 corpus, 1024 queries,
r² the squared 100th exact distance.  Per kernel, rounds of other, this,
this, other; each run is the median of 5 launches timed with CUDA events,
and every run's (est, flag, dims) must equal the first run's bit for bit.
Prints each run and each library's median over its runs.

``screen-clocks``: where a screen's time goes, from text edits of the
tree's ``csrc/dco_screen.cuh`` (each anchor must occur once).  A timing
build stamps ``clock64()`` at the phase boundaries of each CTA (the dense
blocks; the checkpoints with their stores, the survivor count and the list
build; the list) and prints thread 0's cycles per CTA; three diagnostic
builds each drop one part (the output stores, the list blocks, the
products), so their outputs are wrong by design and only their times
count.  All five builds of each kernel are timed in two rounds, the second
in reverse order (median of 5 launches each).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 4


def bind(path: Path) -> ctypes.CDLL:
    """``path``'s ``ivf_scan_launch`` and ``ivf_scan_smem_bytes``, typed as
    ``ivf_scan._lib`` types them."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ivf_scan_launch.argtypes = [i] + [p] * 8 + [p, i] + [p] * 8 + [i] * 6 + [
        ctypes.c_float, p]
    lib.ivf_scan_launch.restype = i
    lib.ivf_scan_smem_bytes.argtypes = [i] * 6
    lib.ivf_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def build_other(tree: Path, name: str = "ivf_scan") -> Path:
    from repro_torch.kernels import _build

    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    out = _build.CSRC.parent / "build" / f"{name}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(name), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"ivf_scan_trees: nvcc failed on {src}:\n{proc.stderr}")
    return out


PHASES = ("tile_wait", "stage1", "votes", "slab_wait", "stage2", "dup_scan",
          "merge", "other")

_PHASE_CLOCK = """
// Phase clocks: every thread reads clock64() at each boundary and adds the
// cycles since its last stamp to that phase; thread 0's sums are stored.
enum Phase { kTileWait, kStage1, kVotes, kSlabWait, kStage2, kDupScan, kMerge,
             kOther, kPhases };
struct PhaseClock {
  long long sum[kPhases];
  long long t;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < kPhases; ++p) sum[p] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void lap(int p) {
    const long long now = clock64();
    sum[p] += now - t;
    t = now;
  }
  __device__ __forceinline__ void store(long long* out) const {
    if (threadIdx.x == 0)
      for (int p = 0; p < kPhases; ++p) out[static_cast<size_t>(blockIdx.x) * kPhases + p] = sum[p];
  }
};
"""

# (text of the dense walk, its stamped replacement); each text occurs once.
_STAMPS = (
    ("  float one_minus_slack;\n};\n",
     "  float one_minus_slack;\n  long long* clocks;\n};\n" + _PHASE_CLOCK),
    ("  if (a.steps > 0 && offs[0] >= 0) issue_tile<BC>(a, codes_buf, offs[0]);\n",
     "  if (a.steps > 0 && offs[0] >= 0) issue_tile<BC>(a, codes_buf, offs[0]);\n"
     "  PhaseClock clk;\n  clk.start();\n"),
    ("    const int off = offs[step];\n",
     "    clk.lap(kOther);\n    const int off = offs[step];\n"),
    ("    last = resident;\n", "    clk.lap(kTileWait);\n    last = resident;\n"),
    ("      nvalid_acc += __syncthreads_count(g == 0 && valid);\n",
     "      clk.lap(kStage1);\n      nvalid_acc += __syncthreads_count(g == 0 && valid);\n"),
    ("      const bool alive = __syncthreads_or(mine) != 0;\n",
     "      const bool alive = __syncthreads_or(mine) != 0;\n      clk.lap(kVotes);\n"),
    ("          if (!__syncthreads_or(need)) break;\n",
     "          const bool any_need = __syncthreads_or(need) != 0;\n"
     "          clk.lap(kSlabWait);\n          if (!any_need) break;\n"),
    ("          ++slabs_acc;\n", "          clk.lap(kSlabWait);\n          ++slabs_acc;\n"),
    ("              a2[j] = false;\n          }\n        }\n",
     "              a2[j] = false;\n          }\n          clk.lap(kStage2);\n        }\n"),
    ("          cand_s[r * BC + c] = v;\n        }\n",
     "          cand_s[r * BC + c] = v;\n        }\n        clk.lap(kDupScan);\n"),
    ("          window_sorted = true;\n          __syncthreads();\n        }\n",
     "          window_sorted = true;\n          __syncthreads();\n        }\n"
     "        clk.lap(kMerge);\n"),
    ("    if (prefetched) cur = 1 - cur;\n  }\n",
     "    if (prefetched) cur = 1 - cur;\n  }\n  clk.lap(kOther);\n  clk.store(a.clocks);\n"),
)

_LAUNCHER = r"""
#include "scan_walk.cuh"

namespace {
__global__ void __launch_bounds__(dade::kThreads) dense_clocks_kernel(const dade::WalkArgs a) {
  dade::scan_walk<128>(a);
}
}  // namespace

extern "C" int dense_clocks_launch(
    int device, const int* offs, const int8_t* qcodes, const float* q,
    const float* qscales, const float* r0, const float* top0_sq,
    const int* top0_ids, const int8_t* codes, const void* rows, int rows_bf16,
    const int* ids, const float* bscales, const float* eps, const float* scale,
    float* top_sq, int* top_ids, float* stats, long long* clocks, int q_tiles,
    int steps, int D, int K, int BD, float one_minus_slack, void* stream) {
  const dade::WalkArgs a{offs, qcodes, q, qscales, r0, top0_sq, top0_ids,
                         codes, rows, ids, bscales, eps, scale, top_sq,
                         top_ids, stats, nullptr, nullptr, steps, D, D / BD, K,
                         BD, rows_bf16, K - 1, 1, 0, 0, one_minus_slack, clocks};
  return dade::launch_walk<128>(dense_clocks_kernel, device, a, q_tiles, stream);
}
"""


def stamp(walk: str) -> str:
    """The dense walk's source with its phase stamps; raises if the source
    is not the dense walk's (each anchor must occur exactly once)."""
    for old, new in _STAMPS:
        if walk.count(old) != 1:
            raise SystemExit(f"ivf_scan_trees: anchor found {walk.count(old)} "
                             f"times, need 1 (not the dense walk?):\n{old}")
        walk = walk.replace(old, new)
    return walk


def build_dense(tree: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    out = _build.CSRC.parent / "build" / "dense_walk_clocks"
    out.mkdir(parents=True, exist_ok=True)
    (out / "scan_walk.cuh").write_text(stamp((csrc / "scan_walk.cuh").read_text()))
    (out / "tiles.cuh").write_text((csrc / "tiles.cuh").read_text())
    (out / "launch.cu").write_text(_LAUNCHER)
    lib = out / "dense_walk_clocks.so"
    cmd = [_build._nvcc("dense walk clocks"), *_build.NVCC_FLAGS, "-o", str(lib),
           str(out / "launch.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"ivf_scan_trees: nvcc failed:\n{proc.stderr}")
    print("build: " + " | ".join(ln.strip() for ln in proc.stderr.splitlines()
                                 if "registers" in ln or "spill" in ln), flush=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.dense_clocks_launch.argtypes = ([i] + [p] * 8 + [p, i] + [p] * 8 + [i] * 5
                                        + [ctypes.c_float, p])
    dll.dense_clocks_launch.restype = i
    return dll


def dense_walk(dll, args, *, k, block_d, slack=1e-4):
    """The dense walk with clocks on the flat route's 8-query inputs: its
    (top_sq, top_ids, stats) and the (q_tiles, 8) phase cycles."""
    import torch

    (tile_offs, qcodes, q, qscales, r0, top0_sq, top0_ids, codes, rows, ids,
     bscales, eps, scale) = args
    qn, dim = q.shape
    q_tiles = qn // 8
    offs = tile_offs.to(torch.int32).reshape(q_tiles, -1).contiguous()
    ins = [t.contiguous() for t in (qcodes, q.float(), qscales.float(), r0.float(),
                                    top0_sq.float(), top0_ids.to(torch.int32), codes)]
    rows = rows.contiguous()
    tail = [t.contiguous() for t in (ids.to(torch.int32), bscales.float(), eps.float(),
                                     scale.float())]
    top_sq = torch.empty((qn, k), dtype=torch.float32, device=q.device)
    top_ids = torch.empty((qn, k), dtype=torch.int32, device=q.device)
    stats = torch.empty((qn, 6), dtype=torch.float32, device=q.device)
    clk = torch.zeros((q_tiles, len(PHASES)), dtype=torch.int64, device=q.device)
    err = dll.dense_clocks_launch(
        q.device.index or 0, offs.data_ptr(), *(t.data_ptr() for t in ins),
        rows.data_ptr(), int(rows.dtype == torch.bfloat16), *(t.data_ptr() for t in tail),
        top_sq.data_ptr(), top_ids.data_ptr(), stats.data_ptr(), clk.data_ptr(),
        q_tiles, offs.shape[1], dim, k, block_d, float(1.0 - slack),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"ivf_scan_trees: launch failed: cudaError {err}")
    return (top_sq, top_ids, stats), clk


def report(name, clk, steps, phases):
    cyc = clk.double()
    total = float(cyc.sum())
    per_step = float(cyc.sum(1).mean()) / steps
    print(f"clocks: {name} {clk.shape[0]} CTAs x {steps} steps: {per_step:.0f} cycles/step; "
          + " ".join(f"{p}={100 * float(cyc[:, i].sum()) / total:.1f}%"
                     for i, p in enumerate(phases)), flush=True)


def run_ab(tree: Path, args, kw) -> None:
    import chip_smoke
    import torch
    from repro_torch.kernels import ivf_scan
    from repro_torch.launch.annservice import SHARDS

    kw = dict(kw, segments=SHARDS)
    libs = {"other": bind(build_other(tree)), "this": bind(ivf_scan.build()[0])}
    first = None
    times = {name: [] for name in libs}
    for rnd in range(ROUNDS):
        for name in ("other", "this", "this", "other"):
            ivf_scan._lib = lambda clocks=False, lib=libs[name]: lib
            ivf_scan.ivf_scan_kernel_call(*args, **kw)  # warm
            ms, out = chip_smoke.cuda_ms(lambda: ivf_scan.ivf_scan_kernel_call(*args, **kw), 5)
            if first is None:
                first = out
            chip_smoke.check(all(torch.equal(a, b) for a, b in zip(out, first)),
                             f"round {rnd}: the {name} library's outputs differ")
            times[name].append(ms)
            print(f"ab: round {rnd} {name} {ms:.3f} ms", flush=True)
    for name, ts in times.items():
        print(f"ab: {name} ({tree if name == 'other' else ROOT}) median "
              f"{statistics.median(ts):.3f} ms over {len(ts)} runs, min {min(ts):.3f}, "
              f"max {max(ts):.3f}; outputs bit for bit equal", flush=True)


def run_dense_clocks(tree: Path, args, kw) -> None:
    import chip_smoke
    import torch
    from repro_torch.kernels import ivf_scan
    from repro_torch.launch.annservice import FUSED_BLOCK_Q, SHARDS

    dll = build_dense(tree)
    qn = args[2].shape[0]

    def inputs(bq):
        return (args[0][:1].expand(qn // bq, -1, -1),) + args[1:], dict(kw, block_q=bq)

    a8, k8 = inputs(8)
    waves, cap = args[0].shape[1], args[0].shape[2]
    out_d, clk = dense_walk(dll, a8, k=k8["k"], block_d=k8["block_d"])
    out_k = ivf_scan.ivf_scan_kernel_call(*a8, **k8)
    torch.cuda.synchronize()
    chip_smoke.agree("dense_walk_bq8_G1_vs_served_kernel", out_d, out_k, 8)
    report("dense walk block_q=8 segments=1", clk, waves * cap, PHASES)
    for bq, g in dict.fromkeys([(8, 1), (FUSED_BLOCK_Q, SHARDS)]):
        a, k = inputs(bq)
        *_, clk = ivf_scan.ivf_scan_phase_clocks(*a, segments=g, **k)
        torch.cuda.synchronize()
        report(f"pair-list walk block_q={bq} segments={g}", clk, -(-waves // g) * cap,
               ivf_scan.PHASES)


def screen_inputs(svc):
    """Phase 10's inputs: the index, rotated queries and r²."""
    import torch
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
    from repro_torch.index.flat import build_flat

    corpus = synthetic_vectors(svc.corpus_per_device, svc.dim, seed=0)
    queries = synthetic_queries(svc.query_batch, svc.dim, corpus, seed=1)
    corpus = torch.as_tensor(corpus, device="cuda")
    idx = build_flat(corpus, method="dade", delta_d=svc.delta_d, p_s=svc.p_s, quant="int8",
                     generator=torch.Generator().manual_seed(0), device="cuda")
    gt_d, _ = exact_knn(queries, corpus, svc.k, device="cuda")
    q_rot = idx.estimator.rotate(torch.as_tensor(queries, device="cuda")).contiguous()
    return idx, q_rot, (gt_d[:, -1] ** 2).contiguous()


def screen_calls(svc) -> dict:
    """The two screens' kernel calls on phase 10's inputs, by name."""
    import torch
    from repro_torch.core.estimators import kernel_spec
    from repro_torch.kernels import dade_dco, quant_dco
    from repro_torch.kernels.tiles import sqrt_rn
    from repro_torch.quant.scalar import cum_err_sq

    idx, q_rot, r_sq = screen_inputs(svc)
    bd, dim = svc.delta_d, svc.dim
    spec = kernel_spec(idx.estimator, dim, bd)
    eps, scale = spec.eps.cuda(), spec.scale.cuda()
    ecum = sqrt_rn(cum_err_sq(idx.qscales, (torch.arange(dim // bd, device="cuda") + 1) * bd))
    return {
        "dade_dco": lambda: dade_dco.dade_dco_kernel_call(q_rot, idx.corpus_rot, eps, scale,
                                                          r_sq, block_d=bd),
        "quant_dco": lambda: quant_dco.quant_dco_kernel_call(
            q_rot, idx.corpus_q, idx.qscales, eps, scale, ecum, r_sq, block_d=bd),
    }


def run_screens_ab(tree: Path, svc) -> None:
    import chip_smoke
    import torch
    from repro_torch.kernels import _screen

    calls = screen_calls(svc)
    cached = _screen._lib
    for name, fn in calls.items():
        libs = {"other": bind_screen(build_other(tree, name), name), "this": cached(name)}
        first, times = None, {k: [] for k in libs}
        for rnd in range(ROUNDS):
            for which in ("other", "this", "this", "other"):
                _screen._lib = lambda _name, lib=libs[which]: lib
                fn()  # warm
                ms, out = chip_smoke.cuda_ms(fn, 5)
                if first is None:
                    first = out
                chip_smoke.check(all(torch.equal(a, b) for a, b in zip(out, first)),
                                 f"{name} round {rnd}: the {which} library's outputs differ")
                del out
                times[which].append(ms)
                print(f"screens-ab: {name} round {rnd} {which} {ms:.3f} ms", flush=True)
        del first
        torch.cuda.empty_cache()
        for which, ts in times.items():
            print(f"screens-ab: {name} {which} ({tree if which == 'other' else ROOT}) median "
                  f"{statistics.median(ts):.3f} ms over {len(ts)} runs, min {min(ts):.3f}, "
                  f"max {max(ts):.3f}; outputs bit for bit equal", flush=True)
    _screen._lib = cached


def bind_screen(path: Path, name: str) -> ctypes.CDLL:
    """``path``'s ``<name>_launch`` and ``<name>_smem_bytes``, typed as
    ``_screen._lib`` types them."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [i] + [p] * 10 + [i] * 4 + [ctypes.c_float, p]
    fn.restype = i
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [i, i]
    smem.restype = ctypes.c_longlong
    return lib


_SCREEN_LIST = "  // ---- the list: each survivor carried through the later blocks ----\n"
_SCREEN_STORE = "        screen_store(on && retire, est_row + 16 * j,"
_SCREEN_WLOOP = "      for (int w = 0; w < kScreenKC; w += 4) {\n        float4 cv[MJ];"
_SCREEN_DROPS = {
    "no stores": ((_SCREEN_STORE, _SCREEN_STORE.replace("on && retire", "false")),),
    "no list": ((_SCREEN_LIST, _SCREEN_LIST + "  if (n_list) return;\n"),),
    "no products": ((_SCREEN_WLOOP, _SCREEN_WLOOP.replace("w < kScreenKC", "w < 0")),),
}
_SCREEN_FLUSH = ("if (tid == 0) { atomicAdd(&g_clk[0], (unsigned long long)clk_d); "
                 "atomicAdd(&g_clk[1], (unsigned long long)clk_c); "
                 "atomicAdd(&g_clk[2], (unsigned long long)clk_l); atomicAdd(&g_clk[3], 1ull); }")
_SCREEN_CLOCKS = (
    ("template <int MODE>\n__device__ __forceinline__ void dco_screen(",
     "__device__ unsigned long long g_clk[4];  // dense, checkpoints, list, CTAs\n"
     "template <int MODE>\n__device__ __forceinline__ void dco_screen("),
    ("  // ---- dense blocks: every pair of the tile, register-tiled ----\n",
     "  // ---- dense blocks: every pair of the tile, register-tiled ----\n"
     "  long long clk_t = clock64(), clk_d = 0, clk_c = 0, clk_l = 0;\n"),
    ("    __syncthreads();  // the block's norms are in; every read of the ring is done\n",
     "    __syncthreads();  // the block's norms are in; every read of the ring is done\n"
     "    { const long long n_ = clock64(); clk_d += n_ - clk_t; clk_t = n_; }\n"),
    ("    if (total == 0) return;  // uniform: every thread read the same count\n",
     "    if (total == 0) { clk_c += clock64() - clk_t; " + _SCREEN_FLUSH + " return; }\n"),
    ("    __syncthreads();  // the list is written; every thread has read the count\n",
     "    __syncthreads();  // the list is written; every thread has read the count\n"
     "    { const long long n_ = clock64(); clk_c += n_ - clk_t; clk_t = n_; }\n"),
    ("    __syncthreads();  // the staging and the sums are free again\n  }\n}\n",
     "    __syncthreads();  // the staging and the sums are free again\n  }\n"
     "  clk_l = clock64() - clk_t;\n  " + _SCREEN_FLUSH + "\n}\n"),
)
_SCREEN_CLOCK_API = """
extern "C" int screen_clocks(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(dade::g_clk, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, dade::g_clk, 4 * sizeof(unsigned long long)));
}
"""


def build_screen_variant(tree: Path, name: str, label: str, edits, api: str = ""):
    """``name`` built from ``tree``'s sources with ``edits`` applied to
    ``dco_screen.cuh`` (and ``api`` appended to its ``.cu``), bound."""
    from repro_torch.kernels import _build

    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    out = _build.CSRC.parent / "build" / "screen_variants" / label.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    text = (csrc / "dco_screen.cuh").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ivf_scan_trees: anchor found {text.count(old)} times, "
                             f"need 1 ({label}):\n{old}")
        text = text.replace(old, new)
    (out / "dco_screen.cuh").write_text(text)
    (out / "tiles.cuh").write_text((csrc / "tiles.cuh").read_text())
    (out / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text() + api)
    lib = out / f"{name}.so"
    proc = subprocess.run([_build._nvcc(name), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{name}.cu")], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"ivf_scan_trees: nvcc failed ({label} {name}):\n{proc.stderr}")
    regs = " | ".join(ln.strip() for ln in proc.stderr.splitlines()
                      if "registers" in ln or "spill" in ln)
    return label, name, bind_screen(lib, name), regs


def run_screen_clocks(tree: Path, svc) -> None:
    import chip_smoke
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _screen

    builds = {"as built": ((), ""), "clocks": (_SCREEN_CLOCKS, _SCREEN_CLOCK_API),
              **{label: (edits, "") for label, edits in _SCREEN_DROPS.items()}}
    with ThreadPoolExecutor(max_workers=2 * len(builds)) as pool:
        jobs = [pool.submit(build_screen_variant, tree, name, label, *spec)
                for name in ("dade_dco", "quant_dco") for label, spec in builds.items()]
        libs = {}
        for job in jobs:
            label, name, lib, regs = job.result()
            libs[name, label] = lib
            print(f"screen-clocks: build {name} {label}: {regs}", flush=True)
    calls = screen_calls(svc)
    cached = _screen._lib
    for name, fn in calls.items():
        lib = libs[name, "clocks"]
        _screen._lib = lambda _name, lib=lib: lib
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 4)()
        lib.screen_clocks(buf, 1)
        fn()
        torch.cuda.synchronize()
        lib.screen_clocks(buf, 0)
        dense, ckpt, lst, ctas = list(buf)
        print(f"screen-clocks: {name} {ctas} CTAs, thread 0's cycles per CTA: dense blocks "
              f"{dense / ctas:.0f}, checkpoints (stores, count, list build) {ckpt / ctas:.0f}, "
              f"list {lst / ctas:.0f}, total {(dense + ckpt + lst) / ctas:.0f}", flush=True)
        times = {label: [] for label in builds}
        for order in (list(builds), list(builds)[::-1]):
            for label in order:
                _screen._lib = lambda _name, lib=libs[name, label]: lib
                fn()
                ms, out = chip_smoke.cuda_ms(fn, 5)
                del out
                times[label].append(ms)
        for label, ts in times.items():
            print(f"screen-clocks: {name} {label}: median {statistics.median(ts):.3f} ms "
                  f"over {len(ts)} runs", flush=True)
        torch.cuda.empty_cache()
    _screen._lib = cached


def main() -> int:
    import torch
    modes = {"ab": run_ab, "dense-clocks": run_dense_clocks, "screens-ab": run_screens_ab,
             "screen-clocks": run_screen_clocks}
    if len(sys.argv) != 3 or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ivf_scan_trees: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[2]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.configs.dade_ivf import CONFIG as svc
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.launch import serve
    from repro_torch.launch.annservice import SHARDS, fused_scan_inputs, seed_rsq

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    if sys.argv[1] in ("screens-ab", "screen-clocks"):
        modes[sys.argv[1]](tree, svc)
        return 0
    srv = serve.prepare_service(svc, "dade", "cuda")
    # phase 5's queries: the same seed; r0 as the served step seeds it for
    # the A/B, from the corpus's first wave for the one-segment dense walk
    qb = srv.prep(synthetic_queries(svc.query_batch, svc.dim, srv.corpus, seed=7))
    segments = SHARDS if sys.argv[1] == "ab" else 1
    r0 = seed_rsq(svc, srv.rows, qb, srv.eps, segments=segments)
    args, kw = fused_scan_inputs(svc, srv.rows, srv.codes, srv.bscales, qb,
                                 srv.eps, srv.scale, r0)
    modes[sys.argv[1]](tree, args, kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
