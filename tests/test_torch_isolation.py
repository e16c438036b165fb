"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX, the reference package or ``ml_dtypes``
(the card's machine has none), its entry points run on the card unless
asked for the CPU, and the kernel wrappers pick their path by the device
of their tensors."""

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.index_io import load_graph_index, load_graph_slab  # noqa: E402
from repro_torch.core.estimators import build_estimator  # noqa: E402
from repro_torch.core.topk import exact_knn  # noqa: E402
from repro_torch.core.transforms import fit_pca  # noqa: E402
from repro_torch.index.flat import build_flat  # noqa: E402
from repro_torch.index.graph import (  # noqa: E402
    build_graph, search_graph_fused, search_graph_sharded)
from repro_torch.index.ivf import build_ivf, search_ivf  # noqa: E402
from repro_torch.index.kmeans import kmeans  # noqa: E402
from repro_torch.index.mutable import MutableGraph  # noqa: E402
from repro_torch.kernels import _screen, graph_scan, ivf_scan, l2_scan, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.annservice import (  # noqa: E402
    build_graph_engine, sharded_graph_engine)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import adamw_state_from_arrays, lm_from_arrays  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path} imports {mod}"


def test_training_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/optim/adamw.py", "src/repro_torch/runtime/fault_tolerance.py",
            "src/repro_torch/launch/train.py"} <= names


def test_launch_tooling_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"src/repro_torch/launch/{m}.py"
            for m in ("op_census", "roofline", "dryrun", "perf", "report")} <= names


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.launch.serve, repro_torch.index.ivf, "
            "repro_torch.index.graph, repro_torch.index.flat, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.kernels.l2_scan, repro_torch.core.dco, "
            "repro_torch.core.topk, repro_torch.quant.screen, repro_torch.obs, "
            "repro_torch.runtime.chaos, repro_torch.runtime.scheduler, "
            "repro_torch.launch.annservice, repro_torch.index.mutable, "
            "repro_torch.checkpoint.manager, repro_torch.checkpoint.index_io, "
            "repro_torch.checkpoint.wal, repro_torch.core.dco_host, repro_torch.configs, "
            "repro_torch.models.model, repro_torch.launch.specs, repro_torch.launch.steps, "
            "repro_torch.optim.adamw, repro_torch.runtime.fault_tolerance, "
            "repro_torch.launch.train, repro_torch.data.pipeline, "
            "repro_torch.launch.op_census, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.launch.perf, repro_torch.launch.report; "
            "from repro_torch.core import *; from repro_torch.quant import *; "
            "from repro_torch.index import *; from repro_torch.kernels import *; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def _cpu_graph(d):
    return build_graph(d, m=4, ef_construction=8, delta_d=16, device="cpu")


def _cpu_ivf(d):
    return build_ivf(d, n_clusters=4, delta_d=16, device="cpu")


def _graph_snapshot(d):
    """A directory holding a graph snapshot written on the CPU."""
    import tempfile

    from repro_torch.checkpoint.index_io import save_graph_index
    path = tempfile.mkdtemp()
    save_graph_index(path, _cpu_graph(d))
    return path


ENTRY_POINTS = [
    (fit_pca, lambda d: fit_pca(d)),
    (build_estimator, lambda d: build_estimator("dade", d)),
    (exact_knn, lambda d: exact_knn(d[:4], d, 2)),
    (kmeans, lambda d: kmeans(d, 4, 2)),
    (build_ivf, lambda d: build_ivf(d, n_clusters=4, delta_d=16)),
    (build_flat, lambda d: build_flat(d, delta_d=16)),
    (build_graph, lambda d: build_graph(d, m=4, ef_construction=8, delta_d=16)),
    (search_graph_fused, lambda d: search_graph_fused(_cpu_graph(d), d)),
    (build_graph_engine, lambda d: build_graph_engine(_cpu_graph(d), k=2)),
    (MutableGraph, lambda d: MutableGraph(d, m=4, ef_construction=8, delta_d=16)),
    (load_graph_index, lambda d: load_graph_index(_graph_snapshot(d))),
    (search_ivf, lambda d: search_ivf(_cpu_ivf(d), d[:4], k=2)),
    (search_graph_sharded, lambda d: search_graph_sharded(_cpu_graph(d), d, num_shards=2)),
    (load_graph_slab, lambda d: load_graph_slab(_graph_snapshot(d), shard=0, num_shards=2)),
    (sharded_graph_engine, lambda d: sharded_graph_engine(
        _cpu_graph(d), _graph_snapshot(d), num_shards=2, backend="gloo", k=2).__enter__()),
    (build_model, lambda d: build_model(reduced_config("gemma2-9b"))),
    (build_cell, lambda d: build_cell("gemma2-9b", "decode_32k")),
    (lm_from_arrays, lambda d: lm_from_arrays(reduced_config("gemma2-9b"), {})),
    (adamw_state_from_arrays, lambda d: adamw_state_from_arrays(
        reduced_config("gemma2-9b"), {"m": {}, "v": {}, "step": 0})),
]


@pytest.mark.parametrize("fn,call", ENTRY_POINTS, ids=lambda x: getattr(x, "__name__", ""))
def test_entry_points_default_to_cuda(fn, call):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return  # on a card the default simply runs there
    data = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        call(data)


def test_train_defaults_to_cuda(tmp_path):
    assert train.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="cuda"):
            build_cell("gemma-2b", "train_4k")


def test_serve_defaults_to_cuda():
    assert serve.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--requests", "1", "--corpus", "2048", "--dim", "64",
                        "--batch", "16", "--k", "10", "--wave", "256", "--delta-d", "16"])


def _tiny_scan_inputs(device):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((256, 32)).astype(np.float32)
    est = build_estimator("fdscanning", rows, device=device)
    from repro_torch.quant.scalar import fit_block_scales, quantize_block
    t = torch.as_tensor(rows, device=device)
    bs = fit_block_scales(t, 16)
    return est, t, quantize_block(t, bs, 16), torch.arange(256, dtype=torch.int32,
                                                            device=device), bs


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    est, rows, codes, ids, bs = _tiny_scan_inputs("cpu")
    before = ivf_scan.ivf_scan_kernel_call.launches
    q = rows[:8] + 0.01
    sq, top, st = ops.ivf_scan_kernel(
        est, q, torch.tensor([[0, 128]]), torch.tensor([[128, 128]]), rows, codes,
        ids, bs, torch.full((8,), float("inf")), k=4, max_bucket=128, block_q=8,
        block_c=128, block_d=16, starts_aligned=True)
    assert ivf_scan.ivf_scan_kernel_call.launches == before
    assert top.shape == (8, 4) and torch.equal(top[:, 0], torch.arange(8, dtype=torch.int32))
    assert st[0, 5] == 2  # two fresh int8 tiles fetched


def test_wrapper_refuses_mixed_devices():
    est, rows, codes, ids, bs = _tiny_scan_inputs("cpu")
    args = [torch.zeros((1, 1, 2), dtype=torch.int32), codes[:8], rows[:8],
            torch.ones((8, 2)), torch.zeros(8), torch.zeros((8, 4)),
            torch.zeros((8, 4), dtype=torch.int32), codes, rows, ids, bs,
            torch.zeros(2), torch.ones(2)]
    args[0] = torch.zeros((1, 1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        ivf_scan.ivf_scan_kernel_call(*args, k=4, block_q=8, block_c=128,
                                      block_d=16, cap_tiles=2)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_gpu_kernel_build_is_lazy():
    """Importing the kernel module builds and loads nothing."""
    assert ivf_scan._lib.cache_info().currsize == 0 or torch.cuda.is_available()


def test_graph_scan_build_is_lazy():
    """Importing the graph kernel's module builds and loads nothing."""
    assert graph_scan._lib.cache_info().currsize == 0 or torch.cuda.is_available()


def test_screen_kernel_builds_are_lazy():
    """Importing the flat screen kernels' modules builds and loads nothing."""
    assert _screen._lib.cache_info().currsize == 0 or torch.cuda.is_available()


def test_l2_scan_build_is_lazy():
    """Importing the l2 scan's module builds and loads nothing."""
    assert l2_scan._lib.cache_info().currsize == 0 or torch.cuda.is_available()
