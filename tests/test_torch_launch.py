"""The port's launch tooling (``repro_torch.launch.{op_census, roofline,
dryrun, perf, report}``) against the reference's (``repro.launch.{
hlo_census, roofline, dryrun, perf, report}``), and the package-level names.

  * ``param_count`` / ``model_flops`` equal the reference's for every
    architecture and shape; ``roofline.analyse(rec, chip=TPU_V5E)`` equals
    the reference's ``analyse`` on the same records, and ``report``'s rows
    equal its rows (the one column the port defines anew excepted);
  * the op census on meta counts a Python loop of matmuls as the
    reference's HLO census counts the same scan; on reduced dense, SSM
    and MoE prefill and train cells its FLOPs equal the reference's census
    of the compiled step, but for two products each named where it
    differs;
  * the dry run's ``argument_bytes`` and ``alias_bytes`` equal XLA's
    ``memory_analysis()`` on a (data 2, model 2) layout, its ``temp_bytes``
    hold the rank's model pieces once, and a full-config cell runs on meta;
  * ``ivf_scan.work`` against the arithmetic it replaced, the kernel
    wrapper's meta path and its report to a census;
  * the CLIs, and every name of the reference's four package ``__all__``.

The reference's compiled steps run in one subprocess (4 XLA host devices),
started by the module fixture and read by the tests that need it, while
the port's side runs here on one torch thread.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_census as j_census  # noqa: E402
from repro.launch import report as j_report  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.launch.specs import SHAPES as J_SHAPES  # noqa: E402
from repro.launch.specs import cell_is_runnable as j_runnable  # noqa: E402
from repro_torch.configs import LM_ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, local_shape  # noqa: E402
from repro_torch.kernels import ivf_scan  # noqa: E402
from repro_torch.launch import dryrun, op_census, perf, report, roofline, specs, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (4)'s cut shapes (both packages'), and its and (5)'s architectures
SMALL = {"train_4k": ("train", 64, 4), "prefill_32k": ("prefill", 64, 2)}
FLOP_ARCHS = ["gemma-2b", "mamba2-130m", "mixtral-8x7b", "qwen2-moe-a2.7b"]
MEM_ARCHS = ["gemma-2b", "mixtral-8x7b", "mamba2-130m"]

_REF = textwrap.dedent("""
    import os
    import sys
    # LLVM's backend optimizations off: the compile takes half the time
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    import json
    import jax
    import numpy as np
    import repro.launch.specs as jspecs
    import repro.launch.steps as jsteps
    from repro.configs import reduced_config
    from repro.launch.hlo_census import census
    from repro.launch.mesh import make_mesh_compat

    part, small, archs = json.loads(sys.argv[1])
    jsteps.get_config = reduced_config
    out = {}

    def compiled(cell, mesh):
        donate = {"train": (0, 1), "decode": (2,), "prefill": ()}[cell.kind]
        kw = {}
        if cell.out_shardings is not None:
            kw["out_shardings"] = cell.out_shardings
        with jax.set_mesh(mesh):
            return jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                           donate_argnums=donate, **kw).lower(*cell.args).compile()

    if part == "memory":  # (5) at the cells' own shapes, on a (data 2, model 2) layout
        mesh = make_mesh_compat((2, 2), ("data", "model"))
        for arch in archs:
            for shape in ("train_4k", "decode_32k"):
                m = compiled(jsteps.build_cell(arch, shape, mesh), mesh).memory_analysis()
                out[f"{arch}/{shape}"] = [m.argument_size_in_bytes, m.alias_size_in_bytes]
    else:  # (4) at cut shapes, on one device
        for name, (kind, seq, b) in small.items():
            jspecs.SHAPES[name] = jspecs.ShapeSpec(name, kind, seq, b)
        one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                ("data", "model"))
        for arch in archs:
            for shape in small:
                comp = compiled(jsteps.build_cell(arch, shape, one), one)
                out[f"{arch}/{shape}"] = census(comp.as_text())["flops"]
    print(json.dumps(out))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def reference():
    """The reference's compiled steps, in two subprocesses (memory, FLOPs)
    started with the module; the tests that read them come last."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", _REF, json.dumps([part, SMALL, archs])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part, archs in (("memory", MEM_ARCHS), ("flops", FLOP_ARCHS))}
    box = {}

    def result(part):
        if part not in box:
            proc = procs[part]
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
                proc.wait()
            assert proc.returncode == 0, err[-4000:]
            box[part] = json.loads(out.strip().splitlines()[-1])
        return box[part]

    yield result
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.fixture
def small_shapes(monkeypatch):
    for name, (kind, seq, b) in SMALL.items():
        monkeypatch.setitem(specs.SHAPES, name, specs.ShapeSpec(name, kind, seq, b))
    monkeypatch.setattr(steps, "get_config", reduced_config)


# ---- (1) param_count and model_flops ---------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_count_and_model_flops_equal_reference(arch):
    assert roofline.param_count(arch) == j_roofline.param_count(arch)
    for shape in J_SHAPES:
        assert roofline.model_flops(arch, shape) == j_roofline.model_flops(arch, shape)


# ---- (2) analyse and the report's tables -----------------------------------

def _records():
    base = dict(mesh="pod16x16", devices=256, status="ok", compile_s=12.5,
                memory=dict(argument_bytes=3 << 30, output_bytes=1 << 30,
                            temp_bytes=5 << 30, alias_bytes=1 << 29),
                collectives=dict(total_bytes=7.5e9, bytes_by_kind={}, count_by_kind={}))
    return [
        dict(base, arch="gemma-2b", shape="train_4k", kind="train",
             cost=dict(flops=1.5e15, bytes_accessed=2e12),
             census=dict(flops=4.2e15, bytes=3.1e12, collective_bytes=9.9e9)),
        dict(base, arch="mixtral-8x7b", shape="decode_32k", kind="decode",
             cost=dict(flops=3e11, bytes_accessed=9e11),
             census=dict(error="ValueError: unparsed")),
        dict(base, arch="dade-ivf", shape="search_1m", kind="search",
             cost=dict(flops=1e11, bytes_accessed=4e9),
             census=dict(flops=1.4e11, bytes=4.8e9, collective_bytes=2.6e7)),
        dict(arch="gemma-2b", shape="long_500k", mesh="pod16x16", devices=256,
             status="skipped", reason=j_runnable(get_config("gemma-2b"), "long_500k")[1]),
        dict(arch="zamba2-1.2b", shape="prefill_32k", mesh="pod16x16", status="error",
             error="RuntimeError: boom"),
    ]


def test_analyse_equals_reference_at_its_constants():
    for rec in _records():
        assert roofline.analyse(rec, chip=roofline.TPU_V5E) == j_roofline.analyse(rec), rec


def _rows(table: str) -> list:
    return [ln for ln in table.splitlines() if ln.startswith("| ") and not ln.startswith(
        "| arch")]


def test_report_rows_equal_reference(tmp_path, monkeypatch):
    (tmp_path / "pod16x16").mkdir()
    for i, rec in enumerate(_records()):
        (tmp_path / "pod16x16" / f"r{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(j_roofline, "RESULTS", str(tmp_path))
    got = _rows(report.roofline_table("pod16x16", str(tmp_path), chip=roofline.TPU_V5E))
    assert got == _rows(j_report.roofline_table("pod16x16")) and len(got) == 5
    # the fifth column (the reference's "TPU-adj") is the port's "held" bytes
    got = [r.split(" | ") for r in _rows(report.dryrun_table("pod16x16", str(tmp_path)))]
    ref = [r.split(" | ") for r in _rows(j_report.dryrun_table("pod16x16"))]
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g[:4] + g[5:] == r[:4] + r[5:]


# ---- (3) loops of matmuls -----------------------------------------------------

def test_census_counts_loop_trips():
    """A Python loop of L matmuls on meta: 2·L·B·D·D, as the reference's
    HLO census of the same jitted scan counts."""
    L, B, D = 6, 8, 32

    def step(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    cen = op_census.census(step, torch.empty((L, D, D), device="meta"),
                           torch.empty((B, D), device="meta"))

    def j_step(ws, x):
        x, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
        return x.sum()

    comp = jax.jit(j_step).lower(jax.ShapeDtypeStruct((L, D, D), jnp.float32),
                                 jax.ShapeDtypeStruct((B, D), jnp.float32)).compile()
    assert cen["flops"] == 2 * L * B * D * D == j_census.census(comp.as_text())["flops"]
    assert cen["loops"] == {} and cen["flops_by_class"] == {"fp32": cen["flops"]}


def test_census_nested_loops_multiply():
    L1, L2, B, D = 3, 4, 4, 16

    def step(w, x):
        for _ in range(L1):
            for _ in range(L2):
                x = torch.tanh(x @ w)
        return x.sum()

    cen = op_census.census(step, torch.empty((D, D), device="meta"),
                           torch.empty((B, D), device="meta"))

    def j_step(w, x):
        def outer(x, _):
            x, _ = jax.lax.scan(lambda x, _: (jnp.tanh(x @ w), None), x, None, length=L2)
            return x, None
        x, _ = jax.lax.scan(outer, x, None, length=L1)
        return x.sum()

    comp = jax.jit(j_step).lower(jax.ShapeDtypeStruct((D, D), jnp.float32),
                                 jax.ShapeDtypeStruct((B, D), jnp.float32)).compile()
    assert cen["flops"] == 2 * L1 * L2 * B * D * D == j_census.census(comp.as_text())["flops"]


def test_census_bytes_peak_and_views():
    """Views move nothing; an op counts its operands and output; the peak
    is the largest set of the call's own tensors alive at once."""
    x = torch.empty((4, 256), device="meta")

    def step(x):
        y = x.t().contiguous()  # a view, then a copy: 4 KiB read, 4 KiB written
        z = y * 2.0  # another 4 KiB read and written; y and z alive: 8 KiB
        del y
        return z.sum()

    cen = op_census.census(step, x)
    assert "aten.t.default" not in cen["by_op"]
    assert cen["by_op"]["aten.clone.default"]["bytes"] == 8192
    assert cen["by_op"]["aten.mul.Tensor"]["bytes"] == 8192
    assert cen["peak_bytes"] == 8192


def test_census_counts_the_ports_collectives(tmp_path):
    """``distributed.collectives`` calls report to an open census, under
    XLA's kind names and with their output bytes (a one-rank gloo group)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                                world_size=1)
    try:
        n = dist.get_world_size()
        x = torch.ones(8)
        with op_census.Census() as cen:
            collectives.all_reduce(x)
            collectives.all_gather(x)
            collectives.broadcast(x)
        r = cen.result()
        collectives.all_reduce(x)  # no census open: nothing counted, nothing raised
    finally:
        if own:
            dist.destroy_process_group()
    assert r["coll_by_kind"] == {"all-reduce": 32, "all-gather": 32 * n,
                                 "collective-broadcast": 32}
    assert r["coll_count_by_kind"] == {"all-reduce": 1, "all-gather": 1,
                                       "collective-broadcast": 1}
    assert r["collective_bytes"] == 64 + 32 * n


# ---- (4) the census on meta and on the CPU ---------------------------------

def _cell_flops(arch, shape, device):
    cell = steps.build_cell(arch, shape, device="meta" if device == "meta" else "cpu")
    if device == "meta":
        return op_census.census(cell.step_fn, *cell.args)["flops"]
    return perf.run(arch, shape, device="cpu", cell=cell, rows=SMALL[shape][2],
                    quiet=True)["census"]["flops"]


def test_moe_train_census_flops_equal_on_meta_and_cpu(small_shapes):
    """A reduced MoE train step (``torch.bincount``'s counts now summed by
    ``scatter_add_``, which runs on meta) counts the same FLOPs on meta as on
    the CPU, which widens the attention products (same operations)."""
    assert (_cell_flops("mixtral-8x7b", "train_4k", "meta")
            == _cell_flops("mixtral-8x7b", "train_4k", "cpu"))


# ---- (6) the dry run at full config ----------------------------------------

def test_dryrun_full_config_cell_is_ok_and_skips_carry_reference_reason():
    mesh = make_production_mesh()
    rec = dryrun.run_cell("gemma-2b", "train_4k", mesh, "pod16x16")
    assert rec["status"] == "ok" and rec["kind"] == "train" and rec["devices"] == 256
    m = rec["memory"]
    cell = steps.build_cell("gemma-2b", "train_4k", mesh=mesh, device="meta")
    assert m["argument_bytes"] == sum(
        dryrun.spec_bytes(t, sh.spec, mesh) for t, sh in dryrun._pairs(
            dryrun.step_args(cell), cell.in_shardings))
    assert 0 < m["alias_bytes"] < m["argument_bytes"] and m["temp_bytes"] > 0
    # one (data, model) rank's step: its model pieces fit the card where a
    # data rank's whole-width step did not (103.2 GB)
    assert "(data, model) rank" in rec["temp_basis"] and m["temp_bytes"] < 80e9
    coll = rec["collectives"]
    assert "rank's step moves" in coll["basis"]
    assert coll["bytes_by_kind"]["all-gather"] > 0 and coll["count_by_kind"]["all-reduce"] > 0
    n_params = sum(p.numel() for p in cell.model.parameters())
    # the census's FLOPs exceed 6·N·D (attention, remat's recomputed forward)
    assert rec["census"]["step_flops"] > 6 * n_params * 256 * 4096
    assert rec["cost"]["flops"] == rec["census"]["step_flops"] / 256
    skip = dryrun.run_cell("codeqwen1.5-7b", "long_500k", mesh, "pod16x16")
    assert skip["status"] == "skipped"
    assert skip["reason"] == j_runnable(get_config("codeqwen1.5-7b"), "long_500k")[1]
    # the search cell: one rank's step, its kernel's least work kept by name
    from repro_torch.configs.dade_ivf import CONFIG as svc
    rec = dryrun.run_cell("dade-ivf", "search_1m", mesh)
    kern = rec["census"]["kernels"]["ivf_scan"]
    assert rec["status"] == "ok" and kern["count"] == 1
    assert kern["ops_by_class"] == {
        "int8": 2.0 * svc.query_batch * svc.corpus_per_device * svc.delta_d, "fp32": 0.0}
    assert rec["memory"]["argument_bytes"] == (
        svc.corpus_per_device * svc.dim * 3  # bf16 rows and int8 codes, a rank's share
        + svc.query_batch * svc.dim * 2 + 4 * (svc.dim // svc.delta_d) * 4)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_temp_bytes_hold_the_rank_model_pieces_once(shape):
    """A reduced cell on a (data 2, model 2) layout: ``temp_bytes`` is the
    census's peak of the rank's step (one ``RankView`` rank's) plus, once,
    the bytes of the rank's model pieces whole along "data" (the train
    step all-gathers them; a serving rank keeps them), computed here from
    ``local_shape`` of each parameter's spec cut to its model-axis
    entries."""
    import dataclasses
    import math

    mesh = AbstractMesh((2, 2), ("data", "model"))
    cfgset = dataclasses.asdict(reduced_config("gemma-2b"))
    cfgset.pop("arch_id")
    rec = dryrun.run_cell("gemma-2b", shape, mesh, cfgset=cfgset)
    cell = steps.build_cell("gemma-2b", shape, mesh=mesh, device="meta", cfgset=cfgset)
    rank, _ = dryrun.rank_step(cell, mesh)
    want, data_split = 0, 0
    for name, p in cell.model.named_parameters():
        spec = cell.in_shardings[0][name].spec
        data_split += any(part and "data" in part for part in spec)
        whole_along_data = tuple(("model",) if part and "model" in part else None
                                 for part in spec)
        want += math.prod(local_shape(tuple(p.shape), whole_along_data, mesh)) * p.element_size()
    assert data_split > 0  # the pieces differ from the arguments' FSDP pieces
    m = rec["memory"]
    assert m["model_piece_bytes"] == want
    assert m["temp_bytes"] == rank["peak_bytes"] + want
    assert "model_piece_bytes" in rec["temp_basis"]


# ---- (7) ivf_scan.work and the wrapper's meta path -------------------------

def _phase5_arithmetic(st, *, qn, n, dim, k, bq, bc, bd, row_bytes):
    """The arithmetic ``chip_smoke.py``'s phase 5 ran inline before
    ``ivf_scan.work``: (int8 ops, fp32 ops, bytes)."""
    st = st.double()
    int8_ops = 2.0 * float(st[:, 0].sum())
    fp32_ops = 2.0 * float(st[:, 1].sum())
    slab_bytes = float(st[::bq, 4].max()) * bc * bd * row_bytes
    in_bytes = (n * dim + 4 * n + qn * dim * 5 + qn * (dim // bd) * 4 + qn * 4
                + slab_bytes)
    out_bytes = qn * k * 8 + qn * 6 * 4
    return int8_ops, fp32_ops, in_bytes + out_bytes


def test_work_is_phase5_arithmetic_and_least_bounds_realised():
    g = torch.Generator().manual_seed(3)
    st = torch.randint(0, 4096, (64, 6), generator=g).float()
    kw = dict(qn=64, n=1 << 16, dim=256, k=100, bq=16, bc=128, bd=64, row_bytes=2)
    w = ivf_scan.work(queries=64, rows=1 << 16, dim=256, k=100, block_q=16, block_d=64,
                      row_bytes=2, stats=st)
    assert (w["int8_ops"], w["fp32_ops"], w["bytes"]) == _phase5_arithmetic(st, **kw)

    # the plain version's stats on the flat route's inputs at a small size
    from repro_torch.configs.dade_ivf import reduced
    from repro_torch.launch import annservice, serve

    svc = reduced()
    srv = serve.prepare_service(svc, "dade", "cpu")
    from repro_torch.data.pipeline import synthetic_queries
    qs = srv.prep(synthetic_queries(svc.query_batch, svc.dim, srv.corpus, seed=5))
    r0 = annservice.seed_rsq(svc, srv.rows, qs, srv.eps, segments=2)
    args, kwargs = annservice.fused_scan_inputs(svc, srv.rows, srv.codes, srv.bscales, qs,
                                                srv.eps, srv.scale, r0)
    _, _, stats = ivf_scan.ivf_scan_plain(*args, **kwargs, segments=2)
    shape = dict(queries=qs.shape[0], rows=srv.rows.shape[0], dim=qs.shape[1], k=svc.k,
                 block_q=kwargs["block_q"], block_d=svc.delta_d,
                 row_bytes=srv.rows.element_size())
    real, least = ivf_scan.work(**shape, stats=stats), ivf_scan.work(**shape)
    assert least["int8_ops"] <= real["int8_ops"] and least["bytes"] <= real["bytes"]
    assert least["fp32_ops"] == 0 < real["fp32_ops"]

    # on meta the wrapper launches nothing, returns the shapes and reports
    # the least work to an open census; the same call on the CPU reports
    # nothing (the census sees the plain version's own ops)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    before = ivf_scan.ivf_scan_kernel_call.launches
    with op_census.Census() as cen:
        sq, ids, st_m = ivf_scan.ivf_scan_kernel_call(*meta, **kwargs, segments=2)
    assert ivf_scan.ivf_scan_kernel_call.launches == before
    assert (sq.shape, ids.dtype, st_m.shape) == ((qs.shape[0], svc.k), torch.int32,
                                                 (qs.shape[0], 6))
    row = cen.result()["by_op"]["ivf_scan"]
    assert row["ops_by_class"] == {"int8": least["int8_ops"], "fp32": 0.0}
    assert row["bytes"] == least["bytes"] and row["count"] == 1
    with op_census.Census() as cen:
        ivf_scan.ivf_scan_kernel_call(*args, **kwargs, segments=2)
    assert "ivf_scan" not in cen.result()["by_op"]


def test_search_step_runs_on_meta():
    """The flat route's step (seeds, inputs, the scan) on meta tensors."""
    from repro_torch.configs.dade_ivf import reduced
    from repro_torch.launch import annservice

    svc = reduced()
    mesh = AbstractMesh((2, 2), ("data", "model"))
    specs_ = annservice.search_input_specs(svc, mesh, quant="int8", fused=True)
    local = [torch.empty((svc.corpus_per_device, *s.shape[1:]) if s.placements[0].is_shard()
                         else s.shape, dtype=s.dtype, device="meta") for s in specs_]
    cen = op_census.census(annservice.build_search_step(svc), *local)
    assert cen["by_op"]["ivf_scan"]["count"] == 1
    assert cen["flops_by_class"]["int8"] == 2.0 * svc.query_batch * svc.corpus_per_device \
        * svc.delta_d


# ---- (8) the CLIs --------------------------------------------------------------

def test_clis_exit_zero(tmp_path, capsys):
    res = str(tmp_path)
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--single-only",
                        "--results", res]) == 0
    rec = json.loads((tmp_path / "pod16x16" / "gemma-2b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and not (tmp_path / "pod2x16x16" / "x.json").exists()
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--single-only",
                        "--results", res]) == 0  # resumed from the record
    roofline.main(["--md", "--results", res])
    report.main(["--results", res])
    out = capsys.readouterr().out
    assert "[cached] pod16x16 gemma-2b decode_32k" in out
    assert "| gemma-2b | decode_32k |" in out and "H100" in out
    with pytest.raises(SystemExit):
        perf.main(["--arch", "dade-ivf", "--shape", "search_1m", "--no-two-phase"])


# ---- (9) the package-level names -------------------------------------------

@pytest.mark.parametrize("pkg", ["core", "quant", "index", "kernels"])
def test_reference_package_names_import_from_the_port(pkg):
    import ast
    import importlib

    tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py").read_text())
    names = [e.value for node in tree.body if isinstance(node, ast.Assign)
             and node.targets[0].id == "__all__" for e in node.value.elts]
    port = importlib.import_module(f"repro_torch.{pkg}")
    wanted = [n for n in names if n not in ("on_tpu", "min_block_q")]
    assert sorted(port.__all__) == sorted(wanted)
    for n in wanted:
        assert getattr(port, n) is not None, n


# ---- (4), (5): against the reference's compiled steps (read last) ------------

@pytest.mark.parametrize("arch", FLOP_ARCHS)
@pytest.mark.parametrize("shape", list(SMALL))
def test_census_flops_equal_reference_hlo_census(reference, small_shapes, arch, shape):
    got = _cell_flops(arch, shape, "meta")
    ref = reference("flops")[f"{arch}/{shape}"]
    cfg = reduced_config(arch)
    tokens = SMALL[shape][1] * SMALL[shape][2]
    if (arch, shape) == ("mamba2-130m", "train_4k"):
        # The backward of the SSD's three-operand einsums: the gradient of
        # each small (B, C, K, H) operand (dt, the decays) contracts the head
        # dim P.  XLA emits four of them a layer as batched dots (dot_general
        # over P); PyTorch's einsum backward as a broadcast multiply and a
        # sum, which holds no product the census (or FlopCounterMode) counts.
        p = cfg.d_inner // cfg.ssm_heads
        assert ref - got == cfg.num_layers * 4 * 2 * tokens * cfg.ssm_heads * p
    elif (arch, shape) == ("qwen2-moe-a2.7b", "train_4k"):
        # The shared experts' gate, x @ w (d_model, 1): its input gradient is
        # an outer product (contracted dim 1), which XLA's simplifier turns
        # into a broadcast multiply and autograd runs as an mm.
        assert got - ref == cfg.num_layers * 2 * tokens * cfg.d_model
    else:
        assert got == ref


@pytest.mark.parametrize("arch", MEM_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_and_alias_bytes_equal_memory_analysis(reference, monkeypatch, arch, shape):
    monkeypatch.setattr(steps, "get_config", reduced_config)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    cell = steps.build_cell(arch, shape, mesh=mesh, device="meta")
    mem = dryrun.memory(cell, mesh)
    args_b, alias_b = reference("memory")[f"{arch}/{shape}"]
    # jax.jit drops an argument the step never reads (keep_unused=False): an
    # SSM's decode ignores ``pos`` (a 4-byte int32 scalar), which the port's
    # step still takes
    unused = 4 if (shape == "decode_32k" and get_config(arch).family == "ssm") else 0
    assert mem["argument_bytes"] == args_b + unused
    assert mem["alias_bytes"] == alias_b
