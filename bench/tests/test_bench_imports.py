"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import importlib.util
import subprocess
import sys

from bench import manifest

INDEPENDENT = ("reference.py", "judge.py", "data.py", "stats.py", "work.py", "tracefile.py")

def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run", manifest.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_nothing_loads_jax():
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("bench_run", {str(manifest.BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run.use_checkout()
from bench import harness, loadgen, manifest, readers, service, tracefile
m = manifest.load()
for e in m["end_to_end"] + m["per_layer"]:
    manifest.reader(e["name"])
for w in m["workloads"]:
    manifest.cell(w["name"], m)
from repro_torch.kernels import ivf_scan
from repro_torch.runtime import scheduler
found = run.forbidden_modules()
assert found == [], found
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_bench_guard_compares_whole_top_level_names():
    run = _run_module()
    names = ["repro_torch", "repro_torch.kernels", "reprox", "jaxtyping", "repro.core",
             "jax", "jaxlib.xla", "flax.linen", "numpy"]
    assert run.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib.xla", "repro.core"]


def test_bench_reference_imports_nothing_of_the_program():
    for name in INDEPENDENT:
        mods = set()
        for node in ast.walk(ast.parse((manifest.BENCH / name).read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, (name, mods)
    code = (f"import sys; sys.path.insert(0, {str(manifest.ROOT)!r}); "
            "import bench.reference, bench.judge, bench.data; "
            "assert not [n for n in sys.modules if n.split('.')[0] == 'repro_torch']")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
