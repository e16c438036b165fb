"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each kernel is one ``.cu`` file in ``csrc/`` (plus the headers it
includes) compiled into a shared library with a plain C interface, which
its wrapper binds with ``ctypes``.  A library lives in ``build/`` beside
this file, named after its kernel and keyed by a hash of its own sources
and the compiler flags, so an edited source builds anew and an unchanged
one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "CSRC", "library_path", "build"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
# -fmad=false: no multiply-add contraction, so every float operation rounds
# where the plain version's does (bit-exact parity).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(name: str) -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found (PATH or CUDA_HOME): the {name} "
                       f"kernel is built from csrc/ at first use")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """``build/<name>-<hash>.so``, the hash covering ``sources`` (file
    names in ``csrc/``, the ``.cu`` first) and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    return _HERE / "build" / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> tuple[Path, str]:
    """Compile ``sources[0]`` if its library is missing; returns (path, the
    compiler's resource report — empty when the library already existed)."""
    out = library_path(name, sources)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(name), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / sources[0])],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build the {name} kernel "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr
