"""Build and load the CUDA kernels (nvcc into a plain-C shared library,
bound with ctypes).

Each ``csrc/*.cu`` compiles on first use, all sources in parallel, into
``_build/`` beside this file (listed in .gitignore), keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags so an edited
source or header rebuilds.  Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}   # source stem -> nvcc wall seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources=None) -> dict[str, pathlib.Path]:
    """Compile every missing library, one nvcc per source, all started
    together; returns ``{stem: path}``.  Raises with nvcc's output when a
    source does not compile.  ptxas' register/spill report is kept in
    ``<library>.log``."""
    srcs = sorted(CSRC.glob("*.cu")) if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in srcs:
        target = _target(src)
        out[src.stem] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, time.monotonic(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_SECONDS[src.stem] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build([CSRC / f"{stem}.cu"])[stem]
        lib = ctypes.CDLL(str(path))
        _LIBS[stem] = lib
    return lib


def build_log(stem: str) -> str:
    """ptxas' report (registers, shared memory, spills) of a built source."""
    path = _target(CSRC / f"{stem}.cu").with_suffix(".log")
    return path.read_text() if path.exists() else ""
