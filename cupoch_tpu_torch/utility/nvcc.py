"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with
`nvcc` into `_build/lib<name>-<hash>.so` inside the package, at first
use; the hash of the source and of the shared headers (`csrc/*.cuh`)
names the library, so an edited source or header builds anew. `build_all` starts one `nvcc` per source, all at once.
Nothing here runs at import: the CPU tests import every module on a
machine with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional

from . import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / shared-memory report) per source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by the hash of its source and of every
    shared header under `csrc/` (`*.cuh`)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every `csrc/*.cu`) that are
    not built yet, one `nvcc` process each, all started together.
    Returns {name: library path}; raises with the compiler's output
    if any build fails."""
    names = _sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    paths = {}
    for name in names:
        path = paths[name] = _lib_path(name)
        if os.path.exists(path):
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with trace.span("kernel.load", kernel=name):
            built = not os.path.exists(_lib_path(name))
            lib = _loaded[name] = ctypes.CDLL(build_all([name])[name])
            trace.set_attrs(built=built)
        if built:
            trace.count("kernel.builds")
    return lib
