"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

Each ``.cu`` file becomes its own shared library with a plain C interface
(nvcc, ``sm_90a``), built into ``build/torch_kernels/<key>/`` beside the
package, where ``<key>`` hashes the sources and the flags, so an edited
source rebuilds and an unchanged one loads at once. ``build()`` starts one
nvcc per missing library, all together. Nothing is built or loaded when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

SOURCES = {"field": "field_kernel.cu", "tile": "tile_kernel.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_ROOT, _key(), f"lib{name}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every missing library among ``names`` (default: all), one
    nvcc each, all started together. Returns per library its path, whether
    it was built now, the seconds it took and the compiler's log (ptxas
    register and spill report)."""
    names = list(names or SOURCES)
    out_dir = os.path.join(BUILD_ROOT, _key())
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        if os.path.exists(path):
            report[name] = {"path": path, "built": False, "seconds": 0.0,
                            "log": ""}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            for p, _, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, path)
        report[name] = {"path": path, "built": True,
                        "seconds": time.perf_counter() - t0, "log": log}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(lib_path(name))
        lib.pienerf_error_string.restype = ctypes.c_char_p
        lib.pienerf_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.pienerf_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
