"""Build the CUDA kernels with `nvcc` on first use and load them with ctypes.

Each source under `csrc/` is compiled on its own into a plain-C shared
library (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`) in the repository's `build/kernels/` directory. The
library name carries a hash of the source and of the headers beside it
(`csrc/*.cuh`, which the sources include), so an edited source or header
is rebuilt and a stale library is never loaded. `build_all()` starts one
`nvcc` per source at once and waits for all of them. A failed build raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fastmax_causal", "fastmax_causal_bwd", "fastmax_decode",
           "fastmax_noncausal")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
# ptxas resource report (registers, shared memory, spills) per source
PTXAS_REPORT: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns {name: path}."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {n: _lib_path(n) for n in names}
        todo = {n: p for n, p in paths.items() if not p.exists()}
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            PTXAS_REPORT[n] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}")
                continue
            os.replace(tmp, todo[n])
        if errors:
            raise RuntimeError("\n".join(errors))
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _LIBS[name] = lib
    return lib
