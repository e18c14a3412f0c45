"""Build the port's CUDA kernels from the repo's sources at first use.

Each kernel is one `.cu` file under `cake_tpu_torch/csrc/` with a plain C
entry point; shared device helpers are headers there (`*.cuh`). `nvcc`
compiles it for `sm_90a` into a shared library under `build/` at the repo
root (named by the content hash of the source and the headers, so an edit
rebuilds and unchanged sources are reused), and `ctypes` loads it. No
PyTorch headers are included, which keeps a build to seconds.

Nothing here runs at import: the CPU tests import every module of the port
on a host with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

# kernel name -> source file under csrc/
KERNELS = {"flash_attn": "flash_attn.cu",
           "flash_attn_wgmma": "flash_attn_wgmma.cu",
           "paged_decode": "paged_decode.cu",
           "fp8_dequant": "fp8_dequant.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by the hash of its source and of every
    shared header under csrc/ (an edit to either rebuilds)."""
    h = hashlib.sha256((CSRC_DIR / KERNELS[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / KERNELS[name])]


def build_all(names=None) -> dict[str, dict]:
    """Compile the named kernels (all by default) with one `nvcc` each,
    all started together. Returns {name: {"path", "seconds", "log"}} where
    `log` is nvcc's output (ptxas register and shared-memory report).
    Raises with the compiler's output if any build fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            jobs[name] = (out, None, time.perf_counter(), None)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (out, proc, time.perf_counter(), tmp)
    results = {}
    for name, (out, proc, t0, tmp) in jobs.items():
        if proc is None:
            results[name] = {"path": str(out), "seconds": 0.0,
                             "log": "cached"}
            continue
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": secs, "log": log}
    return results


def load_library(name: str, bind) -> ctypes.CDLL:
    """The kernel's loaded library, built first if needed. `bind(lib)`
    declares its C entry points' signatures once, on first load."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _loaded[name] = lib
    return lib
