"""Build the port's CUDA sources into one shared library, bound with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C function. At first use every
source compiles with its own ``nvcc`` (all started at once) into an object
file, and the objects link into ``build/kernels/repro_torch_kernels-<hash>
.so`` under the repository root. The hash covers the sources and the flags,
so an edited source builds anew and an unchanged tree loads what is built.

Processes that start together (the ranks of a world on one card, test
workers) build once: the build holds an exclusive ``fcntl`` lock on
``<library>.lock`` beside the library, and a process that waited for it
finds the library built. Objects and the unlinked library carry the
building process's id until the library is renamed into place. The lock
dies with its process, so a build cut off leaves nothing to clear."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
SOURCES = ("decode_attention", "flash_attention", "rmsnorm", "ssd_scan")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's register / shared-memory report (-Xptxas -v) per compiled source
ptxas_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source (one nvcc each, concurrently) and link them
    into the shared library, unless it is built already."""
    with _lock:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():          # else another process built it
                _compile_and_link(out)
        return out


def _compile_and_link(out: Path) -> None:
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{name}-{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / f"{name}.cu"),
               "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, _, proc in jobs:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in jobs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                           f"{link.stderr}")
    os.replace(tmp, out)
    for _, obj, _ in jobs:
        obj.unlink()


def load() -> ctypes.CDLL:
    """The port's kernel library, built on first use."""
    global _lib
    if _lib is None:
        path = build()
        with _lock:
            if _lib is None:
                _lib = ctypes.CDLL(str(path))
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
