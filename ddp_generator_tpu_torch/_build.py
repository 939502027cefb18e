"""Build the hand-written CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, bound with ``ctypes``.  The output lives in
``build/torch_kernels/<hash>/`` at the repository root, keyed on a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library.  A file lock keeps concurrent first uses from racing.  Nothing
builds on import, and the CPU paths never build.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libddp_kernels.so"
# No --use_fast_math, and no FMA contraction: the f32 solve must round like
# the plain PyTorch version, which runs one operation per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class KernelCompileError(RuntimeError):
    """nvcc failed or is missing; the message carries its stderr."""


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.rglob("*") if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(str(p.relative_to(CSRC)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use on a CUDA device"
    )


def build() -> Path:
    """Compile the library if this tree's sources were not built yet;
    return its path.  ``ptxas.txt`` beside it keeps ``-Xptxas -v``'s
    per-kernel register and spill report."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another process while we waited
                return lib
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *(str(p) for p in _sources() if p.suffix == ".cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelCompileError(
                    f"nvcc failed (rc={proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stderr}"
                )
            (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.ddp_backpass.argtypes = [i, i, i, i, i, i, i, i,
                                 ctypes.POINTER(p), p]
    lib.ddp_backpass.restype = i
    lib.ddp_rollout.argtypes = [i, ctypes.c_char_p, i, i, i, i, i, i,
                                ctypes.POINTER(p), p]
    lib.ddp_rollout.restype = i
    lib.ddp_error_string.argtypes = [i]
    lib.ddp_error_string.restype = ctypes.c_char_p
    return lib


def pointer_array(tensors) -> "ctypes.Array":
    """``void*`` array of the tensors' device pointers (None -> NULL)."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaGetLastError()``
    (or the negative code of a rejected argument)."""
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.ddp_error_string(rc).decode()} (code {rc})"
        )
