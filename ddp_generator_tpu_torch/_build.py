"""Build the hand-written CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, bound with ``ctypes``: one ``nvcc -c`` per source, all started
together, then one link.  The output lives in
``build/torch_kernels/<hash>/`` at the repository root, keyed on a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library.  A file lock keeps concurrent first uses from racing.  Nothing
builds on import, and the CPU paths never build.

Two more kinds of library are built the same way, each on first use:
kernels B2 and B3 and the emission kernel on a model generated from a
problem's torch functions (:func:`build_model`,
``csrc/generated/{rollout,fused,emit}.cu`` with the model's header, keyed
also on the header), and kernel B1 at an
``(n_x, n_u)`` the main library does not instantiate
(:func:`build_backpass_shape`).  A failed build raises
:class:`KernelCompileError`; no route falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libddp_kernels.so"
# No --use_fast_math, and no FMA contraction: the f32 solve must round like
# the plain PyTorch version, which runs one operation per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)


class KernelCompileError(RuntimeError):
    """nvcc failed or is missing; the message carries its stderr."""


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(p for p in csrc.rglob("*") if p.suffix in (".cu", ".cuh"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(csrc):
        h.update(str(p.relative_to(csrc)).encode())
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


#: Wall seconds of each library this process compiled (its path as key).
BUILD_SECONDS: dict[str, float] = {}


def _compile(key: str, units, files=None) -> Path:
    """Compile ``units`` (``(source, extra nvcc args)``, one ``nvcc -c``
    each, all started together) and link them into
    ``BUILD_ROOT/key/LIB_NAME``, unless that library exists; ``files``
    (name -> text) are written beside the objects first.  A file lock keeps
    concurrent first uses from racing; ``ptxas.txt`` keeps ``-Xptxas
    -v``'s per-kernel register and spill report."""
    out_dir = BUILD_ROOT / key
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another process while we waited
                return lib
            t0 = time.time()
            out_dir.mkdir(parents=True, exist_ok=True)
            for name, text in (files or {}).items():
                (out_dir / name).write_text(text)
            tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
            nvcc = nvcc_path()
            objs, procs = [], []
            for src, extra in units:
                obj = out_dir / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj),
                       str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(str(obj))
            report, failed = [], []
            for cmd, proc in procs:
                out = proc.communicate()[0]
                report.append(out)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed (rc={proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{out}")
            if failed:
                raise KernelCompileError("\n".join(failed))
            link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(tmp), *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelCompileError(
                    f"nvcc link failed (rc={proc.returncode}):\n"
                    f"{' '.join(link)}\n{proc.stderr}")
            (out_dir / "ptxas.txt").write_text("".join(report))
            os.replace(tmp, lib)
            BUILD_SECONDS[str(lib)] = time.time() - t0
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build(csrc: Path = CSRC) -> Path:
    """Compile the library of the hand-written models and shapes (every
    ``.cu`` directly under ``csrc``: this package's, or another tree's, as
    ``scripts/tile_sweep.py`` builds them) if it was not built yet; return
    its path."""
    units = [(src, ["-I", str(csrc)]) for src in sorted(csrc.glob("*.cu"))]
    return _compile(source_hash(csrc), units)


def _keyed(prefix: str, text: str) -> str:
    h = hashlib.sha256(source_hash().encode() + text.encode())
    return f"{prefix}-{h.hexdigest()[:16]}"


def build_model(model) -> Path:
    """Compile kernels B2 and B3 and the emission kernel on a generated
    model (:class:`..codegen.GeneratedModel`): ``generated/rollout.cu``,
    ``generated/fused.cu`` and ``generated/emit.cu`` with its header as
    ``model.cuh``, keyed on the sources, the flags and the header."""
    key = _keyed(model.name, model.header)
    inc = ["-I", str(CSRC), "-I", str(BUILD_ROOT / key),
           f"-DDDP_MODEL={model.struct}"]
    units = [(CSRC / "generated" / f"{k}.cu", inc)
             for k in ("rollout", "fused", "emit")]
    return _compile(key, units, {"model.cuh": model.header})


def build_backpass_shape(n_x: int, n_u: int) -> Path:
    """Compile kernel B1 at ``(n_x, n_u)`` (``generated/backpass.cu``)."""
    key = _keyed(f"backpass{n_x}x{n_u}", f"{n_x} {n_u}")
    units = [(CSRC / "generated" / "backpass.cu",
              ["-I", str(CSRC), f"-DDDP_NX={n_x}", f"-DDDP_NU={n_u}"])]
    return _compile(key, units)


def build_all(jobs) -> list[Path]:
    """Run build callables (``lambda: build_model(m)``, ...) at once, each
    in a thread of its own: their ``nvcc`` runs start together.  The first
    failure raises after all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futures = [pool.submit(job) for job in jobs]
    return [f.result() for f in futures]


# library path -> seconds of its first load in this process: the build (or
# the check that it is built) and the dlopen
LOAD_SECONDS: dict[str, float] = {}


def _load(build_fn) -> ctypes.CDLL:
    t0 = time.time()
    path = build_fn()
    lib = open_library(path)
    LOAD_SECONDS[str(path)] = time.time() - t0
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load this package's kernel library."""
    return _load(build)


@functools.lru_cache(maxsize=None)
def load_model_library(model) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of a generated model
    (once per model: the wrappers ask on every launch)."""
    return _load(lambda: build_model(model))


@functools.lru_cache(maxsize=None)
def load_backpass_shape(n_x: int, n_u: int) -> ctypes.CDLL:
    """Build (if needed) and load kernel B1 at ``(n_x, n_u)``."""
    return _load(lambda: build_backpass_shape(n_x, n_u))


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built kernel library with every C entry point's
    ``argtypes``/``restype`` declared.  An entry point the library lacks is
    passed over (``scripts/tile_sweep.py`` loads other trees' builds)."""
    lib = ctypes.CDLL(str(path))
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    ip, pp, name = ctypes.POINTER(i), ctypes.POINTER(p), ctypes.c_char_p
    for fn, argtypes in (
            ("ddp_backpass", [i, i, i, i, i, i, i, pp, p]),
            ("ddp_backpass_info", [i, i, i, i, i, ip]),
            ("ddp_fused", [i, name, i, i, i, i, pp, p]),
            ("ddp_fused_info", [i, name, i, i, ip]),
            ("ddp_emit", [i, name, i, i, i, i, ll, pp, p]),
            ("ddp_emit_info", [i, name, i, ip]),
            ("ddp_rollout", [i, name, i, i, i, i, i, i, ll, pp, p]),
            ("ddp_rollout_info", [i, name, i, i, ip]),
            ("ddp_loop_versions", [ip]),
            ("ddp_stream_create", [i, pp]),
            ("ddp_while_begin", [p, p, p, ctypes.POINTER(ctypes.c_ulonglong)]),
            ("ddp_while_end", [p, ctypes.c_ulonglong, p]),
            ("ddp_while_abort", [p]),
            ("ddp_stamp", [p, i, p])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = i
    lib.ddp_error_string.argtypes = [i]
    lib.ddp_error_string.restype = ctypes.c_char_p
    return lib


def pointer_array(tensors) -> "ctypes.Array":
    """``void*`` array of the tensors' device pointers (None -> NULL)."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def info_dict(out) -> dict:
    """The ints of ``ddp_backpass_info`` (seven: threads per lane ``P``
    last), ``ddp_fused_info`` and ``ddp_rollout_info`` (six)."""
    return dict(zip(("G", "S", "W", "smem_bytes", "registers",
                     "local_bytes", "P"), list(out)))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaGetLastError()``
    (or the negative code of a rejected argument)."""
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.ddp_error_string(rc).decode()} (code {rc})"
        )
