"""Build the checkpoint engine's library (g++, no external dependencies).

``ddp_io.cpp`` is compiled at first use into
``build/native/<hash>/libddp_io.so`` at the repository root (never beside
the source), keyed on a hash of the source and flags, so an edit rebuilds
and an unchanged tree reuses the library.  A file lock keeps concurrent
first uses from racing.  Run ``python -m ddp_generator_tpu_torch.native.build``
to build it ahead of use.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "ddp_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libddp_io.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(force: bool = False, quiet: bool = True) -> Path:
    """Compile the library unless it exists (or with ``force``); returns
    its path.  Raises ``RuntimeError`` with g++'s output if it fails, and
    ``FileNotFoundError`` without g++."""
    lib = library_path()
    if lib.exists() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and not force:  # built while we waited
                return lib
            tmp = lib.with_name(f"{LIB_NAME}.tmp{os.getpid()}")
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                                  str(SRC)], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"native build failed:\n{res.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if not quiet:
        print(f"built {lib}", file=sys.stderr)
    return lib


if __name__ == "__main__":
    build(force="--force" in sys.argv, quiet=False)
