"""Checkpoint and restore: Python bindings of the native tensor-archive
engine (``ddp_generator_tpu.native.ckpt``), over tensors.

:func:`save_pytree` flattens a tree of tensors (nested dicts, NamedTuples,
tuples and lists, e.g. the stepwise solver's carry) to named arrays, which
the library writes (synchronously, or through :class:`AsyncCheckpointWriter`
on a background thread); :func:`load_pytree` reads them back into the
structure of a template, each leaf onto its template leaf's device.  Leaf
names are the JAX package's (``['key']`` for a dict key, ``.name`` for a
NamedTuple field, ``[i]`` for an index, joined by ``/``), and the archive
format is the same file, so archives cross between the two packages.

A device tensor is copied to the host (``.cpu().numpy()``) to be written:
this is host I/O.  Dtypes outside the archive's table (bfloat16, complex)
raise ``ValueError``.  Without g++ (the library cannot be built) the
arrays go through ``numpy.savez`` instead; :func:`native_available` says
which.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .build import build

_MAX_DIMS = 8

# dtype codes in the archive (stable across platforms; ddp_io.cpp's table)
_DTYPE_CODES = {
    np.dtype("float32"): 1,
    np.dtype("float64"): 2,
    np.dtype("int32"): 3,
    np.dtype("int64"): 4,
    np.dtype("bool"): 5,
    np.dtype("uint8"): 6,
    np.dtype("int8"): 7,
    np.dtype("uint32"): 8,
    np.dtype("float16"): 9,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_TORCH_DTYPES = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
    torch.uint8: np.uint8, torch.int8: np.int8, torch.float16: np.float16,
}
if hasattr(torch, "uint32"):
    _TORCH_DTYPES[torch.uint32] = np.uint32

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_ARRAY_ARGS = [ctypes.c_char_p, _I32, ctypes.POINTER(ctypes.c_char_p),
               ctypes.POINTER(_I32), ctypes.POINTER(_I32),
               ctypes.POINTER(_I64), ctypes.POINTER(_P),
               ctypes.POINTER(_I64)]
_SIGNATURES = {  # name: (restype, argtypes)
    "ddpio_write": (ctypes.c_int, _ARRAY_ARGS),
    "ddpio_open": (_P, [ctypes.c_char_p]),
    "ddpio_count": (_I32, [_P]),
    "ddpio_error": (ctypes.c_char_p, [_P]),
    "ddpio_last_error": (ctypes.c_char_p, []),
    "ddpio_name": (ctypes.c_char_p, [_P, _I32]),
    "ddpio_dtype": (_I32, [_P, _I32]),
    "ddpio_ndim": (_I32, [_P, _I32]),
    "ddpio_dims": (None, [_P, _I32, ctypes.POINTER(_I64)]),
    "ddpio_nbytes": (_I64, [_P, _I32]),
    "ddpio_read": (ctypes.c_int, [_P, _I32, _P, _I64]),
    "ddpio_close": (None, [_P]),
    "ddpio_writer_create": (_P, [_I32]),
    "ddpio_writer_submit": (ctypes.c_int, [_P] + _ARRAY_ARGS),
    "ddpio_writer_drain": (None, [_P]),
    "ddpio_writer_completed": (_I64, [_P]),
    "ddpio_writer_failed": (_I64, [_P]),
    "ddpio_writer_destroy": (None, [_P]),
}

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here (else the numpy
    fallback writes and reads the archives)."""
    try:
        _load_lib()
        return True
    except (OSError, RuntimeError):
        return False


def _as_numpy(name: str, v) -> np.ndarray:
    """A host array of a supported dtype (0-d stays 0-d)."""
    if isinstance(v, torch.Tensor):
        if v.dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {v.dtype} for '{name}'")
        return v.detach().cpu().numpy()
    a = np.asarray(v, order="C")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {a.dtype} for '{name}'")
    return a


def _pack_args(arrays: Dict[str, np.ndarray]):
    n = len(arrays)
    # np.ascontiguousarray would promote 0-d scalars to (1,); asarray with
    # order="C" keeps ndim 0
    items = [(k, np.asarray(v, order="C")) for k, v in arrays.items()]
    for k, a in items:
        if a.ndim > _MAX_DIMS:
            raise ValueError(f"'{k}' has {a.ndim} dims; the archive holds "
                             f"at most {_MAX_DIMS}")
    names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in items])
    dtypes = (_I32 * n)(*[_DTYPE_CODES[a.dtype] for _, a in items])
    ndims = (_I32 * n)(*[a.ndim for _, a in items])
    dims = (_I64 * (n * _MAX_DIMS))()
    for i, (_, a) in enumerate(items):
        for j, d in enumerate(a.shape):
            dims[i * _MAX_DIMS + j] = d
    datas = (_P * n)(*[a.ctypes.data_as(_P).value for _, a in items])
    nbytes = (_I64 * n)(*[a.nbytes for _, a in items])
    return items, names, dtypes, ndims, dims, datas, nbytes


def save_arrays(path: str, arrays: Dict[str, Any]) -> None:
    """Write named arrays or tensors to an archive at ``path``
    (synchronously; ``numpy.savez`` without the library)."""
    arrays = {k: _as_numpy(k, v) for k, v in arrays.items()}
    try:
        lib = _load_lib()
    except (OSError, RuntimeError):
        np.savez(path, **arrays)
        return
    items, *args = _pack_args(arrays)
    if lib.ddpio_write(path.encode(), len(items), *args) != 0:
        raise IOError(
            f"ddpio_write failed: {lib.ddpio_last_error().decode()}")


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """Read every array of the archive at ``path`` (host numpy arrays)."""
    try:
        lib = _load_lib()
    except (OSError, RuntimeError):
        with np.load(path if os.path.exists(path) else path + ".npz") as z:
            return {k: z[k] for k in z.files}
    h = lib.ddpio_open(path.encode())
    try:
        count = lib.ddpio_count(h)
        if count < 0:
            raise IOError(f"ddpio_open: {lib.ddpio_error(h).decode()}")
        out = {}
        for i in range(count):
            name = lib.ddpio_name(h, i).decode()
            dtype = _CODE_DTYPES[lib.ddpio_dtype(h, i)]
            ndim = lib.ddpio_ndim(h, i)
            dims = (_I64 * _MAX_DIMS)()
            lib.ddpio_dims(h, i, dims)
            a = np.empty(tuple(dims[j] for j in range(ndim)), dtype)
            if lib.ddpio_read(h, i, a.ctypes.data_as(_P), a.nbytes) != 0:
                raise IOError(f"ddpio_read size mismatch for '{name}'")
            out[name] = a
        return out
    finally:
        lib.ddpio_close(h)


class AsyncCheckpointWriter:
    """Background-thread checkpoint writer (the library's writer thread).

    ``submit`` copies the arrays into the native job queue and returns at
    once (False when the queue is full); ``drain`` blocks until every
    queued write is on disk.  Needs the library."""

    def __init__(self, max_queue: int = 4):
        self._lib = _load_lib()
        self._h = self._lib.ddpio_writer_create(max_queue)

    def submit(self, path: str, arrays: Dict[str, Any]) -> bool:
        arrays = {k: _as_numpy(k, v) for k, v in arrays.items()}
        items, *args = _pack_args(arrays)
        return self._lib.ddpio_writer_submit(
            self._h, path.encode(), len(items), *args) == 0

    def drain(self) -> None:
        self._lib.ddpio_writer_drain(self._h)

    @property
    def completed(self) -> int:
        return self._lib.ddpio_writer_completed(self._h)

    @property
    def failed(self) -> int:
        return self._lib.ddpio_writer_failed(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ddpio_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---- tree layer ----


def _flatten(tree: Any, path: str = ""):
    """``(name, leaf)`` pairs in the JAX package's order and naming: dict
    keys sorted, ``None`` an empty subtree."""
    def join(part):
        return f"{path}/{part}" if path else part

    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], join(f"[{k!r}]"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), join(f".{f}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, join(f"[{i}]"))
    else:
        yield path or "leaf", tree


def save_pytree(path: str, tree: Any,
                writer: Optional[AsyncCheckpointWriter] = None) -> None:
    """Checkpoint a tree of tensors or arrays (a solver carry, a Solution,
    params); through ``writer`` when given (synchronously if its queue is
    full)."""
    named = {k: _as_numpy(k, v) for k, v in _flatten(tree)}
    if writer is not None and writer.submit(path, named):
        return
    save_arrays(path, named)


def _rebuild(like: Any, leaves):
    if like is None:
        return None
    if isinstance(like, dict):  # leaves in sorted key order, keys in like's
        vals = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a checkpoint into the structure of ``like``: a tensor leaf
    comes back as a tensor on that leaf's device (with the archive's dtype
    and shape), any other leaf as a numpy array."""
    named = load_arrays(path)
    leaves = []
    for key, leaf in _flatten(like):
        if key not in named:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        a = named[key]
        if isinstance(leaf, torch.Tensor):
            a = torch.from_numpy(a).to(leaf.device)
        leaves.append(a)
    return _rebuild(like, iter(leaves))
