"""``lax.while_loop`` for the port: :func:`while_loop` runs a loop on the
device inside a CUDA graph, as a conditional WHILE node
(``csrc/device_loop.cu``), and on the host everywhere else.

The JAX package runs every loop of a solve on the device: the outer loop
of ``make_solver``/``make_batched_solver`` (``jax:solver.py:854``), the
inline lambda retries (``:181``) and boxQP's Newton iteration and its
Armijo backtracking (``jax:ops/boxqp.py:340``, ``:366``).  A loop whose
trip count depends on the data needs its condition on the host in eager
PyTorch; inside a CUDA graph capture :func:`while_loop` instead adds a
WHILE node whose body is the captured ``body_fn`` and whose condition a
one-thread kernel sets from the device value of ``cond_fn``, before the
node and again at the end of every trip.  The host reads nothing.

* **On the host** (tensors on the CPU, a CUDA stream that is not
  capturing, or under :func:`eager_loops`): ``while bool(cond_fn(c)):
  c = body_fn(c)``, the plain version.
* **In a CUDA graph capture**: the WHILE node.  The carry is copied into
  buffers of the enclosing graph, ``body_fn`` runs once on them (captured
  on a stream of its own, as torch's current stream), and its result is
  copied back into them, so every trip reads and writes the same memory.
  The body's allocations go to the pool of the :class:`BodyPool` that the
  caller keeps as long as the graph (:func:`body_pool`), which also makes
  the bodies' streams before the capture.  Loops nest: a
  :func:`while_loop` inside a body adds its node to that body's graph.

``cond_fn`` returns a 0-d (or one-element) bool tensor and neither function
may read the host (a capture refuses a read).  A failed capture raises;
nothing falls back to the host loop, and nothing is unrolled.

:func:`eager_loops` is the counterpart of ``jax.disable_jit()``: under it,
the solvers capture no graph and every loop runs on the host on any
device.  It is the reference a device loop is held against; only the
tests and ``chip_smoke.py`` enter it.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch

from ..utils.tree import tree_map

Tensor = torch.Tensor

#: CUDA runtime and driver versions a WHILE node needs (12.4: nested
#: conditional nodes and memset/memcpy nodes in a body)
MIN_CUDA = 12040

_eager_depth = 0
_capture_depth = 0  # WHILE bodies being captured, innermost last
#: WHILE nodes nest at most this deep (the solver's go two deep)
MAX_NESTING = 4
_streams: dict = {}  # (device index, nesting depth) -> the body's stream
_pool_stack: list = []  # the BodyPools bodies allocate from, innermost last


@contextlib.contextmanager
def eager_loops():
    """Run every :func:`while_loop` on the host, on any device, and let the
    solvers capture no graph: the reference of the device loops (the
    counterpart of ``jax.disable_jit()``).  Nests."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def loops_eager() -> bool:
    """Is :func:`eager_loops` in force?"""
    return _eager_depth > 0


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _copy_into(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _pred(t: Tensor) -> Tensor:
    """The condition as one contiguous device bool."""
    if t.numel() != 1:
        raise ValueError(f"cond_fn must return one element, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(()).to(torch.bool).contiguous()


def check_versions(versions) -> None:
    """Raise unless the CUDA runtime and driver both support WHILE nodes:
    ``versions`` is ``(toolkit, runtime, driver)`` as ``ddp_loop_versions``
    gives them (``1000 * major + 10 * minor``)."""
    toolkit, runtime, driver = versions
    if min(toolkit, runtime, driver) < MIN_CUDA:
        def v(n):
            return f"{n // 1000}.{n % 1000 // 10}"
        raise RuntimeError(
            f"device loops need CUDA >= {v(MIN_CUDA)} (conditional WHILE "
            f"nodes, nested): built with {v(toolkit)}, runtime "
            f"{v(runtime)}, driver {v(driver)}")


def cuda_versions() -> tuple:
    """``(toolkit, runtime, driver)`` of the kernel library (a CUDA build of
    torch and a card are needed)."""
    from .. import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.ddp_loop_versions(out), "ddp_loop_versions")
    return tuple(out)


_checked = []


def _library():
    from .. import _build

    lib = _build.load_library()
    if not _checked:
        check_versions(cuda_versions())
        _checked.append(True)
    return lib


def _release(pool_id, held) -> None:
    device, refs = held
    for _ in range(refs):
        torch._C._cuda_releasePool(device, pool_id)


class BodyPool:
    """The memory of the WHILE bodies of a graph: a private pool of the
    caching allocator, handled as ``torch.cuda.graph`` handles a graph's
    own: each outermost body's capture routes this thread's allocations
    to it and holds a reference, which is released when the owner (who
    keeps the pool as long as the graph: a body's memory is the graph's
    for every replay) is collected.  Not a ``torch.cuda.MemPool``: its
    destructor empties its cache, which the allocator refuses while a
    capture that failed is still on its list.  Bodies captured one after
    another may share a pool, as one graph's nodes share its private pool,
    as long as their graphs never run at once."""

    def __init__(self, device):
        index = torch.device(device).index
        if index is None:
            index = torch.cuda.current_device()
        self.id = torch.cuda.graph_pool_handle()
        self.held = [index, 0]  # device index, references held
        weakref.finalize(self, _release, self.id, self.held)
        _make_streams(index)

    @property
    def captured(self) -> int:
        """Outermost bodies captured into the pool."""
        return self.held[1]


@contextlib.contextmanager
def body_pool(owner: BodyPool):
    """Send the allocations of every WHILE body captured inside to
    ``owner``'s pool."""
    _pool_stack.append(owner)
    try:
        yield
    finally:
        _pool_stack.pop()


@contextlib.contextmanager
def _allocate_to(owner: BodyPool, device: torch.device):
    """Every allocation of this thread into ``owner``'s pool (the
    outermost body enters it; a nested body is on the same thread
    already).  The reference the allocator takes stays with ``owner``."""
    if _capture_depth > 0:
        yield
        return
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, owner.id)
    owner.held[0] = device.index
    owner.held[1] += 1
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(device.index, owner.id)


def _make_streams(index: int) -> None:
    """The bodies' capture streams of device ``index``, one per nesting
    depth, made once, outside any capture: raw streams of the kernel
    library, since two streams of torch's pool may be one."""
    from .. import _build

    if (index, 0) in _streams:
        return
    lib = _build.load_library()
    for depth in range(MAX_NESTING):
        raw = (ctypes.c_void_p * 1)()
        _build.check(lib, lib.ddp_stream_create(index, raw),
                     "ddp_stream_create")
        _streams[(index, depth)] = torch.cuda.ExternalStream(
            raw[0], device=torch.device("cuda", index))


#: WHILE nodes captured in this process, and the nodes of their bodies
#: (each body's own; a nested node's body counts apart)
NODE_COUNTS = {"while": 0, "body": 0}


def graph_nodes(graph_handle: int) -> int:
    """The top-level node count of a ``cudaGraph_t`` (``cuGraphGetNodes``)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get_nodes(ctypes.c_void_p(graph_handle), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {rc})")
    return int(n.value)


def while_loop(cond_fn, body_fn, carry):
    """``lax.while_loop(cond_fn, body_fn, carry)`` over a carry of tensors
    (a tensor, or nested tuples and NamedTuples of them): on the host, or,
    inside a CUDA graph capture, as a WHILE node (module docstring).
    Returns the final carry; inside a capture, buffers of the graph that
    hold it after every replay."""
    device = _leaves(carry)[0].device
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        while bool(cond_fn(carry)):
            carry = body_fn(carry)
        return carry
    if _eager_depth > 0:
        raise RuntimeError("eager_loops() inside a CUDA graph capture: a "
                           "host loop cannot be captured")
    return _captured_while(cond_fn, body_fn, carry, device)


def _captured_while(cond_fn, body_fn, carry, device: torch.device):
    global _capture_depth
    from .. import _build

    if not _pool_stack:
        raise RuntimeError("a device loop captured outside body_pool(): "
                           "its body's memory would have no owner")
    lib = _library()
    if _capture_depth >= MAX_NESTING:
        raise RuntimeError(f"device loops nest at most {MAX_NESTING} deep")
    carry = tree_map(torch.clone, carry)  # the loop's buffers
    outer = torch.cuda.current_stream(device)
    body = _streams[(device.index, _capture_depth)]
    first = _pred(cond_fn(carry))
    out = (ctypes.c_ulonglong * 2)()
    _build.check(lib, lib.ddp_while_begin(outer.cuda_stream,
                                          first.data_ptr(), body.cuda_stream,
                                          out), "ddp_while_begin")
    handle, body_graph = int(out[0]), int(out[1])
    try:
        with _allocate_to(_pool_stack[-1], device):
            _capture_depth += 1
            try:
                with torch.cuda.stream(body):
                    _copy_into(carry, body_fn(carry))
                    again = _pred(cond_fn(carry))
                    rc = lib.ddp_while_end(body.cuda_stream, handle,
                                           again.data_ptr())
            finally:
                _capture_depth -= 1
    except BaseException:
        lib.ddp_while_abort(body.cuda_stream)
        raise
    _build.check(lib, rc, "ddp_while_end")
    NODE_COUNTS["while"] += 1
    NODE_COUNTS["body"] += graph_nodes(body_graph)
    return carry
