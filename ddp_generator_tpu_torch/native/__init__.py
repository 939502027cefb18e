"""Native (C++) runtime components (``ddp_generator_tpu.native``).

* ``ddp_io.cpp`` (``libddp_io.so``): a binary tensor-archive checkpoint
  format with CRC validation and an asynchronous background-writer thread,
  the checkpoint/resume subsystem the reference lacks.  The source is the
  JAX package's, unchanged, so archives written by either package read in
  the other.

Built with g++ at first use (:func:`build`); every Python entry point falls
back to ``numpy.savez`` when the library cannot be built, which
:func:`native_available` reports.  This is host I/O: tensors on a device
are copied to the host to be written, and restored onto the device of the
template they are loaded into.
"""

from .build import build, library_path  # noqa: F401
from .ckpt import (  # noqa: F401
    AsyncCheckpointWriter,
    load_arrays,
    load_pytree,
    native_available,
    save_arrays,
    save_pytree,
)
