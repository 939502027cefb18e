"""Batch data parallelism over ``torch.distributed`` (``parallel.mesh``)."""

from . import mesh

__all__ = ["mesh"]
