"""Numerical building blocks: derivative emission, rollouts and the two
hand-written CUDA kernels (``cuda_backpass``: B1, ``cuda_rollout``: B2)."""
