"""Example problems ported from ``ddp_generator_tpu.models``."""
