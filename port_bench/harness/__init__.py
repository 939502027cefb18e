"""The benchmark harness of ``ddp_generator_tpu_torch``: generic code that
finds a cell's configuration, traffic, metrics, counts and limits by the
names ``BENCHMARK.json`` gives, drives the port's entry point, reads the
trace and judges the outputs against the plain reference."""
