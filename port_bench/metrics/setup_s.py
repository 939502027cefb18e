"""setup_s: seconds from the process's start to the window's start:
imports, CUDA start, the kernel library (built at a checkout's first run),
the problem and the input pool, and the entry's set-up (``precompile`` of
every width, or the first ``solve`` call's capture)."""


def read(run):
    return run.setup_total
