"""device_idle_pct.batch: the share of the traced window in which no
device operation ran (1 minus the union of the kernel, copy and set
intervals over the window, ``torch.profiler``), in percent."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
