"""device.idle_share: 100 x (1 - the union of kernel and copy intervals
over the profiled collection's wall time)."""


def read(run):
    t = run.trace
    if t is None or t.span_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.span_s)
