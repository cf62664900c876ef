"""crawl.torch_share: device time in kernels other than the port's six
(the crawl engine's plain PyTorch gathers, selects and counts) over device
busy time, in the profiled collection."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    ours = tuple(t.kernel_names.values())
    plain = sum(e - s for n, s, e in t.kernels if not any(k in n for k in ours)) / 1e9
    return 100.0 * plain / t.busy_s()
