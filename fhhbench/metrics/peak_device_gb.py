"""peak_device_gb: ``torch.cuda.max_memory_allocated()`` over the window
(reset after warm-up), in 10^9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
