"""keygen_roofline: the least time of the profiled collection's keygen
calls (``roofline/keygen.py``) over their device time, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct("keygen")
