"""expand_roofline: the least time of the profiled collection's expand
calls (``roofline/expand.py``) over their device time, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct("expand")
