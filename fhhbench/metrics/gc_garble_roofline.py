"""gc_garble_roofline: the least time of the profiled collection's gc_garble
calls (``roofline/gc_garble.py``) over their device time, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct("gc_garble")
