"""gc_eval_roofline: the least time of the profiled collection's gc_eval
calls (``roofline/gc_eval.py``) over their device time, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct("gc_eval")
