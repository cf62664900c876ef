"""keygen.host_s: seconds of the program's ``fhh.keygen.host`` profiler
ranges (``ops/ibdcf.py`` ``gen_l_inf_ball``: keygen's host part, from its
entry to the kernel's launch) inside the profiled collection."""

RANGE = "fhh.keygen.host"


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.span
    spans = [(s, e) for n, s, e in t.host if n == RANGE and lo <= s and e <= hi]
    return sum(e - s for s, e in spans) / 1e9 if spans else None
