"""ot2s_encrypt_roofline: the least time of the profiled collection's ot2s_encrypt
calls (``roofline/ot2s_encrypt.py``) over their device time, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct("ot2s_encrypt")
