"""session.base_ot_s: the benchmark's host span around a collection's
base-OT session pair (step 3), in seconds a collection of the window."""


def read(run):
    spans = [c.base_ot_s for c in run.collections if c.base_ot_s is not None]
    return sum(spans) / len(spans) if spans else None
