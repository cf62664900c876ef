"""leader.prune_share: the leader loop's phase ``prune`` of
``driver.Leader.timings`` (the leader's host work from the readback's return
to the first advance launch; host seconds) in the profiled collection (a
traced run profiles the window's first), over that collection's seconds.
Read only where its timings hold ``prune``, the mark of the leader's phase
clock (before it ``prune`` was another quantity, or none)."""


def read(run):
    c = run.collections[0] if run.trace is not None and run.collections else None
    if c is None or "prune" not in c.phases or not c.seconds:
        return None
    return 100.0 * c.phases["prune"] / c.seconds
