"""leader.advance_share: the leader loop's phase ``advance`` of
``driver.Leader.timings`` (both servers' advances; device-stream seconds:
the leader's phase clock records its CUDA events only while a profiler runs)
in the profiled collection (a traced run profiles the window's first), over
that collection's seconds.  Read only where its timings hold ``prune``, the
mark of the leader's phase clock (before it ``advance`` was another
quantity, or none)."""


def read(run):
    c = run.collections[0] if run.trace is not None and run.collections else None
    if c is None or "prune" not in c.phases or not c.seconds:
        return None
    return 100.0 * c.phases["advance"] / c.seconds
