"""secure.b2a_share: the secure phase ``b2a`` of ``driver.Leader.timings``
(CUDA-event spans on the stream), summed over the window's collections,
over those collections' seconds (the window's, less the profiler's own
time in a traced run)."""


def read(run):
    done = [c for c in run.collections if "b2a" in c.phases]
    if not done:
        return None
    return 100.0 * sum(c.phases["b2a"] for c in done) / sum(c.seconds for c in done)
