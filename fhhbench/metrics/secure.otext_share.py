"""secure.otext_share: the secure phase ``otext`` of ``driver.Leader.timings``
(CUDA-event spans on the stream), summed over the window's collections,
over those collections' seconds (the window's, less the profiler's own
time in a traced run)."""


def read(run):
    done = [c for c in run.collections if "otext" in c.phases]
    if not done:
        return None
    return 100.0 * sum(c.phases["otext"] for c in done) / sum(c.seconds for c in done)
