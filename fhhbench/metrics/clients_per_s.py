"""clients_per_s: all clients of the window's whole collections over the
seconds those collections took, one rate over the whole window."""


def read(run):
    done = [c for c in run.collections if c.error is None]
    if not done or run.window_s <= 0:
        return None
    return sum(c.clients for c in done) / run.window_s
