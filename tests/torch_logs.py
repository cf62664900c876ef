"""A port binary's ``main`` run in a test's process: its events as JSON
lines on standard output for the length of the block (what
``chip_smoke.LOG_ENV`` gives a child process), and what ``obs.exit_report``
leaves behind in the process — the heartbeat thread and the SIGTERM
handler — taken away after."""

import contextlib
import signal

import chip_smoke
from fuzzyheavyhitters_torch.obs import heartbeat


@contextlib.contextmanager
def binary_in_process():
    handler = signal.getsignal(signal.SIGTERM)
    with chip_smoke.json_logs():
        try:
            yield
        finally:
            heartbeat.stop_heartbeat()
            signal.signal(signal.SIGTERM, handler)
