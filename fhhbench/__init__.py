"""fhhbench — the benchmark of ``fuzzyheavyhitters_torch`` on one H100.

One run is one process on one card: ``python3 fhhbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout.  Everything that belongs to one configuration, traffic mix,
kernel or per-layer metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<name>.json``      a deployment (sizes, guarantees, source)
- ``traffic/<mix>.json``       a traffic mix; ``traffic/<distribution>.py``
                               the frozen sampler of a configuration's points
- ``roofline/<kernel>.py``     a kernel's wrapper, its device name and the
                               bytes and integer operations one call needs
- ``metrics/<metric>.py``      the reader of one per-layer metric
- ``reference/``               the plain NumPy reference that decides
                               ``correct``; it imports nothing of the program
"""
