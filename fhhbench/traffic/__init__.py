"""Traffic: the mixes (``<mix>.json``), the frozen samplers of client
points (``<distribution>.py``, named by a configuration's
``distribution``), and :func:`generate.point_sets`, which reads both."""
