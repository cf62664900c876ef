"""One reader a metric: ``metrics/<name>.py`` holds ``read(run)``, which
returns the metric's value from a :class:`fhhbench.harness.Run`, or None
when the run holds nothing to read it from (the metric is then left out of
the line; a share of a roofline or a peak is never given as 0)."""
