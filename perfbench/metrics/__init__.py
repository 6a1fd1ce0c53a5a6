"""Per-layer metrics: ``<name>.py`` holds ``read(view)``, which returns
the metric's value from a :class:`perfbench.harness.TraceView`, or None
where the traced window holds nothing it reads."""
