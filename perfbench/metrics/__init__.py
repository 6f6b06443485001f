"""One reader a metric: ``metrics/<metric name>.py`` with ``read(run)``,
which returns the metric's value (or ``(value, note)``), or None where
the run holds nothing to read."""
