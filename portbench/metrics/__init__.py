"""One reader a per-layer metric: ``metrics/<name>.py`` holds
``read(run) -> float | None``. ``run`` is the traced run's record (see
``portbench/harness.py`` ``run_record``); a reader that finds nothing to
read returns None, and the metric is left out of the line."""
