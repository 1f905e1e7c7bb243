"""Per-layer metrics: ``benchmark/metrics/<name>.py`` defines ``read(run)``,
the value of metric ``<name>`` for a traced run (``harness.Run``), or None
where it finds nothing to read (``spec.metric_reader`` loads the file)."""
