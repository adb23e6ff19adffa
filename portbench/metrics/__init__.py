"""One reader per per-layer metric, found by the metric's name in
``BENCHMARK.json``: ``<metric>.py`` defines ``read(obs)`` (or imports the
family's from :mod:`portbench.readings`), which takes a
:class:`portbench.readings.Observation` and returns the number, or None
where the traced run holds nothing for it to read."""
