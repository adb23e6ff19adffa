"""One driver per traffic kind, found by the ``kind`` of a cell's
``workloads/<cell>.json``: ``<kind>.py`` defines ``run(ctx)``, which sets
the cell up, measures it, frees the program and checks it against the
reference. It returns ``{"correct", "attempted", "failed", "checks",
"memory_peak_bytes"}`` and ``e2e`` (window) or ``obs`` (traced run)."""
