"""Per-layer metric readers, one file each, named ``<metric>.py``: each
has ``read(ctx) -> float or None`` (None: nothing to read here, and the
harness leaves the metric out of the result)."""
