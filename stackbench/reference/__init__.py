"""Plain references of the benchmark's configurations, one module each
(``<config>.py``), built on ``_plain.py``."""
