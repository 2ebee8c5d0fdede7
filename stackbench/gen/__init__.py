"""Frozen copies of the port's burst recipes (``bursts.py``)."""
