"""Loops, one module each (``<driver>.py``, named by a traffic file's
``driver``)."""
