"""The yardstick of the kernels' roofline shares: the card's published
peaks (``peaks.py``) and each kernel's bytes and operations from its
shapes (``<kernel>.py``)."""
