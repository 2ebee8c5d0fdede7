"""Published rates of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, at
its 700 W limit), frozen from ``chip_smoke.py:304-308``: HBM bytes per
second, and float32 operations per second outside the tensor cores
(also taken for B8's integer min/max, which issue at no higher rate)."""

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def bound_s(nbytes: float, ops: float):
    """``(seconds, 'bytes' | 'operations')``: the least time at the
    published rates (``chip_smoke.py:388-391``)."""
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
