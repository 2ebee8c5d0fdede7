"""``utils/tracing.trace``, the counterpart of the JAX package's
``jax.profiler`` trace: a no-op for ``None``; otherwise a
``torch.profiler`` Chrome trace in ``log_dir`` that names the block's
operations (on the CPU here; the card's kernels are recorded where CUDA
is available)."""

import json

import pytest

torch = pytest.importorskip("torch")

from libstacker_tpu_torch.utils import tracing  # noqa: E402


def test_trace_none_is_a_no_op(tmp_path):
    with tracing.trace(None):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    a = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with tracing.trace(str(log_dir)):
        b = torch.mm(a, a)
    assert float(b[0, 0]) == float((a[0] * a[:, 0]).sum())
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
