"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``libstacker_tpu`` (names compared whole: the
port, ``libstacker_tpu_torch``, begins with the JAX package's name), and
nothing of the port in the plain references, the generators or the
yardstick.  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

_TOPS = """
import json, sys
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + _TOPS], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_are_compared():
    """The port's name begins with the JAX package's and is not it."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import libstacker_tpu_torch
from stackbench import harness
assert harness.forbidden_modules() == [], harness.forbidden_modules()
sys.modules["libstacker_tpu.utils"] = sys
assert harness.forbidden_modules() == ["libstacker_tpu"]
"""
    assert "libstacker_tpu_torch" in _tops(code)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell, through the command's own modules."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import stackbench.run
from pathlib import Path
from stackbench import harness
from stackbench.tests import _tiny
tmp = Path({str(tmp_path)!r})
b = _tiny.bench(tmp)
for cell in _tiny.CELLS:
    res = _tiny.run(b, tmp, cell, seconds=0.2, traced=cell == "tiny_kp")
    assert res["correct"], res
assert harness.forbidden_modules() == [], harness.forbidden_modules()
"""
    tops = _tops(code)
    assert "libstacker_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "libstacker_tpu"}


@pytest.mark.parametrize("modules", [
    ["stackbench.reference.ecc_homography_4k",
     "stackbench.reference.keypoint_orb_4k", "stackbench.reference._plain"],
    ["stackbench.gen.bursts"],
    ["stackbench.compare", "stackbench.trace", "stackbench.roofline.fast",
     "stackbench.roofline.warp_accum", "stackbench.roofline.peaks"],
])
def test_yardstick_imports_nothing_of_the_port(modules):
    code = ("import sys\nsys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in modules))
    tops = _tops(code)
    assert not tops & {"jax", "jaxlib", "flax", "libstacker_tpu",
                       "libstacker_tpu_torch"}
