"""One run of one benchmark cell of the port, on this machine's card.

    python3 stackbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints progress and, as its last lines, each number of the check beside
its limit on standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` (with ``busy_s`` and ``window_s`` when
traced), ``breakdown`` when traced, and ``checks`` last.  Exits non-zero
without a result when no CUDA card is visible, when the cell asks for
more cards than there are, or when JAX or the JAX package is loaded
once the window has closed.
"""

import time

_T0 = time.time()  # the set-up clock starts before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from stackbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"stackbench: {args.workload} needs {chips} CUDA "
                    f"card(s); {torch.cuda.device_count()} visible")
        return 2
    torch.cuda.set_device(0)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", _T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"stackbench: loaded after the window: {found}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
