"""flowbench: the benchmark of ``tpuflow_torch`` on one NVIDIA H100.

Run one cell once, from the repository root (a machine with the card):

    python3 flowbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Cells (``BENCHMARK.json``'s ``workloads``; each on one card):

- ``flagship_kitti_dense``: the segmentation block-matching flagship as a
  closed-loop stream of 375x1242 colour frames, a camera panning over
  1,800 shaded Voronoi cells a frame: the region matcher does most of the
  work.
- ``ba_kitti_pairs``: the Black-Anandan pyramid on a closed loop of 16
  gray 375x1242 pairs of smoothed noise, each moved by an integer shift;
  frames uploaded, solved and fetched back one at a time.
- ``flagship_kitti_coarse``: the flagship on 200 large cells a frame: the
  matcher's products shrink, the per-pixel stages stay.

``--trace 0`` prints the cell's end-to-end metrics (``frames_per_s``,
``setup_s``, and ``frame_ms_p95`` where the cell has it), measured over a
closed-loop window of ``--seconds``; ``--trace 1`` prints its per-layer
metrics from a ``torch.profiler`` window of a few frames, counting frames
after it and the frozen rooflines of ``flowbench/bounds.py``. Both judge a
sample of the window's outputs against the plain reference in
``flowbench/reference/`` and print each number compared beside its limit.
The last line of standard output is one JSON object.

The program's kernels are built by nvcc (and its native library by g++)
into ``build/tpuflow_torch/`` inside the checkout on a run's first use, and
found there by every later run. Nothing here imports JAX or the JAX
package; a run that finds either loaded exits 3. Without a card it exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from flowbench import harness

    cell = harness.Cell.load(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"flowbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.ForbiddenModules as e:
        print(f"flowbench: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print("flowbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
