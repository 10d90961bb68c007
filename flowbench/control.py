"""The control of a cell's comparison: the plain reference put in the
program's place one precision lower, judged as the program is.

The configurations state float32 fields (and float64 region sums in the
flagship); the control computes every field in bfloat16 (and the region
sums in float32). A comparison is sound only if the control fails one of
its numbers: the smallest reading the control gives is the upper end a
limit is set under (PERF.md §4).

    python3 flowbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed with each number the control reads. The
benchmark's own runs never run it; ``flowbench/tests/test_flowbench_
control.py`` does, on the card at the cell's size and on the CPU at a
crop.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(name: str, seed: int, device: str,
             overrides: dict | None = None) -> dict:
    """The numbers the control reads on one frame (or pair) of the cell's
    traffic drawn from ``seed``."""
    import numpy as np
    import torch

    from flowbench import harness

    cell = harness.Cell.load(name)
    for part, keys in (overrides or {}).items():
        getattr(cell, part).update(keys)
    cfg = cell.config
    traffic = harness.load_module("traffic", cell.traffic["generator"]).make(
        cell.traffic, cfg, seed)
    ref = harness.load_module("reference", cfg["reference"])
    rng = np.random.default_rng([int(seed), 0xC0DE])
    if cfg["driver"] == "ba_pairs":
        prev, nxt = traffic.pairs[int(rng.integers(len(traffic.pairs)))]
        u, v, _ = ref.flow(prev, nxt, cfg, device)
        uc, vc, _ = ref.flow(prev, nxt, cfg, device, dtype=torch.bfloat16)
        return {"flow_max_abs_px": float(max(np.abs(uc - u).max(),
                                             np.abs(vc - v).max()))}
    mid = int(rng.integers(1, len(traffic.frames) - 1))
    frames = [traffic.frames[k] for k in (mid - 1, mid, mid + 1)]
    good = ref.frame_reference(*frames, cfg, device)
    low = ref.frame_reference(*frames, cfg, device, dtype=torch.bfloat16,
                              acc=torch.float32)
    return ref.judge(SimpleNamespace(
        labels=low.labels, pos=low.pos, col=low.col, bm_u=low.bm_u,
        bm_v=low.bm_v, t=low.t, u=low.u, v=low.v), good)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed,
                                              args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
