#!/usr/bin/env python3
"""Chosen rows of chip_smoke.py on one card, through this checkout's port
or another's, so that two checkouts can be compared in one run.

    python3 scripts/chip_rows.py --rows sepconv_rows,resident_rows
    python3 scripts/chip_rows.py --repo DIR --rows sepconv_rows,fb_profiled

Each name in ``--rows`` is a function of chip_smoke.py that takes the
device, and where it has them an ``out`` dict and ``usage`` (the kernel
rows: ``sepconv_rows``, ``resident_rows``, ``irls_levels``,
``resident_checks``, ``phase_kernels_wide``, ...), or ``fb_profiled``:
Farneback's FB_PROFILED config at 1080x1920, ms per frame and one
profiler frame (the card's busy time and idle share), or ``blur_ab``:
blur-solve against its plain version at the winsizes a parent's kernel
also takes (chip_smoke.BLUR_AB), through the wrapper alone.

Without ``--repo`` it first runs chip_smoke.py's build phase, so the rows
log blocks per SM and ptxas's registers and spills. With ``--repo`` the
checkout at DIR's ``tpuflow_torch`` is imported instead (its kernels
build under DIR at first launch) and the rows run without ptxas usage.
Run parent, change, change, parent in one call to compare two commits.
The first lines are chip_smoke.py's device phase (the card's name and
power limit). Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def fb_profiled(cs, dev) -> None:
    frames = cs.f32(dev, *cs.frames_1080p())
    cfg = dict((name, cfg) for name, cfg, _ in cs.FB_CASES)[cs.FB_PROFILED]
    cs.log("fb", config=cs.FB_PROFILED, card_ms_per_frame=cs.cuda_ms(
        lambda: cs.fb_call(frames, cfg)))
    cs.profile_frame("fb", lambda: cs.fb_call(frames, cfg),
                     config=cs.FB_PROFILED)


def blur_ab(cs, dev) -> None:
    """blur-solve at BLUR_AB through the checkout's wrapper and plain
    version alone (a parent's module has no form functions)."""
    from tpuflow_torch.core import borders as bd
    from tpuflow_torch.kernels import fb_kernels

    for shape, winsize in cs.BLUR_AB:
        M, = cs.f32(dev, cs.well_conditioned_m(shape, winsize))
        Mp = bd.pad2d(M, winsize // 2, bd.CLAMP)
        cs.kernel_row({}, "fb_blur_solve", shape,
                      lambda: fb_kernels.fb_blur_solve(Mp, winsize),
                      lambda: fb_kernels.fb_blur_solve_plain(Mp, winsize),
                      cs.blur_bound(*Mp.shape[1:], winsize), winsize=winsize)


SPECIAL = {"fb_profiled": fb_profiled, "blur_ab": blur_ab}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", type=Path)
    ap.add_argument("--rows", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # noqa: E402  (imports tpuflow_torch lazily)

    if args.repo:
        sys.path.insert(0, str(args.repo.resolve()))
    import torch

    cs.phase_device()  # exits without a card
    dev = torch.device("cuda", 0)
    cs.log("rows", repo=str(args.repo.resolve()) if args.repo else str(REPO))
    if not args.repo:
        cs.phase_build()
    for name in args.rows.split(","):
        if name in SPECIAL:
            SPECIAL[name](cs, dev)
            continue
        fn = getattr(cs, name)
        params = inspect.signature(fn).parameters
        kw = {"out": {}} if "out" in params else {}
        if "usage" in params:
            kw["usage"] = not args.repo
        fn(dev, **kw)


if __name__ == "__main__":
    main()
