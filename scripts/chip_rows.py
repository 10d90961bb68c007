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
also takes (chip_smoke.BLUR_AB), through the wrapper alone, or
``lk_affine``: chip_smoke.py's phases lk and affine, or
``sync_cadence``: the three loops that read a stop flag back once per
block of steps, each timed at several block lengths (CADENCES), or
``flagship_pairs``: the flagship's default pairs at 376x1240, ms per
pair over FLAGSHIP_ROUNDS rounds after a warm-up round, or
``lab_threads``: the flagship's host Lab conversion at the default torch
thread count and at one thread, or ``demo_split``: the HS demo's stages
timed apart and one profiler frame of each demo (the demos need a
checkout that has them).

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
import time
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


def lk_affine(cs, dev) -> None:
    """chip_smoke.py's phases lk and affine alone (the flagship's default
    pairs, which bm_flow_stream is held to, run first)."""
    launches = {}
    cs.phase_lk(dev, *cs.main_lk(dev, launches))
    outs, _ = cs.bm_sequence(cs.voronoi_frames()[0], dev)
    cs.phase_affine(dev, *cs.main_affine(dev, launches, outs))
    cs.log("rows", launches=launches)


# (loop, module, constant, block lengths): track_points' done mask,
# irls_affine_level's stop flag (10**6: never read) and the per-region
# affine fit's all-done flag.
CADENCES = (("track_points", "lucas_kanade", "DONE_CHECK_EVERY", (1, 5, 30)),
            ("multiple_motion_affine", "affine", "STOP_CHECK_EVERY",
             (1, 16, 64, 256, 10**6)),
            ("affine_parametric_flow", "bm_flow", "AFFINE_CHECK_EVERY",
             (1, 4, 16, 64, 256)))
CADENCE_ROUNDS = 3


def sync_cadence(cs, dev) -> None:
    """Each loop of CADENCES on its chip_smoke.py inputs (sparse LK and
    the global fit on the KITTI frames, the per-region fit on the whole
    frame of the AFFINE flagship's pair 2), host clock around a synced
    call, the block lengths in turns for CADENCE_ROUNDS rounds; every
    length must give the same result."""
    import importlib

    import torch

    from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
    from tpuflow_torch.solvers import affine_parametric_flow

    kitti = cs.f32(dev, *cs.frames_kitti())
    pts = cs.corners(kitti[0])
    (_, out2), state = cs.bm_sequence(
        cs.voronoi_frames()[0], dev, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING)
    fields, labels, n = cs.affine_crop_inputs(
        dev, state, out2, (slice(None), slice(None)))
    calls = {"track_points": lambda: cs.track(*kitti, pts),
             "multiple_motion_affine": lambda: cs.affine_call(kitti, dev),
             "affine_parametric_flow": lambda: affine_parametric_flow(
                 *fields, labels, n, iter_max=256, normalize_steps=True)}
    for loop, module, const, everys in CADENCES:
        mod = importlib.import_module(f"tpuflow_torch.solvers.{module}")
        default = getattr(mod, const)
        ms = {k: [] for k in everys}
        first = None
        try:
            for _ in range(CADENCE_ROUNDS):
                for every in everys:
                    setattr(mod, const, every)
                    t0 = time.perf_counter()
                    res = calls[loop]()
                    torch.cuda.synchronize()
                    ms[every].append(1e3 * (time.perf_counter() - t0))
                    res = [r.cpu() for r in (
                        res if isinstance(res, tuple) else (res,))]
                    if first is None:
                        first = res
                    elif not all(torch.equal(a, b)
                                 for a, b in zip(first, res)):
                        raise AssertionError(f"{loop}: {const} = {every} "
                                             "changes the result")
        finally:
            setattr(mod, const, default)
        cs.log("cadence", loop=loop, constant=const, default=default,
               **({"regions": n, "shape": list(labels.shape)}
                  if loop == "affine_parametric_flow" else {}),
               **{f"ms_every_{k}": v for k, v in ms.items()})


FLAGSHIP_ROUNDS = 4


def flagship_pairs(cs, dev) -> None:
    """The flagship with its defaults on chip_smoke.py's Voronoi pan:
    pair 1 (cold, unidirectional) and pair 2 (bidirectional) from an empty
    state, one warm-up round, then FLAGSHIP_ROUNDS rounds, host clock
    around each synced pair (the caller's view)."""
    import torch

    from tpuflow_torch.solvers.bm_flow import BMFlowState

    frames, _ = cs.voronoi_frames()
    times = []
    for r in range(FLAGSHIP_ROUNDS + 1):
        state = BMFlowState()
        pair_ms = []
        for k in (0, 1):
            t0 = time.perf_counter()
            cs.bm_pair(frames, k, state, dev)
            torch.cuda.synchronize()
            pair_ms.append(1e3 * (time.perf_counter() - t0))
        if r:
            times.append(pair_ms)
    cs.log("rows", flagship="default", shape=cs.BM_SHAPE,
           card_ms_pair1_cold=[t[0] for t in times],
           card_ms_pair2_bidirectional=[t[1] for t in times])


LAB_ROUNDS = 5


def lab_threads(cs, dev) -> None:
    """bm_flow._to_lab on the flagship's 376x1240 middle frame, host clock,
    at the process's default torch thread count and at one thread in
    turns: after each switch of the count, the first call (it pays for
    the switch) and the call after it, one warm-up round, then LAB_ROUNDS
    rounds; the pixels whose Lab differs between the two counts."""
    import torch

    from tpuflow_torch.solvers import bm_flow

    frame = cs.voronoi_frames()[0][1]
    default = torch.get_num_threads()
    ms = {(n, k): [] for n in (default, 1) for k in ("first", "next")}
    labs = {}
    try:
        for r in range(LAB_ROUNDS + 1):
            for n in (default, 1):
                torch.set_num_threads(n)
                for k in ("first", "next"):
                    t0 = time.perf_counter()
                    labs[n] = bm_flow._to_lab(frame, 255.0)[1]
                    if r:
                        ms[n, k].append(1e3 * (time.perf_counter() - t0))
    finally:
        torch.set_num_threads(default)
    d = (labs[default] - labs[1]).abs()
    cs.log("rows", lab="_to_lab", shape=list(frame.shape[:2]),
           default_threads=default,
           **{f"ms_{'default_threads' if n == default else 'one_thread'}_"
              f"{k}": v for (n, k), v in ms.items()},
           pixels_differing=int((d.amax(-1) > 0).sum()),
           max_abs_d=float(d.max()))


def demo_split(cs, dev) -> None:
    """The HS demo at chip_smoke.py's DEMO_SHAPE on the card, its stages
    timed apart on the host clock through the calls the demo makes (the
    two frame reads with the gray conversion, the solve with its copy to
    the host, the two matrix dumps, the quiver, the PNG), three times
    after a warm-up run of every demo; then each demo call under one
    torch.profiler frame (the card's busy time, idle share, top ops)."""
    import tempfile

    import numpy as np
    import torch

    from tpuflow_torch.core.io import write_image, write_matrix_txt
    from tpuflow_torch.pipeline import demos
    from tpuflow_torch.solvers import horn_schunck
    from tpuflow_torch.viz.quiver import plot_quiver

    names = ("read", "solve", "matrix_dumps", "quiver", "png")
    with tempfile.TemporaryDirectory(prefix="tpuflow_demo_split_") as tmp:
        tmp = Path(tmp)
        files = cs.write_demo_files(tmp)
        runs = cs.demo_runs(files, tmp, dev)
        for fn, _ in runs.values():
            fn()

        def stages():
            t = [time.perf_counter()]
            prev_raw, _, g0, g1 = demos._load_gray_pair(*files[".pgm"])
            t.append(time.perf_counter())
            u, v = demos._host(*horn_schunck(
                *demos._on(dev, torch.float32, g0, g1),
                cs.HS_WINDOW, cs.HS_ITERS, cs.HS_ALPHA))
            t.append(time.perf_counter())
            write_matrix_txt(tmp / "split_uMatrixHS.txt", u, "u matrix")
            write_matrix_txt(tmp / "split_vMatrixHS.txt", v, "v matrix")
            t.append(time.perf_counter())
            quiver = plot_quiver(prev_raw, u, v, delta=20, scale=20.0,
                                 outlier=5)
            t.append(time.perf_counter())
            write_image(tmp / "split_hsbresenhamLineFlow.png", quiver)
            t.append(time.perf_counter())
            return 1e3 * np.diff(t)

        rows = [stages() for _ in range(3)]
        cs.log("demos", demo="hs", split="stages", shape=cs.DEMO_SHAPE,
               **{f"{n}_ms": [float(r[i]) for r in rows]
                  for i, n in enumerate(names)})
        for name, (fn, _) in runs.items():
            cs.profile_frame("demos", fn, top=4, demo=name)


SPECIAL = {"fb_profiled": fb_profiled, "blur_ab": blur_ab,
           "lk_affine": lk_affine, "sync_cadence": sync_cadence,
           "flagship_pairs": flagship_pairs, "lab_threads": lab_threads,
           "demo_split": demo_split}


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
