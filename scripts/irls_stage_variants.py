#!/usr/bin/env python3
"""Staged tiles of tpuflow_torch/csrc/irls_stencil.cu on one card.

    python3 scripts/irls_stage_variants.py
    python3 scripts/irls_stage_variants.py --repo DIR

Builds the source as it is (two staged tiles, WIDE and NARROW, one per
launch as its launcher picks) and with one other staged tile for every
launch (``using WIDE/NARROW = Stage<SH, CX, CY, blocks per SM>``), one nvcc
each, all started together, into build/irls_stage_variants/, and runs each
through the wrappers of ``tpuflow_torch.kernels.irls_stencil``. With
``--repo`` it builds nothing of its own and runs the wrappers of the
checkout at DIR, so that two checkouts can be compared in one run.

For each it prints one JSON line: chip_smoke.py's check of ``irls_sweeps``
at each level of BA's pyramid (512 sweeps at fuse 16, bitwise the plain
version, launches counted) with each level's device ms and their sum; the
``irls_tile_sweeps`` row (512 sweeps on one 376x1240 tile at fuse 16,
chained as chip_smoke.py's row runs it, bitwise its plain version) and its
device ms; for a variant, its blocks per SM (CUDA's occupancy calculator),
ptxas's registers and spills and its staged cell-sweeps per core
cell-sweep. The first lines are chip_smoke.py's device phase (the card's
name and power limit). Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (SH, CX, CY, blocks per SM in __launch_bounds__) for both stages; None
# is the source as committed.
VARIANTS = (None, (72, 4, 3, 1), (96, 3, 4, 1), (72, 4, 4, 1), (64, 4, 2, 1),
            (64, 4, 4, 1), (64, 2, 4, 2), (64, 2, 2, 1))
OUT = REPO / "build" / "irls_stage_variants"


def build(variant):
    from tpuflow_torch.kernels import _build

    name = "irls_as_committed" if variant is None else (
        "irls_{}x{}_cy{}_b{}".format(variant[0], 32 * variant[1],
                                     *variant[2:]))
    src = (_build.CSRC / "irls_stencil.cu").read_text()
    if variant is not None:
        src, n = re.subn(r"using (WIDE|NARROW) = Stage<[\d, ]+>;",
                         r"using \1 = Stage<{}, {}, {}, {}>;".format(*variant),
                         src)
        assert n == 2
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    so = OUT / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    return name, so, proc.stdout + proc.stderr


def measure(cs, dev) -> dict:
    """The pyramid's levels and the tile row through the wrappers."""
    import torch

    from tpuflow_torch.kernels import irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    u, v, *fixed = cs.f32(dev, *cs.irls_fields(cs.BA_SHAPE, 4))
    sup = irls_sup(fixed[0], fixed[1], *consts)
    # One second of sweeps brings the card's clocks up first.
    until = time.perf_counter() + 1.0
    while time.perf_counter() < until:
        irls_stencil.irls_sweeps(u, v, *fixed, *sup, cs.BA_FUSE, *consts)
        torch.cuda.synchronize()
    level_ms = cs.irls_levels(dev)

    def chain(sweep):
        return cs.tile_chain(sweep, u, v, fixed, cs.BA_SHAPE, cs.BA_ITER_MAX,
                             cs.BA_FUSE, 1, False, sup,
                             lambda k: (k, *consts))

    cs.exact("irls_tile_sweeps", chain(irls_stencil.irls_tile_sweeps),
             chain(irls_stencil.irls_tile_sweeps_plain))
    return {"levels": cs.ba_level_shapes(), "level_ms": level_ms,
            "pyramid_ms": sum(level_ms), "irls_sweeps_ms": level_ms[0],
            "irls_tile_sweeps_ms": cs.cuda_ms(
                lambda: chain(irls_stencil.irls_tile_sweeps),
                device_only=True),
            "max_abs_err": 0.0}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # noqa: E402  (imports tpuflow_torch lazily)

    if args.repo:
        sys.path.insert(0, str(args.repo.resolve()))
    import torch

    cs.phase_device()  # exits without a card
    dev = torch.device("cuda", 0)
    if args.repo:
        print(json.dumps({"repo": args.repo.resolve().name,
                          **measure(cs, dev)}), flush=True)
        return

    from tpuflow_torch.kernels import irls_stencil

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    for variant, (name, so, report) in zip(VARIANTS, built):
        lib = irls_stencil._bind(ctypes.CDLL(str(so)))
        irls_stencil._lib = lambda lib=lib: lib
        row = measure(cs, dev)
        if variant is None:
            (sh, sw), threads = irls_stencil.STAGE, irls_stencil.THREADS
        else:
            sh, sw, threads = (variant[0], 32 * variant[1],
                               32 * variant[0] // variant[2])
        fuse = cs.BA_FUSE
        core = (sh - 2 * fuse, sw - 2 * fuse)
        # Staged cells swept per core cell and sweep: sweep t covers
        # (SH - 2t) x (SW - 2t).
        swept = sum((sh - 2 * t) * (sw - 2 * t) for t in range(1, fuse + 1))
        print(json.dumps({
            "variant": name, **row, "wide_threads": threads,
            "smem_bytes": 6 * 4 * sh * sw,
            "blocks_at_fuse16": (-(-cs.BA_SHAPE[0] // core[0])
                                 * -(-cs.BA_SHAPE[1] // core[1])),
            "blocks_per_sm": {f"{s}_{k}": irls_stencil.blocks_per_sm(t, n)
                              for n, s in ((False, "wide"), (True, "narrow"))
                              for t, k in ((False, "sweeps"),
                                           (True, "tile"))},
            "cell_sweeps_per_core": swept / (fuse * core[0] * core[1]),
            "ptxas": {"{}_{}x{}_cy{}".format(
                m[1], m[2], 32 * int(m[3]), m[4]): u
                for k, u in cs.read_ptxas(report).items()
                if (m := re.search(r"(sweeps|tile)_kernel.*?StageILi(\d+)E"
                                   r"Li(\d+)ELi(\d+)E", k))}}),
              flush=True)


if __name__ == "__main__":
    main()
