#!/usr/bin/env python3
"""Design variants of tpuflow_torch/csrc/ms_filter.cu and the poly
expansion and blur-solve of tpuflow_torch/csrc/fb_kernels.cu on one card.

    python3 scripts/ms_poly_variants.py [--only ms|poly|blur] [--sass PATH]

Builds each source as committed and with one change substituted (VARIANTS
below: for the mean-shift filter the planar and the float2 + float
layouts of the staged tile, no fixed-point exit, one point staged per
round trip, the run loop unrolled by 2 or 8; for the poly expansion two
blocks per SM instead of four; for the blur-solve one channel's row sums
staged at a time, two barriers a channel, instead of all five, and two
blocks per SM at the compiled winsizes instead of three), one nvcc
each, all started together, into
build/ms_poly_variants/; binds each library in turn into the wrapper
module (``tpuflow_torch.kernels.ms_filter`` or ``fb_kernels``) and runs
the rows through the wrappers, the committed build first and last, the
variants between. Mean-shift: R = 20, 8 iterations on the flagship
scene's 376x1240 Lab frame, bitwise against the plain version computed
once, at the query rows the launcher picks and at FORCED_ROWS; the
committed build also in the wide form (forced: nothing staged), at ITERS
iterations (the fixed cost of a launch and each iteration's), and the
share of queries settled after each iteration. Poly expansion: chip_smoke.py's ``poly_rows`` (each row within
KERNEL_TOL, max|d| logged). Blur-solve: chip_smoke.py's ``blur_rows`` at
BLUR_AB. One JSON line per run: the variant, device ms per row, ptxas's
registers and spills, blocks per SM. The SASS of the
committed mean-shift kernel (``cuobjdump -sass``) goes to ``--sass``
(build/ms_poly_variants/ms_filter.sass by default). The first lines are
chip_smoke.py's device phase (the card's name and power limit). Exits 1
without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "ms_poly_variants"
PLANAR = """struct Planar {
  static constexpr int BYTES = 12;
  float* t;
  int n;
  __device__ Planar(void* smem, int points) : t((float*)smem), n(points) {}
  __device__ void store(int i, float L, float a, float b) const {
    t[i] = L;
    t[n + i] = a;
    t[2 * n + i] = b;
  }
  __device__ float4 load(int i) const {
    return make_float4(t[i], t[n + i], t[2 * n + i], 0.f);
  }
};
using Layout = Planar;"""
SPLIT = """struct Split {
  static constexpr int BYTES = 12;
  float2* t2;
  float* t1;
  __device__ Split(void* smem, int points)
      : t2((float2*)smem), t1((float*)smem + 2 * points) {}
  __device__ void store(int i, float L, float a, float b) const {
    t2[i] = make_float2(L, a);
    t1[i] = b;
  }
  __device__ float4 load(int i) const {
    const float2 u = t2[i];
    return make_float4(u.x, u.y, t1[i], 0.f);
  }
};
using Layout = Split;"""
MS_EXIT = "    if (fixed) break;\n"
MS_LOOP = ("#pragma unroll 4\n"
           "      for (int tag = key + lo; tag < end; ++tag) {")
POLY_BOUNDS = "__launch_bounds__(P_THREADS, N > 0 ? 4 : 2)"
BLUR_BOUNDS = "__launch_bounds__(B_THREADS, W > 0 ? 3 : 2)"
# (kernel, name, [(committed text, substitute), ...]); [] is as committed.
VARIANTS = (
    ("ms", "committed", []),
    ("ms", "planar", [("using Layout = Interleaved;", PLANAR)]),
    ("ms", "split", [("using Layout = Interleaved;", SPLIT)]),
    ("ms", "no_exit", [(MS_EXIT, "")]),
    ("ms", "stage_batch1", [("constexpr int STAGE_BATCH = 8;",
                             "constexpr int STAGE_BATCH = 1;")]),
    ("ms", "unroll2", [(MS_LOOP, MS_LOOP.replace("unroll 4", "unroll 2"))]),
    ("ms", "unroll8", [(MS_LOOP, MS_LOOP.replace("unroll 4", "unroll 8"))]),
    ("poly", "committed", []),
    ("poly", "bounds2", [(POLY_BOUNDS, "__launch_bounds__(P_THREADS, 2)")]),
    ("blur", "committed", []),
    ("blur", "one_channel", [("constexpr int B_GROUP = 5;",
                              "constexpr int B_GROUP = 1;")]),
    ("blur", "bounds2", [(BLUR_BOUNDS, "__launch_bounds__(B_THREADS, 2)")]),
)
SOURCE = {"ms": "ms_filter", "poly": "fb_kernels", "blur": "fb_kernels"}
FORCED_ROWS = (16, 19)
ITERS = (0, 1, 2)


def build(variant):
    from tpuflow_torch.kernels import _build

    kernel, name, subs = variant
    src = (_build.CSRC / f"{SOURCE[kernel]}.cu").read_text()
    for old, new in subs:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    cu = OUT / f"{kernel}_{name}.cu"
    cu.write_text(src)
    so = OUT / f"lib{kernel}_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{kernel} {name}: nvcc failed\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


def ms_run(cs, dev, name, lab, want, report) -> dict:
    import torch

    from tpuflow_torch.kernels import ms_filter

    E = ms_filter.window(cs.MS_R, None)
    picked = ms_filter.tile_rows(E)
    rows = {}
    tile_rows = ms_filter.tile_rows
    try:
        for th in sorted({picked, *FORCED_ROWS}):
            ms_filter.tile_rows = lambda E, th=th: th

            def run():
                return ms_filter.mean_shift_filter(lab, cs.MS_R, cs.MS_KI,
                                                   cs.MS_ITERS)

            cs.exact(f"ms {name} th {th}", run(), want)
            rows[f"th{th}_iters{cs.MS_ITERS}_ms"] = cs.cuda_ms(
                run, reps=5, device_only=True)
            rows[f"th{th}_blocks_per_sm"] = ms_filter.blocks_per_sm(E, th)
    finally:
        ms_filter.tile_rows = tile_rows
    if name == "committed":
        # The wide form (nothing staged) at the same window, bitwise too:
        # what staging saves, and so the most a banded staging of a wide
        # window could.
        form_for = ms_filter.form_for
        try:
            ms_filter.form_for = lambda E: "wide"

            def wide():
                return ms_filter.mean_shift_filter(lab, cs.MS_R, cs.MS_KI,
                                                   cs.MS_ITERS)

            cs.exact(f"ms {name} wide form", wide(), want)
            rows[f"wide_iters{cs.MS_ITERS}_ms"] = cs.cuda_ms(
                wide, reps=5, device_only=True)
        finally:
            ms_filter.form_for = form_for
        for iters in ITERS:
            rows[f"th{picked}_iters{iters}_ms"] = cs.cuda_ms(
                lambda iters=iters: ms_filter.mean_shift_filter(
                    lab, cs.MS_R, cs.MS_KI, iters), reps=5, device_only=True)
        # Share of queries whose (pos, col) after k iterations equals, bit
        # for bit, that after k - 1: settled, as far as the outputs show.
        prev = None
        settled = []
        for k in range(cs.MS_ITERS + 1):
            out = torch.cat([t.reshape(-1, t.shape[-1]) for t in
                             ms_filter.mean_shift_filter(lab, cs.MS_R,
                                                         cs.MS_KI, k)], 1)
            bits = out.contiguous().view(torch.int32)
            if prev is not None:
                settled.append(float((bits == prev).all(1).float().mean()))
            prev = bits
        rows["settled_share_by_iteration"] = settled
    return {"kernel": "mean_shift_filter", "variant": name,
            "picked_rows": picked, **rows, "ptxas": cs.read_ptxas(report)}


def poly_run(cs, dev, name, report) -> dict:
    out = {}
    cs.poly_rows(dev, out, usage=False)
    from tpuflow_torch.kernels import fb_kernels

    return {"kernel": "fb_poly_expansion", "variant": name, "rows": [
        {"shape": r["shape"], "n": r["n"], "ms": r["ms"],
         "max_abs_err": r["max_abs_err"],
         "blocks_per_sm": fb_kernels.poly_blocks_per_sm(2 * r["n"] + 1)}
        for r in out["fb_poly_expansion"]["rows"]],
        "ptxas": {k: v for k, v in cs.read_ptxas(report).items()
                  if "poly" in k}}


def blur_run(cs, dev, name, report) -> dict:
    out = {}
    cs.blur_rows(dev, out, usage=False, cases=cs.BLUR_AB)
    from tpuflow_torch.kernels import fb_kernels

    return {"kernel": "fb_blur_solve", "variant": name, "rows": [
        {"shape": r["shape"], "winsize": r["winsize"], "ms": r["ms"],
         "max_abs_err": r["max_abs_err"],
         "blocks_per_sm": fb_kernels.blur_blocks_per_sm(r["winsize"])}
        for r in out["fb_blur_solve"]["rows"]],
        "ptxas": {k: v for k, v in cs.read_ptxas(report).items()
                  if "blur" in k}}


RUN = {"poly": poly_run, "blur": blur_run}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("ms", "poly", "blur"))
    ap.add_argument("--sass", type=Path, default=OUT / "ms_filter.sass")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # noqa: E402  (imports tpuflow_torch lazily)
    import torch

    cs.phase_device()  # exits without a card
    dev = torch.device("cuda", 0)
    from tpuflow_torch.kernels import fb_kernels, ms_filter
    from tpuflow_torch.solvers import bm_flow

    variants = [v for v in VARIANTS if args.only in (None, v[0])]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(((k, n) for k, n, _ in variants),
                         pool.map(build, variants)))
    if ("ms", "committed") in built:
        sass = subprocess.run(
            [shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
             "-sass", str(built[("ms", "committed")][0])],
            capture_output=True, text=True).stdout
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(sass)
        lab = bm_flow._to_lab(cs.voronoi_frames()[0][1], 255.0)[1].to(dev)
        want = ms_filter.mean_shift_filter_plain(lab, cs.MS_R, cs.MS_KI,
                                                 cs.MS_ITERS)
    order = {}
    for kernel, name, _ in variants:
        order.setdefault(kernel, []).append(name)
    for kernel, names in order.items():
        module = ms_filter if kernel == "ms" else fb_kernels
        for name in [*names, "committed"]:
            so, report = built[(kernel, name)]
            lib = ctypes.CDLL(str(so))
            lib = ms_filter._bind(lib) if kernel == "ms" else \
                fb_kernels._bind(lib)
            module._lib = lambda lib=lib: lib
            row = (ms_run(cs, dev, name, lab, want, report) if kernel == "ms"
                   else RUN[kernel](cs, dev, name, report))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
