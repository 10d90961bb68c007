#!/usr/bin/env python3
"""Drive tpuflow_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own numbers:

1. device  — the card's name and power limit; TF32 off for the plain
   float32 references.
2. build   — builds both CUDA kernels from ``tpuflow_torch/csrc`` (nvcc,
   into ``build/tpuflow_torch``) and reports seconds and ptxas usage.
3. kernels — each kernel against its plain PyTorch version on the card, on
   random float32 fields from a numpy seed: HS 100 sweeps at 1080x1920
   and IRLS 512 sweeps at 376x1240 (each at its main-path fuse and at a
   fuse that leaves a remainder), and both at 375x1242 (the ragged KITTI
   size); with both versions' times on the card.
4. main    — the launch counters are zeroed, then the main path runs once
   through the public entry points: ``solvers.horn_schunck`` at 1080x1920
   (100 iterations, 5x5, alpha 1) and ``optical_flow_pyramid_fast`` at
   376x1240 (5 levels, 512 sweeps per level, fuse 16), on the frames of
   bench.py's ``_frames_1080p``/``_frames_kitti``. Each counter must show
   its kernel ran exactly as often as that path launches it.
5. hs, ba  — the main-path results are finite and agree with the same
   calls on float32 CPU copies (which take the plain versions); the BA
   block counts per level agree; end-to-end times on the card.

Before the last line it prints the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. A failed phase raises: the script exits
non-zero and prints no ``ok`` line. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

HS_SHAPE = (1080, 1920)
HS_ITERS, HS_WINDOW, HS_ALPHA = 100, 5, 1.0
BA_SHAPE = (376, 1240)
BA_LEVEL, BA_ITER_MAX, BA_FUSE = 5, 512, 16
RAGGED_SHAPE = (375, 1242)
# Tolerances, as max|d| <= TOL * max(1, max|reference|).
# Kernel vs its plain version on the card: both compute in float32 and
# round after every operation (the kernels are built with -fmad=false and
# sum in the plain versions' order), so they agree to the last bit on the
# H100 (measured max|d| = 0); the bound admits last-bit differences only.
KERNEL_TOL = 1e-6
# The card's main path vs the same call on float32 CPU copies: the plain
# PyTorch ops of the pyramid and the energy checks run on two devices'
# libraries. Measured on the H100: 0 for HS, 1.7e-6 for BA (|u| <= 0.25).
PATH_TOL = 1e-5


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def max_err(pairs) -> tuple[float, float]:
    """(max |a - b| over all pairs, max |b|)."""
    err = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in pairs)
    ref = max(float(b.abs().max()) for _, b in pairs)
    return err, ref


def check_close(name: str, pairs, tol: float) -> float:
    err, ref = max_err(pairs)
    bound = tol * max(1.0, ref)
    if not err <= bound:
        raise AssertionError(f"{name}: max|d|={err} > {bound} "
                             f"(max|ref|={ref})")
    return err


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 1) -> float:
    """Median host-clock time of fn() in ms (CPU reference runs)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def frames_1080p():
    """bench.py::_frames_1080p."""
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, HS_SHAPE)
    nxt = np.roll(prev, 2, axis=1) + rng.normal(0, 1, HS_SHAPE)
    return prev, nxt


def frames_kitti():
    """bench.py::_frames_kitti."""
    from scipy.ndimage import gaussian_filter

    kh, kw = BA_SHAPE
    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (kh + 8, kw + 8)), 2.0)
    return base[:kh, :kw].copy(), base[4 : 4 + kh, 2 : 2 + kw].copy()


def f32(dev, *arrays):
    import torch

    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs on the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", name=json.dumps(name), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(smi, flush=True)
    return name


def phase_build() -> None:
    from tpuflow_torch.kernels import _build, hs_stencil, irls_stencil

    for mod, name in ((hs_stencil, "hs_stencil"),
                      (irls_stencil, "irls_stencil")):
        t0 = time.perf_counter()
        mod._lib()
        log("build", kernel=name, seconds=round(time.perf_counter() - t0, 3))
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("    " + line.strip(), flush=True)


def hs_fields(shape, seed):
    rng = np.random.default_rng(seed)
    gx, gy = rng.normal(size=shape), rng.normal(size=shape)
    gt = 0.3 * rng.normal(size=shape)
    u, v = 0.5 * rng.normal(size=shape), 0.5 * rng.normal(size=shape)
    return u, v, gx, gy, gt, 1.0 / (1.0 + gx * gx + gy * gy)


def irls_fields(shape, seed):
    rng = np.random.default_rng(seed)
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy = 0.05 * rng.normal(size=shape), 0.05 * rng.normal(size=shape)
    it = 0.02 * rng.normal(size=shape)
    return u, v, gx, gy, it


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, at the main-path
    shape and at the ragged KITTI size; both versions timed at each.
    Returns the numbers at the main-path shapes."""
    import torch

    from tpuflow_torch.kernels import hs_stencil, irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    out = {}
    hs_fuse = hs_stencil.DEFAULT_FUSE
    for shape in (HS_SHAPE, RAGGED_SHAPE):
        fields = f32(dev, *hs_fields(shape, 3))
        plain = hs_stencil.hs_sweeps_plain(*fields, HS_WINDOW, HS_ITERS)
        err = 0.0
        for fuse in (hs_fuse, 7):
            got = hs_stencil.hs_iterate(*fields, HS_WINDOW, HS_ITERS, fuse)
            err = max(err, check_close(f"hs_sweeps {shape} fuse {fuse}",
                                       list(zip(got, plain)), KERNEL_TOL))
            log("kernels", kernel="hs_sweeps", shape=shape, sweeps=HS_ITERS,
                fuse=fuse, max_abs_err=err)
        ms = cuda_ms(lambda: hs_stencil.hs_iterate(
            *fields, HS_WINDOW, HS_ITERS, hs_fuse))
        plain_ms = cuda_ms(lambda: hs_stencil.hs_sweeps_plain(
            *fields, HS_WINDOW, HS_ITERS), reps=3)
        log("kernels", kernel="hs_sweeps", shape=shape, sweeps=HS_ITERS,
            fuse=hs_fuse, ms=ms, plain_ms=plain_ms)
        out.setdefault("hs_sweeps", {"max_abs_err": err, "ms": ms,
                                     "plain_ms": plain_ms})
        torch.cuda.synchronize()

    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    for shape in (BA_SHAPE, RAGGED_SHAPE):
        u, v, gx, gy, it = f32(dev, *irls_fields(shape, 4))
        sup = irls_sup(gx, gy, *consts)

        def plain():
            return irls_stencil.irls_sweeps_plain(u, v, gx, gy, it, *sup,
                                                  BA_ITER_MAX, *consts)

        def run(fuse):
            n_full, rem = divmod(BA_ITER_MAX, fuse)
            a, b = u, v
            for k in [fuse] * n_full + ([rem] if rem else []):
                a, b = irls_stencil.irls_sweeps(a, b, gx, gy, it, *sup, k,
                                                *consts)
            return a, b

        ref = plain()
        err = 0.0
        for fuse in (BA_FUSE, 15):
            err = max(err, check_close(f"irls_sweeps {shape} fuse {fuse}",
                                       list(zip(run(fuse), ref)), KERNEL_TOL))
            log("kernels", kernel="irls_sweeps", shape=shape,
                sweeps=BA_ITER_MAX, fuse=fuse, max_abs_err=err)
        ms = cuda_ms(lambda: run(BA_FUSE))
        plain_ms = cuda_ms(plain, reps=3)
        log("kernels", kernel="irls_sweeps", shape=shape, sweeps=BA_ITER_MAX,
            fuse=BA_FUSE, ms=ms, plain_ms=plain_ms)
        out.setdefault("irls_sweeps", {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms})
        torch.cuda.synchronize()
    return out


def ba_call(prev, nxt, blocks=None):
    from tpuflow_torch.core.config import MultipleMotionParam
    from tpuflow_torch.solvers.black_anandan_fast import (
        optical_flow_pyramid_fast)

    param = MultipleMotionParam(level=BA_LEVEL, error_min_threshold=0.0)
    return optical_flow_pyramid_fast(prev, nxt, 255.0, param,
                                     iter_max=BA_ITER_MAX, fuse=BA_FUSE,
                                     blocks=blocks)


def phase_main(dev):
    """The main path once, counters zeroed just before and read just after."""
    import torch

    from tpuflow_torch import solvers
    from tpuflow_torch.kernels import hs_stencil, irls_stencil

    hs_frames = f32(dev, *frames_1080p())
    ba_frames = f32(dev, *frames_kitti())
    blocks = []
    hs_stencil.LAUNCHES = 0
    irls_stencil.LAUNCHES = 0
    hs_flow = solvers.horn_schunck(*hs_frames, HS_WINDOW, HS_ITERS, HS_ALPHA)
    ba_flow = ba_call(*ba_frames, blocks=blocks)
    torch.cuda.synchronize()
    launches = {"hs_sweeps": hs_stencil.LAUNCHES,
                "irls_sweeps": irls_stencil.LAUNCHES}
    hs_expected = math.ceil(HS_ITERS / hs_stencil.DEFAULT_FUSE)
    log("main", hs_launches=launches["hs_sweeps"], hs_expected=hs_expected,
        irls_launches=launches["irls_sweeps"], ba_blocks=blocks)
    if launches["hs_sweeps"] != hs_expected:
        raise AssertionError(f"HS kernel launched {launches['hs_sweeps']} "
                             f"times, expected {hs_expected}")
    if launches["irls_sweeps"] != sum(blocks) or not blocks:
        raise AssertionError(f"IRLS kernel launched "
                             f"{launches['irls_sweeps']} times for blocks "
                             f"{blocks}")
    return launches, (hs_frames, hs_flow), (ba_frames, ba_flow, blocks)


def phase_hs(frames, flow) -> None:
    import torch

    from tpuflow_torch import solvers

    if flow[0].shape != HS_SHAPE or not all(
            bool(torch.isfinite(f).all()) for f in flow):
        raise AssertionError("HS flow is not finite of shape "
                             f"{HS_SHAPE}: {tuple(flow[0].shape)}")
    cpu = [f.cpu() for f in frames]
    ref = []
    cpu_ms = host_ms(lambda: ref.extend(
        solvers.horn_schunck(*cpu, HS_WINDOW, HS_ITERS, HS_ALPHA)))
    err = check_close("horn_schunck card vs CPU", list(zip(flow, ref)),
                      PATH_TOL)
    ms = cuda_ms(lambda: solvers.horn_schunck(*frames, HS_WINDOW, HS_ITERS,
                                              HS_ALPHA))
    torch.cuda.synchronize()
    log("hs", shape=HS_SHAPE, max_abs_err_vs_cpu=err, max_abs_u=float(
        flow[0].abs().max()), card_ms_per_frame=ms,
        card_fps=1e3 / ms, cpu_f32_ms_per_frame=cpu_ms)


def phase_ba(frames, flow, blocks) -> None:
    import torch

    if flow[0].shape != BA_SHAPE or not all(
            bool(torch.isfinite(f).all()) for f in flow):
        raise AssertionError("BA flow is not finite of shape "
                             f"{BA_SHAPE}: {tuple(flow[0].shape)}")
    cpu = [f.cpu() for f in frames]
    ref, cpu_blocks = [], []
    cpu_ms = host_ms(lambda: ref.extend(ba_call(*cpu, blocks=cpu_blocks)))
    if cpu_blocks != blocks:
        raise AssertionError(f"BA blocks per level: card {blocks}, "
                             f"CPU {cpu_blocks}")
    err = check_close("optical_flow_pyramid_fast card vs CPU",
                      list(zip(flow, ref)), PATH_TOL)

    def run():
        ba_call(*frames)
        torch.cuda.synchronize()

    ms = host_ms(run, reps=5)  # syncs at every energy check anyway
    log("ba", shape=BA_SHAPE, blocks=blocks, max_abs_err_vs_cpu=err,
        max_abs_u=float(flow[0].abs().max()), card_ms_per_frame=ms,
        card_fps=1e3 / ms, cpu_f32_ms_per_frame=cpu_ms)


def main() -> None:
    sys.path.insert(0, str(REPO))
    name = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    numbers = phase_kernels(dev)
    launches, hs, ba = phase_main(dev)
    phase_hs(*hs)
    phase_ba(*ba)
    kernels = []
    for kname, source, replaces in (
            ("hs_sweeps", "tpuflow_torch/csrc/hs_stencil.cu",
             "tpuflow/kernels/hs_stencil.py:706"),
            ("irls_sweeps", "tpuflow_torch/csrc/irls_stencil.cu",
             "tpuflow/kernels/irls_stencil.py:391")):
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[kname], **numbers[kname]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
