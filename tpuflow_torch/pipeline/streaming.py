"""Dense streaming flow (port of the Farneback part of
:mod:`tpuflow.pipeline.streaming`).

- :func:`dense_flow_stream` — VideoDenseOF (``DenseFlow.cpp:12-59``): per
  frame, grayscale, resize to the working resolution (640x480 in the
  demo), dense Farneback against the previous frame ((0.4, 1, 48, 2, 8,
  1.2), line 37). The previous gray frame is the carried state (line
  51); optionally the previous flow seeds the next solve
  (OPTFLOW_USE_INITIAL_FLOW).
- :func:`dense_flow_stream_batched` — the same per-pair math over a
  (T, H, W) clip, returning (T-1, H, W) stacks.
- :class:`SyntheticSource` — a moving smoothed-noise texture.

Both stream functions take numpy frames, as tpuflow's do, and an explicit
``device`` to run on: the port never picks one. Frames go there as
float32, as in tpuflow's streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

from tpuflow_torch.core.color import rgb_to_gray
from tpuflow_torch.core.resample import resize_zero_order_hold
from tpuflow_torch.solvers.farneback import calc_optical_flow_farneback
from tpuflow_torch.utils.telemetry import get_telemetry


class SyntheticSource:
    """Moving smoothed-noise texture with constant (dx, dy) per frame."""

    def __init__(self, n_frames: int = 10, h: int = 120, w: int = 160,
                 dx: float = 2.0, dy: float = 0.0, seed: int = 0):
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(seed)
        margin = int(abs(dx) * n_frames + abs(dy) * n_frames) + 4
        base = rng.uniform(0, 255, (h + 2 * margin, w + 2 * margin))
        self.base = gaussian_filter(base, 2.0)
        self.n_frames = n_frames
        self.h, self.w = h, w
        self.dx, self.dy = dx, dy
        self.margin = margin

    def __iter__(self) -> Iterator[np.ndarray]:
        from scipy.ndimage import shift as ndshift

        for i in range(self.n_frames):
            ox = self.margin + self.dx * i
            oy = self.margin + self.dy * i
            yield ndshift(self.base, (-oy, -ox), order=1)[: self.h, : self.w]


@dataclass
class DenseStreamState:
    prev_gray: np.ndarray | None = None
    prev_flow: tuple | None = None


def dense_flow_stream(
    frames: Iterable[np.ndarray],
    working_size: tuple[int, int] | None = (640, 480),
    pyr_scale: float = 0.4,
    levels: int = 1,
    winsize: int = 48,
    iterations: int = 2,
    poly_n: int = 8,
    poly_sigma: float = 1.2,
    warm_start_flow: bool = False,
    state: DenseStreamState | None = None,
    *,
    device: torch.device | str,
):
    """Yields (gray_frame, u, v) as numpy arrays per frame after the first
    (DenseFlow.cpp's loop; parameters from line 37), computed on
    ``device``."""
    if state is None:
        state = DenseStreamState()
    tel = get_telemetry()
    prev = None
    if state.prev_gray is not None:
        prev = torch.as_tensor(state.prev_gray, dtype=torch.float32,
                               device=device)
    for i, frame in enumerate(frames):
        gray = torch.as_tensor(np.asarray(frame), dtype=torch.float32,
                               device=device)
        if gray.dim() == 3:
            gray = rgb_to_gray(gray)
        if working_size is not None:
            gray = resize_zero_order_hold(gray, working_size)
        gray_np = gray.cpu().numpy()
        if prev is not None:
            flags = 0x100 if (warm_start_flow and state.prev_flow) else 0
            init = None
            if flags:
                init = tuple(torch.as_tensor(f, dtype=torch.float32,
                                             device=device)
                             for f in state.prev_flow)
            u, v = calc_optical_flow_farneback(
                prev, gray, init, pyr_scale, levels, winsize, iterations,
                poly_n, poly_sigma, flags)
            u = u.cpu().numpy()
            v = v.cpu().numpy()
            state.prev_flow = (u, v)
            tel.event("stream.dense", frame=i, mean_u=float(u.mean()),
                      mean_v=float(v.mean()))
            yield gray_np, u, v
        state.prev_gray = gray_np
        prev = gray


def dense_flow_stream_batched(
    frames: np.ndarray,
    pyr_scale: float = 0.4,
    levels: int = 1,
    winsize: int = 48,
    iterations: int = 2,
    poly_n: int = 8,
    poly_sigma: float = 1.2,
    *,
    device: torch.device | str,
):
    """:func:`dense_flow_stream`'s per-pair math (flags=0, zero initial
    flow) over a (T, H, W) gray clip on ``device``; returns the (u, v)
    stacks, each (T-1, H, W). tpuflow scans the clip inside one jit; here
    the pairs run in a Python loop."""
    clip = torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                           device=device)
    us, vs = [], []
    for t in range(1, clip.shape[0]):
        u, v = calc_optical_flow_farneback(
            clip[t - 1], clip[t], None, pyr_scale, levels, winsize,
            iterations, poly_n, poly_sigma, 0)
        us.append(u)
        vs.append(v)
    return torch.stack(us), torch.stack(vs)
