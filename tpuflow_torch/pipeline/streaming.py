"""Frame streams (port of :mod:`tpuflow.pipeline.streaming`).

- :func:`dense_flow_stream` — VideoDenseOF (``DenseFlow.cpp:12-59``): per
  frame, grayscale, resize to the working resolution (640x480 in the
  demo), dense Farneback against the previous frame ((0.4, 1, 48, 2, 8,
  1.2), line 37). The previous gray frame is the carried state (line
  51); optionally the previous flow seeds the next solve
  (OPTFLOW_USE_INITIAL_FLOW).
- :func:`dense_flow_stream_batched` — the same per-pair math over a
  (T, H, W) clip, returning (T-1, H, W) stacks.
- :func:`bm_flow_stream` — the flagship over a frame iterable, each
  pair's output yielded when the next frame has been dispatched.
- :func:`feature_tracking_stream` — VideoFeaturesOF
  (``FeaturesOpticalFlow.cpp:44-130``) and the LucasKanadeOF pair demo:
  goodFeaturesToTrack seeding (maxCount 500, quality 0.01, minDist 10),
  pyramidal LK tracking, accept rule ``status && |dx|+|dy| > 2``,
  re-seed when <= 10 tracks survive.
- Frame sources: :class:`ImageSequenceSource` (a printf pattern over
  image files, binary PNM optionally decoded ahead on the native
  library's worker threads), :func:`video_source` (OpenCV, imported at
  first use) and :class:`SyntheticSource` (a moving smoothed-noise
  texture).

The streams take numpy frames, as tpuflow's do, and run on ``device``:
the card unless the caller passes ``device="cpu"``. Frames go there as
float32, the dtype the kernels take, as in tpuflow's dense streams; the
tracked points stay float64 numpy, as tpuflow yields them. State objects
are explicit dataclasses (checkpoint and resume).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from tpuflow_torch.core import io as tio
from tpuflow_torch.core.color import rgb_to_gray
from tpuflow_torch.core.resample import resize_zero_order_hold
from tpuflow_torch.solvers.bm_flow import optical_flow_block_matching_async
from tpuflow_torch.solvers.farneback import calc_optical_flow_farneback
from tpuflow_torch.solvers.lucas_kanade import (accept_tracked_point,
                                                good_features_to_track,
                                                track_points)
from tpuflow_torch.utils.telemetry import get_telemetry


class ImageSequenceSource:
    """Frames from a printf-style filename pattern (``%0Nd``).

    ``prefetch=True`` decodes a binary PNM sequence ahead on native worker
    threads (:class:`tpuflow_torch.native.FramePrefetcher`), so the device
    never waits on disk; other formats stream synchronously.
    """

    def __init__(self, pattern: str, start: int, end: int,
                 prefetch: bool = False, threads: int = 2):
        self.pattern = pattern
        self.start = start
        self.end = end
        self.prefetch = prefetch
        self.threads = threads

    def _paths(self):
        return [tio.expand_frame_pattern(self.pattern, num)
                for num in range(self.start, self.end + 1)]

    def __iter__(self) -> Iterator[np.ndarray]:
        paths = self._paths()
        if self.prefetch and all(
                str(p).lower().endswith((".pgm", ".ppm")) for p in paths):
            from tpuflow_torch.native import FramePrefetcher

            with FramePrefetcher(paths, threads=self.threads) as pf:
                for frame, _ in pf:
                    yield frame
            return
        for p in paths:
            frame, _ = tio.read_image(p)
            yield frame


def video_source(path: str | Path) -> Iterator[np.ndarray]:
    """RGB frames of a video file, read through OpenCV."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1]  # BGR -> RGB
    finally:
        cap.release()


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


def _gray_on(frame, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy frame as a gray image of ``dtype`` on ``device``."""
    gray = torch.as_tensor(np.asarray(frame), dtype=dtype, device=device)
    return rgb_to_gray(gray) if gray.dim() == 3 else gray


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
    device: torch.device | str = "cuda",
):
    """Yields (gray_frame, u, v) as numpy arrays per frame after the first
    (DenseFlow.cpp's loop; parameters from line 37), computed on
    ``device``."""
    if state is None:
        state = DenseStreamState()
    tel = get_telemetry()
    prev = None
    if state.prev_gray is not None:
        prev = _gray_on(state.prev_gray, device)
    for i, frame in enumerate(frames):
        gray = _gray_on(frame, device)
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
            if tel.enabled:
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
    device: torch.device | str = "cuda",
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


def bm_flow_stream(
    frames: Iterable[np.ndarray],
    max_int: float = 255.0,
    *,
    device: torch.device | str = "cuda",
    **driver_kwargs,
):
    """The flagship over a frame iterable, dispatch-ahead: each pair's
    work is issued before the previous pair's output is fetched
    (:func:`tpuflow_torch.solvers.bm_flow.optical_flow_block_matching_async`),
    so pair (f0, f1)'s :class:`BMFlowOutput` is yielded when frame f2 has
    been dispatched, and the last pair's when the iterable ends. From the
    second pair on the estimate is bidirectional for the middle frame
    (Scratch_MeaningfulMotion.cpp:544-552). ``driver_kwargs`` pass through
    to the driver, ``profile`` and ``mesh`` among them (on a mesh every
    rank runs the stream over the same frames). tpuflow's ``prewarm`` (compiling region-count buckets
    ahead) is a TPU workaround; this stream has no such argument."""
    tel = get_telemetry()
    state = pending = prev = None
    pending_frame = -1
    for i, frame in enumerate(frames):
        frame = np.asarray(frame)
        if prev is not None:
            finalize, state = optical_flow_block_matching_async(
                prev, frame, max_int, state=state, device=device,
                **driver_kwargs)
            if pending is not None:
                out = pending()
                tel.event("stream.bm_flow", frame=pending_frame,
                          bidirectional=bool(out.bidirectional))
                yield out
            pending, pending_frame = finalize, i
        prev = frame
    if pending is not None:
        out = pending()
        tel.event("stream.bm_flow", frame=pending_frame,
                  bidirectional=bool(out.bidirectional))
        yield out


@dataclass
class TrackingState:
    points: np.ndarray | None = None       # (N, 2) active tracks
    initial: np.ndarray | None = None      # seed positions of the tracks
    prev_gray: np.ndarray | None = None

    @classmethod
    def from_tpuflow(cls, state) -> "TrackingState":
        """Carry a tpuflow ``TrackingState`` across, by field name, as
        host arrays."""
        def copy(a):
            return None if a is None else np.array(a)

        return cls(points=copy(state.points), initial=copy(state.initial),
                   prev_gray=copy(state.prev_gray))


def feature_tracking_stream(
    frames: Iterable[np.ndarray],
    max_count: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    min_track_count: int = 10,
    min_motion: float = 2.0,
    win: int = 21,
    max_level: int = 3,
    state: TrackingState | None = None,
    *,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
):
    """Yields (gray, points, prev_points, status) as numpy arrays per
    tracked frame (VideoFeaturesOF tracking(), FeaturesOpticalFlow.cpp:
    85-130): seed when at most ``min_track_count`` tracks survive, track
    from the previous frame, keep the accepted tracks (cut to
    ``max_count`` after a re-seed). The corners and the tracking run on
    ``device`` in ``dtype``: float32 by default, the dtype the sepconv
    kernel takes on the card; float64 on the CPU is tpuflow's stream."""
    if state is None:
        state = TrackingState()
    tel = get_telemetry()
    prev = None
    if state.prev_gray is not None:
        prev = _gray_on(state.prev_gray, device, dtype)
    for i, frame in enumerate(frames):
        gray = _gray_on(frame, device, dtype)
        gray_np = gray.cpu().numpy()

        n_active = 0 if state.points is None else len(state.points)
        if n_active <= min_track_count:
            # addNewPoints (LucasKanadeOF.cpp:104-109)
            seeds = good_features_to_track(gray, max_count, quality_level,
                                           min_distance)
            if state.points is None or n_active == 0:
                state.points = seeds
                state.initial = seeds.copy()
            elif len(seeds):
                state.points = np.concatenate([state.points, seeds])[:max_count]
                state.initial = np.concatenate(
                    [state.initial, seeds])[:max_count]
            tel.event("stream.reseed", frame=i, count=len(state.points))

        if prev is not None and state.points is not None \
                and len(state.points):
            new_pts, status = track_points(prev, gray, state.points, win=win,
                                           max_level=max_level)
            new_pts = new_pts.cpu().numpy().astype(np.float64)
            accept = accept_tracked_point(state.points, new_pts,
                                          status.cpu(), min_motion).numpy()
            prev_pts = state.points
            state.points = new_pts[accept]
            state.initial = state.initial[accept]
            tel.event("stream.track", frame=i, kept=int(accept.sum()),
                      total=len(new_pts))
            yield gray_np, state.points, prev_pts[accept], accept
        state.prev_gray = gray_np
        prev = gray
