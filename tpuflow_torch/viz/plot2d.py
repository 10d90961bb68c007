"""Segment rasterization + superimpose overlays (Plot/Plotting.cpp parity;
port of :mod:`tpuflow.viz.plot2d`).

- :func:`plot_segments` — PlotSegment (Plotting.cpp:5-58): rasterize the
  detected segments into a (H_out, W_out) intensity buffer with output
  rescale and optional negate (background 255 / foreground 0).
- :func:`superimpose` — Superimposer (Plotting.cpp:61-165): overlay the
  plot on the original as a pure-R/G/B channel boost with the other two
  channels halved; Negate replaces the chosen channel with the plot.
"""

from __future__ import annotations

import numpy as np

from tpuflow_torch.core.config import BLUE, GREEN, PLOT_INTENSITY_MAX, RED


def plot_segments(segments, size_in: tuple[int, int],
                  size_out: tuple[int, int] | None = None,
                  negate: bool = False) -> np.ndarray:
    """Rasterize segments (objects with n, m, x, y) -> (H_out, W_out) int."""
    w, h = size_in
    if size_out is None:
        size_out = size_in
    wo, ho = size_out
    fg = 0 if negate else PLOT_INTENSITY_MAX
    buf = np.full((ho, wo), PLOT_INTENSITY_MAX if negate else 0,
                  dtype=np.int64)
    sx = wo / w
    sy = ho / h
    for s in segments:
        n = int(round(s.n * sx))
        m = int(round(s.m * sy))
        x = int(round(s.x * sx))
        y = int(round(s.y * sy))
        L = max(abs(x - n), abs(y - m))
        if L == 0:
            buf[min(max(m, 0), ho - 1), min(max(n, 0), wo - 1)] = fg
            continue
        dx = (x - n) / L
        dy = (y - m) / L
        ts = np.arange(L + 1)
        xs = np.clip(np.round(n + dx * ts).astype(int), 0, wo - 1)
        ys = np.clip(np.round(m + dy * ts).astype(int), 0, ho - 1)
        buf[ys, xs] = fg
    return buf


def superimpose(img: np.ndarray, plot: np.ndarray, color: int = RED,
                negate: bool = False, maxint: int = 255) -> np.ndarray:
    """Overlay ``plot`` on ``img`` (gray (H,W) or RGB (H,W,3)) -> RGB.

    color in {RED, GREEN, BLUE}; non-negate: chosen channel += plot
    (clipped), other channels halved where plot > 0; negate: chosen
    channel replaced by the plot.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        rgb = np.stack([img] * 3, axis=-1).astype(np.float64)
    else:
        rgb = img.astype(np.float64).copy()
    plot = np.asarray(plot, dtype=np.float64)
    if maxint > PLOT_INTENSITY_MAX:
        plot = np.where(plot > 0,
                        np.round(plot * (maxint / PLOT_INTENSITY_MAX)), plot)
    ch = {RED: 0, GREEN: 1, BLUE: 2}.get(color, 0)
    others = [c for c in range(3) if c != ch]
    if negate:
        rgb[..., ch] = plot
    else:
        mask = plot > 0
        rgb[..., ch] = np.where(mask,
                                np.minimum(rgb[..., ch] + plot, maxint),
                                rgb[..., ch])
        for o in others:
            rgb[..., o] = np.where(mask, np.floor(rgb[..., o] / 2),
                                   rgb[..., o])
    return rgb.astype(np.int64)
