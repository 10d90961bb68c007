"""Film-scratch detection (port of :mod:`tpuflow.detection.scratch`;
DetectScratch, MeaningfulAlignments/Detection.cpp:7-132).

Per pixel of the (optionally epsilon/Gaussian pre-filtered) frame:

- Im = horizontal median over a width-3 window;
- candidate if |I - Im| >= s_med;
- confirmed if the left/right side averages agree: Il over
  x - AVE_FAR .. x - 2, Ir over x + 2 .. x + AVE_FAR (border-clamped,
  averaged over however many pixels exist), |Il - Ir| <= s_avg;
- output PLOT_INTENSITY_MAX (255) at confirmed pixels, 0 elsewhere.

Pixels whose side window is empty (x <= 1 or x >= W-2) are never flagged.

Runs on the frame's device. The Gaussian prefilter (odd sizes) is one
``sep_conv2d_valid`` launch: on the card the hand-written separable
kernel. The side sums are differences of a row prefix sum taken in XLA's
CPU grouping (``numerics.scan_cumsum``), elementwise adds that give
tpuflow's bits at float64 and the same bits on the card as on the CPU,
after a prefilter too.
"""

from __future__ import annotations

import torch

from tpuflow_torch.core.config import (
    AVE_FAR,
    FILTER_ID_EPSILON,
    FILTER_ID_GAUSSIAN,
    MEAN_WIDTH,
    PLOT_INTENSITY_MAX,
    SCRATCH_WIDTH,
    FilterParam,
)
from tpuflow_torch.ops.filters import (
    epsilon_filter,
    gaussian_filter,
    horizontal_median,
)
from tpuflow_torch.utils.numerics import scan_cumsum

HALF = SCRATCH_WIDTH // 2  # the side windows start at x -/+ (HALF + 1)


def apply_prefilter(img: torch.Tensor, filter_param: FilterParam | None):
    """The DetectScratch pre-filter dispatch (Detection.cpp:36-66)."""
    if filter_param is None:
        return img
    if filter_param.type == FILTER_ID_EPSILON:
        return epsilon_filter(img, filter_param.size, filter_param.epsilon)
    if filter_param.type == FILTER_ID_GAUSSIAN:
        return gaussian_filter(img, filter_param.size,
                               filter_param.std_deviation)
    return img


def side_counts(x: torch.Tensor, w: int):
    """Pixels in the left and right side windows of global columns ``x``
    of a frame ``w`` wide."""
    la = (x - AVE_FAR).clamp(min=0)
    lb = x - HALF - 1  # inclusive upper bound x-2
    ra = x + HALF + 1  # x+2
    rb = (x + AVE_FAR).clamp(max=w - 1)
    return ((lb - la + 1).clamp(min=0), (rb - ra + 1).clamp(min=0),
            (la, lb, ra, rb))


def confirm(img, med, l_sum, r_sum, l_cnt, r_cnt, s_med, s_avg):
    """The scratch decision from the frame, its median and the side sums
    and counts (counts per column)."""
    candidate = (img - med).abs() >= s_med
    ok_sides = (l_cnt > 0) & (r_cnt > 0)
    il = l_sum / l_cnt.clamp(min=1).to(img.dtype)
    ir = r_sum / r_cnt.clamp(min=1).to(img.dtype)
    confirmed = candidate & ok_sides & ((il - ir).abs() <= s_avg)
    return torch.where(confirmed, float(PLOT_INTENSITY_MAX), 0.0).to(
        img.dtype)


def _detect(img: torch.Tensor, s_med: float, s_avg: float) -> torch.Tensor:
    h, w = img.shape
    med = horizontal_median(img, MEAN_WIDTH)
    # Side sums via row prefix sums: S[:, i] = sum img[:, :i].
    s = torch.cat([img.new_zeros((h, 1)), scan_cumsum(img, 1)], dim=1)
    xs = torch.arange(w, device=img.device)
    l_cnt, r_cnt, (la, lb, ra, rb) = side_counts(xs, w)
    l_sum = s[:, (lb + 1).clamp(0, w)] - s[:, la]
    r_sum = s[:, (rb + 1).clamp(0, w)] - s[:, ra.clamp(0, w)]
    return confirm(img, med, l_sum, r_sum, l_cnt, r_cnt, s_med, s_avg)


def detect_scratch(
    img: torch.Tensor,
    s_med: float = 3.0,
    s_avg: float = 20.0,
    filter_param: FilterParam | None = None,
    do_detection: bool = True,
):
    """DetectScratch. Returns (scratch_map, filtered_img) on the frame's
    device.

    With do_detection=False returns the filtered image as the map (the
    ``--filtered`` output mode, Detection.cpp:81-84).
    """
    filtered = apply_prefilter(img, filter_param)
    if not do_detection:
        return filtered, filtered
    return _detect(filtered, float(s_med), float(s_avg)), filtered
