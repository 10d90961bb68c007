"""Exclusive principle — redundant-segment removal
(MeaningfulAlignments/Exclusive.cpp parity; port of
:mod:`tpuflow.detection.exclusive`, a copy: host NumPy there too).

1. :func:`exclusive_index_map` — each pixel is assigned to the
   lowest-Pr segment whose supporting line passes within
   ``exclusive_max_radius`` and whose endpoint-distance triangle test
   holds (Exclusive.cpp:53-143). Dense over pixels x segments —
   vectorized NumPy (segment counts are tiny).
2. :func:`exclusive_segments` — every segment is re-tested counting only
   aligned points on pixels it owns; it survives if k >= k_list[L], with
   the refreshed tail probability (Exclusive.cpp:146-251).
"""

from __future__ import annotations

import math

import numpy as np

from tpuflow_torch.core.config import (ANGLE_MAX,
                                       EXCLUSIVE_PRINCIPLE_MAX_RADIUS)
from tpuflow_torch.detection.alignments import (
    Segment,
    _aligned_mask,
    _ray_points,
)


def exclusive_index_map(width: int, height: int, segments: list[Segment],
                        exclusive_max_radius: float =
                        EXCLUSIVE_PRINCIPLE_MAX_RADIUS) -> np.ndarray:
    """(H, W) int map: owning segment index or -1 (ExclusiveIndexMap)."""
    index_map = np.full((height, width), -1, dtype=np.int64)
    if not segments:
        return index_map
    pr_min = np.full((height, width), 1.0)
    xs = np.arange(width)[None, :]
    ys = np.arange(height)[:, None]
    for i, s in enumerate(segments):
        # Polar line through the segment (Exclusive.cpp:84-99).
        theta = math.atan2(s.n - s.x, s.y - s.m)
        if theta >= math.pi:
            theta -= math.pi
        elif theta < 0.0:
            theta += math.pi
        c, sn = math.cos(theta), math.sin(theta)
        r = s.x * c + s.y * sn
        d = np.abs(r - (xs * c + ys * sn))
        d_triangle = (np.hypot(xs - s.x, ys - s.y)
                      + np.hypot(xs - s.n, ys - s.m))
        seg_len = math.sqrt((s.x - s.n) ** 2 + (s.y - s.m) ** 2)
        # The reference computes sqrt(len^2 + d*d) in one sqrt
        # (Exclusive.cpp:117-121).
        d_max = d + np.sqrt(seg_len**2 + d * d)
        own = (d < exclusive_max_radius) & (d_triangle <= d_max) \
            & (s.pr < pr_min)
        index_map[own] = i
        pr_min[own] = s.pr
    return index_map


def exclusive_segments(index_map: np.ndarray, angles: np.ndarray,
                       segments: list[Segment], k_list: np.ndarray,
                       table: np.ndarray) -> list[Segment]:
    """Re-test each segment on its owned pixels (ExclusiveSegments)."""
    out: list[Segment] = []
    for i, s in enumerate(segments):
        pts = _ray_points(s.m, s.n, s.x, s.y)
        if pts is None:
            continue
        xs, ys, L = pts
        aligned_angle = math.atan2(s.y - s.m, s.x - s.n) / math.pi
        if aligned_angle < 0.0:
            aligned_angle += ANGLE_MAX
        inb = (xs >= 0) & (xs < angles.shape[1]) \
            & (ys >= 0) & (ys < angles.shape[0])
        # The reference breaks at the first out-of-range point
        # (Exclusive.cpp:196-199) — truncate there.
        if not inb.all():
            stop = int(np.argmin(inb))
            xs, ys = xs[:stop], ys[:stop]
        if len(xs) == 0:
            continue
        owned = index_map[ys, xs] == i
        aligned = _aligned_mask(angles, xs, ys, aligned_angle) & owned
        k = int(aligned.sum())
        if L < len(k_list) and k >= k_list[L]:
            out.append(Segment(n=s.n, m=s.m, x=s.x, y=s.y,
                               pr=float(table[min(k, table.shape[0] - 1), L])))
    return out


def exclusive_principle(angles: np.ndarray, segments: list[Segment],
                        k_list: np.ndarray, table: np.ndarray,
                        exclusive_max_radius: float =
                        EXCLUSIVE_PRINCIPLE_MAX_RADIUS):
    """Full pass (ExclusivePrinciple, Exclusive.cpp:5-50).

    Returns (surviving_segments, index_map)."""
    angles = np.asarray(angles)
    h, w = angles.shape
    index_map = exclusive_index_map(w, h, segments, exclusive_max_radius)
    survivors = exclusive_segments(index_map, angles, segments, k_list, table)
    return survivors, index_map
