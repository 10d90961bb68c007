"""A-contrario meaningful alignments (Desolneux et al.) on the orientation
field (port of :mod:`tpuflow.detection.alignments`, a copy: the module is
host NumPy and SciPy there too) — parity with ``MeaningfulAlignments/Detection.cpp:135-441`` and the
probability tables in ``lib/Library.cpp:49-120`` /
``Scratch_MeaningfulMotion.cpp:393-426``.

The search casts rays from the top and bottom image edges in DIV_ANGLE=40
near-vertical directions (within +-pi/(2*18) of vertical,
Scratch_MeaningfulMotion.h:126-130), finds runs of "aligned" points
(orientation within DIR_PROBABILITY of the ray direction, modulo
ANGLE_MAX), and keeps epsilon-meaningful segments: k aligned of l total
with binomial tail Pr(k, l, p) * W^2 * H * DIV_ANGLE <= epsilon.
Maximality prunes mutually containing fragments per ray.

This is irregular ray/list work on small data (SURVEY.md §7.3): the
per-ray inner scan is vectorized NumPy (prefix-summed aligned counts give
every (start, end) count in O(1)); the tables use exact binomial tails.
The orientation field itself comes from
:func:`tpuflow_torch.ops.derivative_angler` on the frame's device, read
back with one ``.cpu()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from tpuflow_torch.core.config import (
    ANGLE_MAX,
    DIR_PROBABILITY,
    DIV_ANGLE,
    DIV_ANGLE_VERTICAL,
)


@dataclass
class Segment:
    """SEGMENT (lib/Struct.h): endpoints (n, m) -> (x, y) and tail Pr."""

    n: int
    m: int
    x: int
    y: int
    pr: float


# ---------------------------------------------------------------------------
# Probability tables


def pr_table(max_l: int, p: float = DIR_PROBABILITY) -> np.ndarray:
    """Pr(k, l, p) = P[Binomial(l, p) >= k], table (max_l+1, max_l+1)
    indexed [k, l] (Pr, lib/Library.cpp:98-120; fill loop
    Scratch_MeaningfulMotion.cpp:393-426)."""
    # Imported here: importing scipy.stats starts a subprocess (lscpu).
    from scipy.stats import binom

    ks = np.arange(max_l + 1)
    table = np.zeros((max_l + 1, max_l + 1))
    for l in range(1, max_l + 1):
        table[: l + 1, l] = binom.sf(ks[: l + 1] - 1, l, p)
    return table


def calc_k_l(width: int, height: int, p: float = DIR_PROBABILITY,
             ep: float = 1.0, table: np.ndarray | None = None) -> np.ndarray:
    """k_list[l] = min k with Pr(k,l,p) * W^2 * H * DIV_ANGLE <= ep
    (Calc_k_l, lib/Library.cpp:49-95)."""
    L = max(width, height)
    if table is None:
        table = pr_table(L, p)
    thresh = ep / (float(width) ** 2 * float(height) * DIV_ANGLE)
    k_list = np.zeros(L + 1, dtype=np.int64)
    for l in range(1, L + 1):
        ok = table[: l + 1, l] <= thresh
        k_list[l] = int(np.argmax(ok)) if ok.any() else l + 1
    return k_list


def l_min_for(width: int, height: int, p: float = DIR_PROBABILITY,
              ep: float = 1.0) -> int:
    """Minimum worthwhile segment length
    (Scratch_MeaningfulMotion.cpp:428-431)."""
    l_min = int(math.ceil(
        (math.log(ep) - (math.log(DIV_ANGLE) + math.log(height)
                         + 2.0 * math.log(width))) / math.log(p)))
    return max(l_min, 1)


# ---------------------------------------------------------------------------
# Ray geometry (AlignedSegment_vertical, Detection.cpp:168-245)


def _tan_list(width: int, height: int) -> np.ndarray:
    rad_offset = math.pi * (0.5 - 0.5 / DIV_ANGLE_VERTICAL)
    t = np.empty(DIV_ANGLE)
    for r in range(DIV_ANGLE):
        if r == DIV_ANGLE // 2:
            t[r] = 2.0 * max(width, height)
        else:
            t[r] = math.tan((math.pi / DIV_ANGLE_VERTICAL) * r / DIV_ANGLE
                            + rad_offset)
    return t


def _ray_targets(width: int, height: int):
    """All (m, n, x, y) ray endpoints: start on top (m=0) or bottom
    (m=height-1) at column n, end on the far side along direction r."""
    tans = _tan_list(width, height)
    rays = []
    for n in range(width):
        for r in range(DIV_ANGLE):
            t = tans[r]
            # Upper edge start (Detection.cpp:185-199)
            dxx = n + round((height - 1) / t)
            x = int(dxx) if 0.0 <= dxx < width else (width - 1 if dxx >= 0 else 0)
            dyy = round((width - 1 - n) * t) if t >= 0.0 else round(-n * t)
            y = int(dyy) if 0.0 <= dyy < height else (height - 1 if dyy >= 0 else 0)
            rays.append((0, n, x, y))
            # Bottom edge start (Detection.cpp:213-227)
            dxx = n + round(-(height - 1) / t)
            x = int(dxx) if 0.0 <= dxx < width else (width - 1 if dxx >= 0 else 0)
            if t >= 0.0:
                dyy = height - 1 + round(-n * t)
            else:
                dyy = height - 1 + round((width - 1 - n) * t)
            y = int(dyy) if 0.0 <= dyy < height else (height - 1 if dyy >= 0 else 0)
            rays.append((height - 1, n, x, y))
    return rays


def _ray_points(m: int, n: int, x: int, y: int):
    """Bresenham-free sample points (the reference's rounded linear
    interpolation, AlignedCheck)."""
    L = abs(x - n) + 1 if abs(x - n) > abs(y - m) else abs(y - m) + 1
    if L <= 1:
        return None
    ts = np.arange(L)
    dx = (x - n) / (L - 1.0)
    dy = (y - m) / (L - 1.0)
    xs = np.round(dx * ts + n).astype(np.int64)
    ys = np.round(dy * ts + m).astype(np.int64)
    return xs, ys, L


def _aligned_mask(angles: np.ndarray, xs, ys, aligned_angle: float):
    a = angles[ys, xs]
    return ((np.abs(a - aligned_angle) <= DIR_PROBABILITY)
            | (np.abs(a - ANGLE_MAX - aligned_angle) <= DIR_PROBABILITY)
            | (np.abs(a + ANGLE_MAX - aligned_angle) <= DIR_PROBABILITY))


def _scan_ray(aligned: np.ndarray, k_list: np.ndarray, table: np.ndarray,
              l_min: int, max_length: int):
    """AlignedCheck's fragment scan (Detection.cpp:291-371), vectorized
    over t_end via prefix sums. Returns [(start, end, Pr)]."""
    L = len(aligned)
    S = np.concatenate([[0], np.cumsum(aligned)])
    frags = []
    for t_start in np.nonzero(aligned[: max(L - l_min + 1, 0)])[0]:
        t0 = int(t_start)
        first_end = t0 + l_min - 1 if l_min > 1 else t0 + 1
        ends = np.arange(first_end, L)
        if len(ends) == 0:
            continue
        k = S[ends + 1] - S[t0]  # aligned count on [t0, end]
        lens = ends - t0 + 1
        valid = aligned[ends] & (k >= k_list[lens])
        pr = np.where(valid, table[np.minimum(k, table.shape[0] - 1), lens],
                      np.inf)
        # Sequential running-min emission (with Max_Length splitting).
        pr_max = 1.0
        t_end_max = 0
        for i in range(len(ends)):
            t_end = int(ends[i])
            if max_length > 0 and t_end_max > 0 \
                    and t_end_max - t0 + 1 <= max_length \
                    and t_end - t0 + 1 > max_length:
                frags.append((t0, t_end_max, pr_max))
                t_end_max = 0
            if valid[i] and pr[i] <= pr_max:
                pr_max = float(pr[i])
                t_end_max = t_end
        if t_end_max > 0:
            frags.append((t0, t_end_max, pr_max))
    return frags


def _maximal(frags):
    """Pairwise containment pruning (MaximalMeaningfulness,
    Detection.cpp:374-441): of two nested fragments keep the lower Pr."""
    out = list(frags)
    i = 0
    while i < len(out):
        j = 0
        removed_i = False
        while j < len(out):
            if i == j:
                j += 1
                continue
            si, ei, pi = out[i]
            sj, ej, pj = out[j]
            if si <= sj and ej <= ei:
                if pi <= pj:
                    out.pop(j)
                    if j < i:
                        i -= 1
                else:
                    out.pop(i)
                    removed_i = True
                    break
            elif sj <= si and ei <= ej:
                if pj <= pi:
                    out.pop(i)
                    removed_i = True
                    break
                else:
                    out.pop(j)
                    if j < i:
                        i -= 1
            else:
                j += 1
        if not removed_i:
            i += 1
    return out


def aligned_segments_vertical(
    angles: np.ndarray,
    k_list: np.ndarray | None = None,
    l_min: int | None = None,
    table: np.ndarray | None = None,
    max_length: int = 0,
    max_output_length: int = 0,
    p: float = DIR_PROBABILITY,
    ep: float = 1.0,
) -> list[Segment]:
    """Full near-vertical meaningful-segment search
    (AlignedSegment_vertical). ``angles`` is the derivative_angler field."""
    angles = np.asarray(angles)
    h, w = angles.shape
    if table is None:
        table = pr_table(max(w, h), p)
    if k_list is None:
        k_list = calc_k_l(w, h, p, ep, table)
    if l_min is None:
        l_min = l_min_for(w, h, p, ep)

    segments: list[Segment] = []
    for m, n, x, y in _ray_targets(w, h):
        pts = _ray_points(m, n, x, y)
        if pts is None:
            continue
        xs, ys, L = pts
        aligned_angle = math.atan2(y - m, x - n) / math.pi
        if aligned_angle < 0.0:
            aligned_angle += ANGLE_MAX
        aligned = _aligned_mask(angles, xs, ys, aligned_angle)
        frags = _scan_ray(aligned, k_list, table, l_min, max_length)
        if not frags:
            continue
        for s, e, prv in _maximal(frags):
            if max_output_length > 0 and (e - s + 1) > max_output_length:
                continue
            dx = (x - n) / (L - 1.0)
            dy = (y - m) / (L - 1.0)
            segments.append(Segment(
                n=int(round(n + dx * s)), m=int(round(m + dy * s)),
                x=int(round(n + dx * e)), y=int(round(m + dy * e)),
                pr=prv))
    return segments
