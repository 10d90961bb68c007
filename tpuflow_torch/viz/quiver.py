"""Flow quiver rasterization, array out (port of :mod:`tpuflow.viz.quiver`).

Re-implements the reference's Bresenham flow plotter
(``HornSchunckOF/plotFlow.cpp:43-88``) and the OpenCV line-draw quivers of
the Farneback demos (``FarnebackOF/FarnebackOF.cpp:25-38``,
``VideoDenseOF/DenseFlow.cpp:40-46``) as NumPy rasterization into an
RGB array; callers save with :func:`tpuflow_torch.core.io.write_image`.
:func:`plot_quiver` runs the native C++ rasterizer
(:func:`tpuflow_torch.native.draw_quiver`), with no fallback; its Python
body is :func:`plot_quiver_plain`.

Notes on the reference's conventions (kept for visual parity):
- the grid steps every ``delta`` pixels; vectors are scaled by ``scale``;
- an ``outlier`` bound (if > 0) suppresses lines with |u| or |v| >= bound
  (plotFlow.cpp:74-78);
- line color green, endpoint red.
"""

from __future__ import annotations

import numpy as np


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color: tuple[int, int, int]) -> None:
    """Integer Bresenham matching plotFlow::bresenhamPoints (midpoint walk,
    endpoint excluded)."""
    dx = x1 - x0
    dy = y1 - y0
    sx = (dx > 0) - (dx < 0)
    sy = (dy > 0) - (dy < 0)
    dx, dy = abs(dx), abs(dy)
    n = max(dx, dy)
    if n == 0:
        return
    h, w = img.shape[:2]
    x, y = x0, y0
    if dx > dy:
        r = n / 2.0
        for _ in range(n):
            if 0 <= x < w - 1 and 0 <= y < h - 1:
                img[y, x] = color
            x += sx
            r += dy
            if r >= dx:
                y += sy
                r -= dx
    else:
        r = n / 2.0
        for _ in range(n):
            if 0 <= x < w - 1 and 0 <= y < h - 1:
                img[y, x] = color
            y += sy
            r += dx
            if r >= dy:
                x += sx
                r -= dy


def _clip_line_cv(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV ``clipLine``: two-phase (rows then columns) Cohen-Sutherland
    with double-precision truncating interpolation — replicated exactly so
    :func:`_draw_line_cv8` matches ``cv::line`` pixel-for-pixel on
    out-of-frame endpoints."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line_cv8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                   color: tuple[int, int, int]) -> None:
    """``cv::line`` thickness-1 LINE_8: OpenCV's LineIterator walk
    (left-to-right normalization, error seed ``maj - 2*mino``, minor step
    when the error is negative, both endpoints inclusive) after
    :func:`_clip_line_cv`. Bit-identical to OpenCV's rasterizer."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line_cv(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx = x2 - x1
    dy = y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    if dy > dx:
        maj, mino = dy, dx
        mjx, mjy, mnx, mny = 0, sy, 1, 0
    else:
        maj, mino = dx, dy
        mjx, mjy, mnx, mny = 1, 0, 0, sy
    err = maj - 2 * mino
    x, y = x1, y1
    for _ in range(maj + 1):
        img[y, x] = color
        if err < 0:
            err += 2 * maj - 2 * mino
            x += mjx + mnx
            y += mjy + mny
        else:
            err -= 2 * mino
            x += mjx
            y += mjy


def _cv_disc(radius: int) -> tuple[tuple[int, int], ...]:
    """``cv::circle(..., radius, FILLED)`` footprint for the small radii
    the demos use: exactly the Euclidean disc ``dx^2 + dy^2 <= r^2``
    (pixel-for-pixel OpenCV's for r = 0..3). Radius 0 = one pixel (FarnebackOF.cpp:36
    passes 0.5, truncated to 0 by the int parameter); radius 1 = the
    5-pixel plus (DenseFlow.cpp:44); radius 3 = the 29-pixel disc
    (LucasKanadeOF.cpp:86)."""
    r = int(radius)
    return tuple((dx, dy)
                 for dy in range(-r, r + 1)
                 for dx in range(-r, r + 1)
                 if dx * dx + dy * dy <= r * r)


def draw_tracks_cv(
    image: np.ndarray,
    points_from: np.ndarray,
    points_to: np.ndarray,
    line_color: tuple[int, int, int] = (255, 0, 0),
    dot_color: tuple[int, int, int] = (0, 255, 0),
    dot_radius: int = 3,
) -> np.ndarray:
    """The LK demo's track overlay (LucasKanadeOF.cpp:83-87): per
    accepted feature a thickness-1 ``cv::line`` from its initial to its
    tracked position and a filled radius-3 ``cv::circle`` at the tracked
    position, on the CURRENT color frame. Colors are RGB (the reference's
    Scalar(0,0,255)/Scalar(0,255,0) BGR = red lines / green dots);
    float coordinates round like OpenCV's Point2f->Point (cvRound)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    out = np.ascontiguousarray(img.astype(np.uint8).copy())
    h, w = out.shape[:2]
    disc = _cv_disc(dot_radius)
    for (x0, y0), (x1, y1) in zip(np.asarray(points_from),
                                  np.asarray(points_to)):
        xa, ya = int(np.rint(x0)), int(np.rint(y0))
        xb, yb = int(np.rint(x1)), int(np.rint(y1))
        _draw_line_cv8(out, xa, ya, xb, yb, line_color)
        for ddx, ddy in disc:
            xx, yy = xb + ddx, yb + ddy
            if 0 <= xx < w and 0 <= yy < h:
                out[yy, xx] = dot_color
    return out


def plot_quiver_cv(
    image: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    delta: int = 10,
    scale: float = 10.0,
    line_color: tuple[int, int, int] = (0, 0, 255),
    dot_color: tuple[int, int, int] = (255, 0, 0),
    dot_radius: int = 0,
) -> np.ndarray:
    """The OpenCV-demo quiver style, bit-identical to the reference
    binaries' drawing: per grid point a thickness-1 8-connected
    ``cv::line`` from (x, y) to ``cvRound(x + u*scale), cvRound(y +
    v*scale)`` followed by a filled ``cv::circle`` at the grid point
    (FarnebackOF.cpp:25-38: blue lines + radius-0 red dots;
    VideoDenseOF/DenseFlow.cpp:40-46: blue lines + radius-1 black dots
    on a 5-px grid). Colors are RGB. ``cvRound`` is round-half-to-even
    (np.rint). Contrast :func:`plot_quiver`, which is the reference's
    own plotFlow.cpp Bresenham style (truncating casts, endpoint
    exclusive, outlier gate)."""
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    out = np.ascontiguousarray(img.astype(np.uint8).copy())
    if out.shape[:2] != u.shape:
        raise ValueError(
            f"image {out.shape[:2]} and flow {u.shape} shapes must agree")
    h, w = u.shape
    disc = _cv_disc(dot_radius)
    for y0 in range(0, h, delta):
        for x0 in range(0, w, delta):
            x1 = int(np.rint(x0 + u[y0, x0] * scale))
            y1 = int(np.rint(y0 + v[y0, x0] * scale))
            _draw_line_cv8(out, x0, y0, x1, y1, line_color)
            for ddx, ddy in disc:
                xx, yy = x0 + ddx, y0 + ddy
                if 0 <= xx < w and 0 <= yy < h:
                    out[yy, xx] = dot_color
    return out


def _quiver_inputs(image, u, v):
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img, u, v


def plot_quiver(
    image: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    delta: int = 10,
    scale: float = 1.0,
    outlier: float = 0.0,
    line_color: tuple[int, int, int] = (0, 255, 0),
    tip_color: tuple[int, int, int] = (255, 0, 0),
) -> np.ndarray:
    """Rasterize a flow quiver over ``image``; returns an (H, W, 3) uint8.
    Runs the native rasterizer (``tf_draw_quiver``)."""
    from tpuflow_torch import native

    img, u, v = _quiver_inputs(image, u, v)
    return native.draw_quiver(img, u, v, delta, scale, outlier, line_color,
                              tip_color)


def plot_quiver_plain(
    image: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    delta: int = 10,
    scale: float = 1.0,
    outlier: float = 0.0,
    line_color: tuple[int, int, int] = (0, 255, 0),
    tip_color: tuple[int, int, int] = (255, 0, 0),
) -> np.ndarray:
    """:func:`plot_quiver` in Python (tpuflow's body), the native
    rasterizer's plain version."""
    img, u, v = _quiver_inputs(image, u, v)
    out = np.ascontiguousarray(img.astype(np.uint8).copy())
    h, w = u.shape
    for y0 in range(0, h, delta):
        for x0 in range(0, w, delta):
            du, dv = u[y0, x0], v[y0, x0]
            x1 = int(x0 + du * scale)
            y1 = int(y0 + dv * scale)
            if outlier <= 0 or (abs(du) < outlier and abs(dv) < outlier):
                _draw_line(out, x0, y0, x1, y1, line_color)
            if 0 <= x1 < w - 1 and 0 <= y1 < h - 1:
                out[y1, x1] = tip_color
    return out
