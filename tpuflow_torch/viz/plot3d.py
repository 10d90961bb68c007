"""Headless 3-D viewer — the X11 viewer re-designed array-out
(Plot/Plot_X11.cpp; params ``Scratch_Struct.h:43-57``; port of
:mod:`tpuflow.viz.plot3d`).

The reference opens an interactive Xlib window showing the image as a 3-D
height field (intensity -> z) with detected segments as 3-D lines, a
mouse/key camera, painter's-algorithm depth ordering, and toy
"galaxy"/"gravity" particle animations of the pixels. A GUI is the wrong
shape for a server framework, so this module renders the *same
scene* to an RGB array (writeable as PNG/PPM or streamed as frames):

- :func:`project_points` — TransRotate_3DPoint (Plot_X11.cpp:/TransRotate):
  z = ((-I + MaxInt/2) - cz) * z_scale * scale, camera rotation by
  longitude then latitude (0.1-degree steps like the reference's
  3600-entry tables);
- :func:`render_scene` — Plot_3DPoints / Plot_3DGrid + Plot_3DSegment:
  depth-sorted point or grid-line splats, dark-to-light by depth, with
  segments drawn in red on top;
- :func:`galaxy_step` / :func:`gravity_step` — TransGaraxy_3DPoint /
  TransGravity_3DPoint particle updates (dt = 0.5, r_min = 0.01,
  inverse-square attraction; gravity uses the >95%-intensity pixels as
  cores).

The projection math is vectorized NumPy (tiny data, interactive-rate).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from tpuflow_torch.core.config import PlotParam

WINDOW_DEFAULT = (800, 800)  # Plot_X11.h:11-12
DT = 0.5
RADIUS_MINIMUM = 0.01


def _angles(param: PlotParam) -> tuple[float, float, float, float]:
    """cos/sin of latitude/longitude given in 0.1-degree units
    (ROTATE_ANGLE_MAX = 3600, Plot_X11.h:36-38)."""
    lon = math.radians(param.longitude / 10.0)
    lat = math.radians(param.latitude / 10.0)
    return math.cos(lon), math.sin(lon), math.cos(lat), math.sin(lat)


def project_points(img: np.ndarray, param: PlotParam, max_int: float = 255.0,
                   window: tuple[int, int] = WINDOW_DEFAULT):
    """Project the height field. Returns (px, py, depth) int arrays."""
    h, w = img.shape
    ww, wh = window
    cos_lon, sin_lon, cos_lat, sin_lat = _angles(param)
    ys, xs = np.mgrid[0:h, 0:w]
    x = (xs - param.center_x) * param.scale
    y = (ys - param.center_y) * param.scale
    z = ((-img + max_int / 2.0) - param.center_z) \
        * param.plot_z_scale * param.scale
    px = ww / 2.0 + np.round(x * cos_lon - y * sin_lon)
    rot_y = y * cos_lon + x * sin_lon
    py = wh / 2.0 + np.round(rot_y * cos_lat - z * sin_lat)
    depth = np.round(z * cos_lat + rot_y * sin_lat)
    return px.astype(np.int64), py.astype(np.int64), depth


def project_segments(segments, param: PlotParam,
                     window: tuple[int, int] = WINDOW_DEFAULT,
                     z_plane: float = 0.0):
    """Project segment endpoints onto the same camera (TransRotate_3DSegment
    puts segments at the image plane)."""
    ww, wh = window
    cos_lon, sin_lon, cos_lat, sin_lat = _angles(param)
    out = []
    for s in segments:
        pts = []
        for sx, sy in ((s.n, s.m), (s.x, s.y)):
            x = (sx - param.center_x) * param.scale
            y = (sy - param.center_y) * param.scale
            z = (z_plane - param.center_z) * param.plot_z_scale * param.scale
            px = ww / 2.0 + round(x * cos_lon - y * sin_lon)
            rot_y = y * cos_lon + x * sin_lon
            py = wh / 2.0 + round(rot_y * cos_lat - z * sin_lat)
            pts.append((int(px), int(py)))
        out.append(pts)
    return out


def _draw_line(buf: np.ndarray, p0, p1, color) -> None:
    x0, y0 = p0
    x1, y1 = p1
    L = max(abs(x1 - x0), abs(y1 - y0))
    ts = np.arange(L + 1)
    if L == 0:
        xs = np.array([x0])
        ys = np.array([y0])
    else:
        xs = np.round(x0 + (x1 - x0) * ts / L).astype(int)
        ys = np.round(y0 + (y1 - y0) * ts / L).astype(int)
    ok = (xs >= 0) & (xs < buf.shape[1]) & (ys >= 0) & (ys < buf.shape[0])
    buf[ys[ok], xs[ok]] = color


def render_scene(img: np.ndarray, param: PlotParam | None = None,
                 segments=(), max_int: float = 255.0,
                 window: tuple[int, int] = WINDOW_DEFAULT,
                 grid: bool = False) -> np.ndarray:
    """Render the 3-D scene to (Wh, Ww, 3) uint8 (painter's ordering)."""
    if param is None:
        img_arr = np.asarray(img)
        param = PlotParam(scale=min(window) / (1.8 * max(img_arr.shape)),
                          latitude=450, longitude=300,
                          center_x=img_arr.shape[1] / 2.0,
                          center_y=img_arr.shape[0] / 2.0)
    ww, wh = window
    buf = np.zeros((wh, ww, 3), dtype=np.uint8)
    px, py, depth = project_points(np.asarray(img, np.float64), param,
                                   max_int, window)
    inten = np.asarray(img, np.float64).reshape(-1)
    order = np.argsort(depth.reshape(-1), kind="stable")  # far first
    pxf = px.reshape(-1)[order]
    pyf = py.reshape(-1)[order]
    itf = inten[order]
    step = max(1, int(param.int_interval))
    pxf, pyf, itf = pxf[::step], pyf[::step], itf[::step]
    ok = (pxf >= 0) & (pxf < ww) & (pyf >= 0) & (pyf < wh)
    shade = np.clip(64 + itf * (191.0 / max_int), 0, 255).astype(np.uint8)
    buf[pyf[ok], pxf[ok]] = shade[ok, None]
    if grid:
        # Connect horizontal neighbors (Plot_3DGrid's wireframe look).
        h, w = img.shape
        for yrow in range(0, h, max(1, step)):
            xs = px[yrow]
            ysr = py[yrow]
            for c in range(0, w - 1, max(1, step)):
                _draw_line(buf, (xs[c], ysr[c]), (xs[c + 1], ysr[c + 1]),
                           (96, 96, 96))
    for p0, p1 in project_segments(segments, param, window):
        _draw_line(buf, p0, p1, (255, 64, 64))
    return buf


# ---------------------------------------------------------------------------
# Particle animations


@dataclass
class ParticleState:
    """Pixel particle cloud for the galaxy/gravity animations."""

    coord: np.ndarray  # (N, 3)
    vel: np.ndarray    # (N, 3)
    intensity: np.ndarray  # (N,)
    shape: tuple[int, int] = (0, 0)

    @classmethod
    def from_image(cls, img: np.ndarray) -> "ParticleState":
        h, w = img.shape
        ys, xs = np.mgrid[0:h, 0:w]
        coord = np.stack([xs.reshape(-1), ys.reshape(-1),
                          np.zeros(h * w)], axis=-1).astype(np.float64)
        return cls(coord=coord, vel=np.zeros_like(coord),
                   intensity=np.asarray(img, np.float64).reshape(-1),
                   shape=(h, w))


def galaxy_step(state: ParticleState, center=(0.0, 0.0, 0.0),
                dt: float = DT) -> ParticleState:
    """One TransGaraxy_3DPoint update: inverse-square pull to a center."""
    c = np.asarray(center, np.float64)
    d = c[None, :] - state.coord
    r = np.maximum(np.linalg.norm(d, axis=-1), RADIUS_MINIMUM)
    state.vel = state.vel + dt * d / (r**3)[:, None]
    state.coord = state.coord + state.vel * dt
    return state


def gravity_step(state: ParticleState, dt: float = DT) -> ParticleState:
    """One TransGravity_3DPoint update: pull toward the >95%-intensity
    'core' pixels weighted by their normalized intensity."""
    maxint = state.intensity.max()
    cores = np.nonzero(state.intensity > maxint * 0.95)[0]
    for j in cores:
        m = state.intensity[j] / maxint
        d = state.coord[j][None, :] - state.coord
        r = np.maximum(np.linalg.norm(d, axis=-1), RADIUS_MINIMUM)
        state.vel = state.vel + dt * m * d / (r**3)[:, None]
    state.coord = state.coord + state.vel * dt
    return state
