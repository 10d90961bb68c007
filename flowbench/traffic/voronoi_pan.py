"""A camera panning over a shaded Voronoi scene, frame by frame.

Frozen from ``chip_smoke.voronoi_frames``: each Voronoi cell gets a random
colour in [40, 215] and a random linear shading of std ``shade`` per pixel;
every frame adds its own Gaussian noise and is clipped to [0, 255]. Here the
camera takes an integer pan per frame, drawn from the seed in ``pan_dx`` x
``pan_dy`` and reflected at ``walk_margin`` from the start, over a pool of
``pool_frames`` frames made in set-up; the noise std of each frame is drawn
from ``noise_std``, so a middle frame's two neighbours never tie.

The stream walks the pool forward and back (``order``): at either end it
turns and skips one frame, so no middle frame has the same frame on both
sides. Every seed gives the same number of frames of the same size.
"""

from __future__ import annotations

import numpy as np


class Pool:
    def __init__(self, frames):
        self.frames = frames

    def order(self):
        """Pool indices of the stream's frames: 0, 1, ..., n-1, n-3, ...,
        0, 2, ... (endless)."""
        n = len(self.frames)
        i, step = 0, 1
        while True:
            yield i
            nxt = i + step
            if not 0 <= nxt < n:
                step = -step
                nxt = i + 2 * step
            i = nxt


def make(params: dict, config: dict, seed: int) -> Pool:
    from scipy.spatial import cKDTree

    rng = np.random.default_rng([int(seed), 0x5EED])
    h, w = config["frame_shape"]
    my, mx = params["walk_margin"]
    n = int(params["pool_frames"])
    (dx0, dx1), (dy0, dy1) = params["pan_dx"], params["pan_dy"]
    walk = [(0, 0)]
    for _ in range(n - 1):
        d = np.array([rng.integers(dy0, dy1 + 1), rng.integers(dx0, dx1 + 1)])
        p = np.array(walk[-1]) + d
        for k, m in enumerate((my, mx)):
            if abs(p[k]) > m:
                p[k] = walk[-1][k] - d[k]
        walk.append((int(p[0]), int(p[1])))
    H, W = h + 2 * my, w + 2 * mx
    n_cells = int(round(params["cells_per_frame"] / (h * w) * H * W))
    pts = rng.uniform(0, 1, (n_cells, 2)) * [H, W]
    cols = rng.uniform(40, 215, (n_cells, 3))
    grad = rng.normal(0, 1.0, (n_cells, 2)) * float(params["shade"])
    yy, xx = np.mgrid[0:H, 0:W]
    cell = cKDTree(pts).query(np.stack([yy.ravel(), xx.ravel()], -1))[1]
    cell = cell.reshape(H, W)
    img = cols[cell] + ((yy - pts[cell, 0]) * grad[cell, 0]
                        + (xx - pts[cell, 1]) * grad[cell, 1])[..., None]
    lo, hi = params["noise_std"]
    frames = []
    for py, px in walk:
        f = img[my + py : my + py + h, mx + px : mx + px + w] + rng.normal(
            0, rng.uniform(lo, hi), (h, w, 3))
        frames.append(np.clip(f, 0, 255).astype(np.float32))
    return Pool(frames)
