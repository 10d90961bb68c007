"""Independent gray frame pairs of smoothed noise, each moved by an integer
shift.

Frozen from ``chip_smoke.frames_kitti``: a texture of uniform noise in
[0, 255] smoothed by a Gaussian of std ``sigma``; the pair's next frame is
the texture moved by an integer (dx, dy). One pair is made in set-up for
each shift of ``shifts``, in an order drawn from the seed, and the pairs
are served in that order, cycled. Every seed gives the same shifts and
sizes (how long the stop test lets a level run depends on the shift); the
seed draws the textures and the order.
"""

from __future__ import annotations

import numpy as np


class Pairs:
    def __init__(self, pairs):
        self.pairs = pairs

    def order(self):
        i = 0
        while True:
            yield i % len(self.pairs)
            i += 1


def make(params: dict, config: dict, seed: int) -> Pairs:
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng([int(seed), 0x5EED])
    h, w = config["frame_shape"]
    shifts = [params["shifts"][k]
              for k in rng.permutation(len(params["shifts"]))]
    pad = max(abs(int(d)) for s in shifts for d in s)
    pairs = []
    for dx, dy in shifts:
        base = gaussian_filter(rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad)),
                               float(params["sigma"]))
        prev = base[pad : pad + h, pad : pad + w]
        nxt = base[pad + dy : pad + dy + h, pad + dx : pad + dx + w]
        pairs.append((np.ascontiguousarray(prev, np.float32),
                      np.ascontiguousarray(nxt, np.float32)))
    return Pairs(pairs)
