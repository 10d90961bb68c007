"""The region-gated IRLS tile entry (``irls_gated_tile_sweeps``) against
tpuflow's tile body, on the CPU.

tpuflow runs ``_irls_sweeps_gated`` on each halo'd tile of its sharded
refine (tpuflow/dist/bm_refine.py). The port's plain version of the tile
entry takes the same float64 tiles, halos holding the neighbouring
tiles' real values and labels, at frame origins in a corner, on an edge
and inside the frame: it must equal tpuflow's core bitwise (the same
operations in the same order). The cores of a 2x2 cut, stitched, equal
the whole-frame gated sweeps bitwise, and a block split into launches of
at most 3 sweeps (the wrapper's split on the card) equals one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.kernels.irls_stencil import _irls_sweeps_gated, _nb_masks
from tpuflow_torch.kernels import irls_stencil as K

ARGS = (5.0, 1.0, 0.14, 0.02)  # lambda_d, lambda_s, sigma_d, sigma_s
H, W = 24, 40


def _fields(seed=3, batch=None):
    """Smooth-ish random fields and blocky labels (regions cross tiles)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    u = 0.3 * rng.normal(size=lead + (H, W))
    v = 0.3 * rng.normal(size=lead + (H, W))
    it = 0.1 * rng.normal(size=lead + (H, W))
    gx, gy = rng.normal(size=(2, H, W))
    labels = (np.arange(H)[:, None] // 7 * 6
              + np.arange(W)[None, :] // 9).astype(np.int32)
    labels[rng.uniform(size=(H, W)) < 0.1] = 99
    sup = np.array([40.0]), np.array([55.0])
    return u, v, gx, gy, it, labels, sup


def _window(a, row0, col0, hh, hw):
    """The (hh, hw) window at frame origin (row0, col0) of the frame
    zero-padded around (a halo exchange's zeros outside the frame)."""
    pad = 64
    p = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(pad, pad), (pad, pad)])
    return p[..., pad + row0 : pad + row0 + hh, pad + col0 : pad + col0 + hw]


def _tiles(f, row0, col0, hh, hw, fields):
    return [_window(a, row0, col0, hh, hw) for a in fields]


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("origin", [(0, 0), (0, 17), (9, 21), (12, 30)])
def test_tile_plain_matches_tpuflow(origin, fuse):
    u, v, gx, gy, it, labels, (sx, sy) = _fields()
    r0, c0 = origin
    th, tw = 12, 10 if c0 + 10 <= W else W - c0
    hh, hw = th + 2 * fuse, tw + 2 * fuse
    row0, col0 = r0 - fuse, c0 - fuse
    tiles = _tiles(None, row0, col0, hh, hw, (u, v, gx, gy, it, labels))
    masks = _nb_masks(row0, col0, hh, hw, H, W, jnp.float64)
    want = _irls_sweeps_gated(*(jnp.asarray(a) for a in tiles[:5]),
                              jnp.asarray(tiles[5].astype(np.float64)),
                              masks, sx[0], sy[0], fuse, *ARGS)
    got = K.irls_gated_tile_sweeps(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in tiles),
        torch.from_numpy(sx), torch.from_numpy(sy), row0, col0, H, W, fuse,
        *ARGS)
    for g, w in zip(got, want):
        assert g.shape == (th, tw)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stitched_cut_equals_whole_frame_with_batch():
    """Two directions (a leading batch axis), a 2x2 cut at fuse 3, and the
    split into launches of at most 2 sweeps."""
    u, v, gx, gy, it, labels, (sx, sy) = _fields(5, batch=2)
    t = torch.from_numpy
    fuse = 3
    want = K.irls_gated_sweeps_plain(t(u), t(v), t(gx), t(gy), t(it),
                                     t(labels), t(sx), t(sy), fuse, *ARGS)
    th, tw = H // 2, W // 2
    out = [np.zeros((2, H, W)), np.zeros((2, H, W))]
    for i in range(2):
        for k in range(2):
            row0, col0 = i * th - fuse, k * tw - fuse
            tiles = [t(np.ascontiguousarray(a)) for a in _tiles(
                None, row0, col0, th + 2 * fuse, tw + 2 * fuse,
                (u, v, gx, gy, it, labels))]
            args = (*tiles, t(sx), t(sy), row0, col0, H, W, fuse, *ARGS)
            got = K.irls_gated_tile_sweeps(*args)
            split = K._split_gated_tile(K.irls_gated_tile_sweeps_plain,
                                        *args, f_max=2)
            for g, s in zip(got, split):
                np.testing.assert_array_equal(g.numpy(), s.numpy())
            for o, g in zip(out, got):
                o[:, i * th : (i + 1) * th, k * tw : (k + 1) * tw] = g.numpy()
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w.numpy())


def test_tile_wrapper_rejects():
    z = torch.zeros((8, 8))
    lab = torch.zeros((8, 8), dtype=torch.int32)
    s = torch.ones(1)
    with pytest.raises(ValueError, match="no core"):
        K.irls_gated_tile_sweeps(z, z, z, z, z, lab, s, s, 0, 0, 8, 8, 4,
                                 *ARGS)
    with pytest.raises(ValueError, match="share"):
        K.irls_gated_tile_sweeps(z, z[:4], z, z, z, lab, s, s, 0, 0, 8, 8, 1,
                                 *ARGS)
    with pytest.raises(ValueError, match="fuse"):
        K.irls_gated_tile_sweeps(z, z, z, z, z, lab, s, s, 0, 0, 8, 8, 0,
                                 *ARGS)
