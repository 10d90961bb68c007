"""tpuflow_torch's L1 substrate against tpuflow's, on the CPU in float64.

Border policies, conv2d/box_filter/sep_conv2d and sobel_opencv take the
same numpy inputs through both packages; they agree to atol 1e-12 (the
two sum the taps in different orders, so not bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.core import borders as jbd
from tpuflow.ops import derivatives as jder
from tpuflow.ops import filters as jfil
from tpuflow_torch.core import borders as tbd
from tpuflow_torch.ops import derivatives as tder
from tpuflow_torch.ops import filters as tfil

ATOL = 1e-12
MODES = [tbd.ZERO, tbd.MIRROR, tbd.REFLECT101, tbd.CLAMP]


def _img(h=9, w=13, seed=3):
    return np.random.default_rng(seed).normal(size=(h, w))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pad", [2, (1, 3, 0, 4), (7, 9, 15, 20)])
def test_pad2d_matches(mode, pad):
    """Includes pads wider than the image (9x13), which F.pad's reflect
    refuses and numpy's accepts."""
    img = _img()
    _close(tbd.pad2d(torch.from_numpy(img), pad, mode),
           jbd.pad2d(jnp.asarray(img), pad, mode), atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_pad2d_tiny_levels(mode):
    """1-pixel dimensions, as on a pyramid's coarsest levels."""
    for shape in [(1, 1), (1, 4), (3, 1), (2, 2)]:
        img = _img(*shape)
        _close(tbd.pad2d(torch.from_numpy(img), (2, 3, 2, 5), mode),
               jbd.pad2d(jnp.asarray(img), (2, 3, 2, 5), mode), atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_gather2d_matches(mode):
    img = _img()
    rng = np.random.default_rng(5)
    x = rng.integers(-30, 40, size=(6, 7))
    y = rng.integers(-25, 30, size=(6, 7))
    _close(tbd.gather2d(torch.from_numpy(img), torch.from_numpy(x),
                        torch.from_numpy(y), mode),
           jbd.gather2d(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                        mode), atol=0)


@pytest.mark.parametrize("border", MODES)
@pytest.mark.parametrize("flip", [False, True])
def test_conv2d_matches(border, flip):
    img = _img(17, 23)
    k = np.random.default_rng(8).normal(size=(3, 5))
    _close(tfil.conv2d(torch.from_numpy(img), k, border, flip),
           jfil.conv2d(jnp.asarray(img), jnp.asarray(k), border, flip))


def test_conv2d_anchor_matches():
    img = _img(17, 23)
    k = np.array([[-0.25, 0.25], [-0.25, 0.25]])
    _close(tfil.conv2d(torch.from_numpy(img), k, tbd.CLAMP, anchor=(0, 0)),
           jfil.conv2d(jnp.asarray(img), jnp.asarray(k), jbd.CLAMP,
                       anchor=(0, 0)))


@pytest.mark.parametrize("size", [3, 5])
def test_box_filter_matches(size):
    img = _img(17, 23)
    _close(tfil.box_filter(torch.from_numpy(img), size),
           jfil.box_filter(jnp.asarray(img), size))


def test_sep_conv2d_matches():
    img = _img(17, 23)
    rng = np.random.default_rng(9)
    kx, ky = rng.normal(size=7), rng.normal(size=3)
    for border in MODES:
        _close(tfil.sep_conv2d(torch.from_numpy(img), kx, ky, border),
               jfil.sep_conv2d(jnp.asarray(img), jnp.asarray(kx),
                               jnp.asarray(ky), border))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_sobel_opencv_matches(axis):
    img = 255.0 * np.random.default_rng(4).uniform(size=(19, 31))
    _close(tder.sobel_opencv(torch.from_numpy(img), axis),
           jder.sobel_opencv(jnp.asarray(img), axis))
