"""tpuflow_torch's filters, color and resampling against tpuflow's, on the
CPU in float64.

Same numpy inputs through both packages; atol 1e-12 (separable and 2-D
sums, and pow vs cbrt, differ in the last bits), except where a test
states its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.core import color as jcol
from tpuflow.core import resample as jres
from tpuflow.ops import filters as jfil
from tpuflow_torch.core import color as tcol
from tpuflow_torch.core import resample as tres
from tpuflow_torch.ops import filters as tfil

ATOL = 1e-12


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _rgb(h=13, w=17, seed=2):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3))


def test_rgb_to_gray_and_back():
    rgb = 255.0 * _rgb()
    gray = tcol.rgb_to_gray(torch.from_numpy(rgb))
    _close(gray, jcol.rgb_to_gray(jnp.asarray(rgb)))
    _close(tcol.gray_to_rgb(gray), jcol.gray_to_rgb(jnp.asarray(gray.numpy())),
           atol=0)


def test_srgb_to_lab_matches():
    """Includes both branches of the gamma and of the Lab f: exact 0 and 1,
    dark values below 0.04045 and mid-range values."""
    rgb = _rgb()
    rgb[0, :3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.01, 0.03, 0.002]]
    _close(tcol.srgb_to_lab(torch.from_numpy(rgb)),
           jcol.srgb_to_lab(jnp.asarray(rgb)))
    assert tcol.LAB_SCALE == jcol.LAB_SCALE


@pytest.mark.parametrize("out_wh", [(7, 5), (40, 29), (17, 13)])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_zero_order_hold_matches(out_wh, channels):
    img = _rgb() if channels else _rgb()[..., 0]
    _close(tres.resize_zero_order_hold(torch.from_numpy(img), out_wh),
           jres.resize_zero_order_hold(jnp.asarray(img), out_wh), atol=0)


@pytest.mark.parametrize("out_wh", [(7, 5), (40, 29)])
def test_resize_bicubic_matches(out_wh):
    img = 255.0 * _rgb()[..., 1]
    _close(tres.resize_bicubic(torch.from_numpy(img), out_wh),
           jres.resize_bicubic(jnp.asarray(img), out_wh))
    _close(tres.resample(torch.from_numpy(img), out_wh, tres.BICUBIC),
           jres.resample(jnp.asarray(img), out_wh, jres.BICUBIC))
    _close(tres.resample(torch.from_numpy(img), out_wh),
           jres.resample(jnp.asarray(img), out_wh), atol=0)


def test_resize_bicubic_of_integer_image_is_float32():
    img = (255 * _rgb()[..., 2]).astype(np.uint8)
    got = tres.resize_bicubic(torch.from_numpy(img), (9, 6))
    ref = jres.resize_bicubic(jnp.asarray(img), (9, 6))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, atol=1e-4)


@pytest.mark.parametrize("size_wh", [(5, 5), (3, 7), (4, 4), (6, 3)])
def test_gaussian_filter_matches(size_wh):
    """Odd sizes go through sep_conv2d, even ones through the diamond
    kernel and conv2d, in both packages."""
    img = 255.0 * _rgb(21, 26)[..., 0]
    _close(tfil.gaussian_filter(torch.from_numpy(img), size_wh, 1.3),
           jfil.gaussian_filter(jnp.asarray(img), size_wh, 1.3))


@pytest.mark.parametrize("size_wh", [(5, 5), (4, 6)])
def test_gaussian_kernel_matches(size_wh):
    _close(tfil.gaussian_kernel(size_wh, 0.9, dtype=torch.float64),
           jfil.gaussian_kernel(size_wh, 0.9, dtype=jnp.float64))
    # The default dtype is float32, as in tpuflow.
    assert tfil.gaussian_kernel(size_wh, 0.9).dtype == torch.float32


@pytest.mark.parametrize("mirroring", [False, True])
def test_filterer_matches(mirroring):
    img = _rgb(19, 23)[..., 2]
    k = np.random.default_rng(7).normal(size=(3, 4))
    _close(tfil.filterer(torch.from_numpy(img), k, mirroring),
           jfil.filterer(jnp.asarray(img), jnp.asarray(k), mirroring))


@pytest.mark.parametrize("n", [4, 48])
def test_sep_conv2d_even_taps_match(n):
    """Even taps pad n//2 on both sides: one extra output row and column
    (Farneback's _blur_same crops it), as in tpuflow."""
    img = _rgb(30, 52)[..., 0]
    k = np.full(n, 1.0 / n)
    got = tfil.sep_conv2d(torch.from_numpy(img), k, k, border="clamp")
    ref = jfil.sep_conv2d(jnp.asarray(img), k, k, border="clamp")
    assert tuple(got.shape) == (31, 53) == ref.shape
    _close(got, ref)
