"""The L1 ops of scratch detection and the alignment search, the
configuration they read, and the fixed-order arithmetic they rest on:
tpuflow_torch against tpuflow on the CPU in float64.

- ``epsilon_filter``, ``horizontal_median``, ``derivator`` (Normal and
  Sobel, zero and mirror borders) and ``derivation_abs``: bitwise (the
  same elementwise operations in the same order);
- ``derivative_angler``: bitwise on 0/255 maps whose flat pixels and
  gradients are exact; on a float frame within 4.5e-16 (``atan2`` is
  the platform's: XLA's and PyTorch's round apart in the last bit);
- ``numerics.scan_cumsum`` and ``numerics.window_sum`` are bitwise
  ``jnp.cumsum`` and ``jnp.sum`` of XLA's CPU compiler, ``numerics.fma``
  the correctly rounded fused multiply-add (held to exact rationals);
- ``FilterParam``, ``HogParam`` and ``Options`` have tpuflow's fields and
  defaults, and ``from_tpuflow`` carries an ``Options`` with its nested
  params across as the port's own classes.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.core.config as jcfg
import tpuflow.ops as J
import tpuflow_torch.core.config as tcfg
import tpuflow_torch.ops as T
from tpuflow_torch.utils import numerics

ANGLE_ATOL = 4.5e-16


def _frame(seed=0, h=30, w=41):
    return np.random.default_rng(seed).uniform(0, 255, (h, w))


def _both(fn_j, fn_t, *arrays, **kw):
    a = fn_j(*[jnp.asarray(x) for x in arrays], **kw)
    b = fn_t(*[torch.from_numpy(np.array(x)) for x in arrays], **kw)
    if isinstance(a, tuple):
        return [np.asarray(x) for x in a], [y.numpy() for y in b]
    return np.asarray(a), b.numpy()


@pytest.mark.parametrize("size,eps", [((5, 3), 20.0), ((21, 21), 20.0),
                                      ((1, 1), 1.0), ((3, 9), 0.0)])
def test_epsilon_filter_bitwise(size, eps):
    a, b = _both(lambda x: J.epsilon_filter(x, size, eps),
                 lambda x: T.epsilon_filter(x, size, eps), _frame())
    np.testing.assert_array_equal(b, a)


def test_epsilon_filter_rejects_even_size():
    with pytest.raises(ValueError, match="odd and positive"):
        T.epsilon_filter(torch.zeros(8, 8), (4, 3), 1.0)
    with pytest.raises(ValueError, match="odd and positive"):
        J.epsilon_filter(jnp.zeros((8, 8)), (4, 3), 1.0)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 7])
def test_horizontal_median_bitwise(width):
    a, b = _both(lambda x: J.horizontal_median(x, width),
                 lambda x: T.horizontal_median(x, width), _frame(1))
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind", ["Normal", "Sobel"])
@pytest.mark.parametrize("mirroring", [False, True])
def test_derivator_and_abs_bitwise(kind, mirroring):
    a, b = _both(lambda x: J.derivator(x, kind, mirroring),
                 lambda x: T.derivator(x, kind, mirroring), _frame(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    ma, mb = _both(J.derivation_abs, T.derivation_abs, *a)
    np.testing.assert_array_equal(mb, ma)


def test_derivator_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown derivator type"):
        T.derivator(torch.zeros(4, 4), "Scharr")


def test_derivative_angler():
    rng = np.random.default_rng(3)
    binary = (rng.uniform(0, 1, (40, 56)) > 0.8) * 255.0
    a, b = _both(J.derivative_angler, T.derivative_angler, binary)
    np.testing.assert_array_equal(b, a)
    assert (a == -4.0).any() and (a >= 0).any()
    a, b = _both(J.derivative_angler, T.derivative_angler, _frame(4))
    np.testing.assert_allclose(b, a, rtol=0, atol=ANGLE_ATOL)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 17, 100, 377, 1240])
def test_scan_cumsum_is_xla_cumsum(n):
    x = np.random.default_rng(n).uniform(0, 1, (6, n, 3))
    for axis in range(3):
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=axis))
        got = numerics.scan_cumsum(torch.from_numpy(x), axis).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [33, 72, 144, 200, 1100])
def test_window_sum_is_xla_sum(n):
    x = np.random.default_rng(n).uniform(0, 1, (7, 9, n))
    want = np.asarray(jax.jit(lambda a: jnp.sum(a * a, axis=-1))(
        jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(numerics.window_sum(t * t, -1).numpy(),
                                  want)
    np.testing.assert_array_equal(
        numerics.window_sum((t * t).movedim(-1, 0), 0).numpy(), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fma_is_correctly_rounded(dtype):
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=3000).astype(dtype) for _ in range(3))
    a[:300] *= dtype(1e-6)
    c[300:600] = -(a[300:600] * b[300:600])  # cancellation
    got = numerics.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()

    def nearest(fr):
        f = dtype(float(fr))
        cands = [np.nextafter(f, dtype(-np.inf)), f,
                 np.nextafter(f, dtype(np.inf))]
        return min(cands, key=lambda q: (abs(Fraction(float(q)) - fr),
                                         int(np.array(q).view(
                                             np.int64 if dtype == np.float64
                                             else np.int32)) & 1))

    want = np.array([nearest(Fraction(float(x)) * Fraction(float(y))
                             + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=dtype)
    np.testing.assert_array_equal(got, want)


def _fields(cls):
    return {f.name for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["FilterParam", "HogParam", "Options",
                                  "PlotParam", "MultipleMotionParam"])
def test_config_classes_match_tpuflow(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(tc) == _fields(jc)
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())


def test_config_constants_match_tpuflow():
    names = [n for n in dir(jcfg) if n.isupper()]
    assert len(names) >= 30
    assert {n: getattr(tcfg, n, None) for n in names} == \
        {n: getattr(jcfg, n) for n in names}


@pytest.mark.parametrize("name", ["epsilon", "Gaussian", "none"])
def test_change_filter(name):
    got = tcfg.FilterParam().change_filter(name)
    want = jcfg.FilterParam().change_filter(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_from_tpuflow_converts_nested_options():
    opts = jcfg.Options(mode=0x2000, s_med=4, exclusive_principle=True,
                        superimpose=jcfg.GREEN, devices=2)
    opts.multiple_motion_param.level = 3
    opts.hog_param.bins = 8
    opts.filter_param = opts.filter_param.change_filter("g")
    opts.plot_param.scale = 2.5
    port = tcfg.from_tpuflow(opts)
    assert type(port) is tcfg.Options
    for name, cls in (("multiple_motion_param", tcfg.MultipleMotionParam),
                      ("hog_param", tcfg.HogParam),
                      ("filter_param", tcfg.FilterParam),
                      ("plot_param", tcfg.PlotParam)):
        assert type(getattr(port, name)) is cls
    assert dataclasses.asdict(port) == dataclasses.asdict(opts)


def test_atan2_same_bits_at_every_thread_count():
    """numerics.atan2 (the HOG and alignment angles' atan2, taken on the
    host) is torch.atan2 below one chunk and does not depend on the torch
    thread count above it."""
    rng = np.random.default_rng(6)
    y, x = (torch.from_numpy(rng.normal(0, 40, 100_003)) for _ in range(2))
    y[:1000], x[:1000] = y[:1000].round(), y[:1000].round()  # diagonals
    small = numerics.atan2(y[:500], x[:500])
    assert torch.equal(small, torch.atan2(y[:500], x[:500]))
    before = torch.get_num_threads()
    want = numerics.atan2(y, x)
    try:
        torch.set_num_threads(1)
        got = numerics.atan2(y, x)
    finally:
        torch.set_num_threads(before)
    assert torch.equal(got, want)
    np.testing.assert_allclose(want.numpy(), np.arctan2(y.numpy(), x.numpy()),
                               rtol=4.5e-16, atol=0)
