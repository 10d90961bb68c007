"""The sepconv, poly-expansion and blur-solve kernels' plain versions
against tpuflow's Pallas kernels, on the CPU.

The Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them; the port's wrappers take their plain versions for CPU tensors. Both
sides compute in float32 and sum in different orders (tpuflow's sepconv
uses a log2-doubling sum for uniform taps, its blur-solve 8-tap block
sums), so the tolerances are tests/test_kernels.py's: 2e-5 for sepconv,
1e-4 for poly on 0-255 images, 1e-5 for blur-solve on a well-conditioned
M. The CUDA kernels themselves are held to these plain versions on the
card by chip_smoke.py. The refusal and dispatch tests use a stand-in for
a CUDA tensor: the wrappers must refuse it before any build or launch, or
hand it to the launch function of the form its shape picks (replaced here
by a recorder).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.core import borders as jbd
from tpuflow.kernels.fb_kernels import (fb_blur_solve_pallas,
                                        fb_poly_expansion_pallas)
from tpuflow.kernels.sepconv import sep_conv2d_valid_pallas
from tpuflow.solvers.farneback import _poly_exp_matrices
from tpuflow_torch.core import borders as tbd
from tpuflow_torch.kernels import _build, fb_kernels, sepconv


def _counts():
    return sepconv.LAUNCHES, dict(fb_kernels.LAUNCHES)


@pytest.mark.parametrize("taps", [(5, 5), (17, 17), (48, 48), (64, 64),
                                  (3, 21)])
@pytest.mark.parametrize("out_hw", [(40, 56), (57, 83)])
def test_sepconv_plain_matches_pallas(taps, out_hw):
    nky, nkx = taps
    rng = np.random.default_rng(nky * 100 + nkx)
    padded = rng.normal(size=(out_hw[0] + nky - 1, out_hw[1] + nkx - 1))
    padded = padded.astype(np.float32)
    # Signed taps scaled to unit energy, so each pass keeps the image's
    # scale (as the Gaussian and box taps of the main path do).
    ky = rng.normal(size=nky) / np.sqrt(nky)
    kx = rng.normal(size=nkx) / np.sqrt(nkx)
    before = _counts()
    out = sepconv.sep_conv2d_valid(torch.from_numpy(padded), ky, kx)
    ref = sep_conv2d_valid_pallas(
        jnp.asarray(padded), tuple(map(float, ky)), tuple(map(float, kx)),
        interpret=True)
    assert out.shape == out_hw and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    assert _counts() == before  # CPU tensors launch nothing


@pytest.mark.parametrize("n", [15, 48])
def test_sepconv_plain_matches_pallas_uniform_taps(n):
    """Farneback's box taps: tpuflow takes its doubling sum, the port the
    direct tap loop."""
    rng = np.random.default_rng(n)
    padded = rng.normal(size=(40 + n - 1, 56 + n - 1)).astype(np.float32)
    taps = np.full(n, 1.0 / n)
    out = sepconv.sep_conv2d_valid(torch.from_numpy(padded), taps, taps)
    ref = sep_conv2d_valid_pallas(jnp.asarray(padded),
                                  tuple(map(float, taps)),
                                  tuple(map(float, taps)), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("taps", [(129, 129), (161, 5), (3, 170)])
def test_sepconv_plain_matches_pallas_wide_taps(taps):
    """Tap counts past the kernel's parameter struct (128 a axis), which the
    card takes from device memory."""
    nky, nkx = taps
    rng = np.random.default_rng(nky * 1000 + nkx)
    padded = rng.normal(size=(9 + nky - 1, 21 + nkx - 1)).astype(np.float32)
    ky = rng.normal(size=nky) / np.sqrt(nky)
    kx = rng.normal(size=nkx) / np.sqrt(nkx)
    out = sepconv.sep_conv2d_valid(torch.from_numpy(padded), ky, kx)
    ref = sep_conv2d_valid_pallas(
        jnp.asarray(padded), tuple(map(float, ky)), tuple(map(float, kx)),
        interpret=True)
    assert out.shape == (9, 21)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_sepconv_taps_rounded_once_to_the_image_dtype():
    """float32 images see float32 taps, float64 images the float64 taps."""
    k = np.array([0.1, 0.7, 0.2])
    assert sepconv.host_taps(k, torch.float32).dtype == np.float32
    assert np.array_equal(sepconv.host_taps(k, torch.float64), k)
    img = np.random.default_rng(0).normal(size=(9, 11))
    out = sepconv.sep_conv2d_valid(torch.from_numpy(img), k, k)
    ref = sum(k[i] * k[j] * img[i : i + 7, j : j + 9]
              for i in range(3) for j in range(3))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-14)


def _poly_args(n, sigma):
    g, ginv = _poly_exp_matrices(n, sigma)
    xs = np.arange(-n, n + 1, dtype=np.float64)
    rows = ginv[1:6].copy()
    rows[4] *= 0.5
    return g, g * xs, g * xs * xs, rows


@pytest.mark.parametrize("n,sigma", [(8, 1.2), (5, 1.1)])
@pytest.mark.parametrize("hw", [(40, 56), (57, 83)])
def test_poly_plain_matches_pallas(n, sigma, hw):
    rng = np.random.default_rng(n)
    img = rng.uniform(0, 255, hw).astype(np.float32)
    g, gx, gxx, rows = _poly_args(n, sigma)
    before = _counts()
    padded_t = tbd.pad2d(torch.from_numpy(img), n, tbd.CLAMP)
    out = fb_kernels.fb_poly_expansion(padded_t, g, gx, gxx, rows)
    padded_j = jbd.pad2d(jnp.asarray(img), (n, n, n, n), jbd.CLAMP)
    ref = fb_poly_expansion_pallas(
        padded_j, tuple(map(float, g)), tuple(map(float, gx)),
        tuple(map(float, gxx)), tuple(tuple(map(float, r)) for r in rows),
        interpret=True)
    for a, b in zip(out, ref):
        assert a.shape == hw
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    assert _counts() == before


def test_poly_plain_matches_pallas_wide_taps():
    """poly_n 33 (67 taps), past the kernel's parameter struct (64)."""
    n, hw = 33, (11, 19)
    img = np.random.default_rng(n).uniform(0, 255, hw).astype(np.float32)
    g, gx, gxx, rows = _poly_args(n, 0.15 * n + 0.4)
    padded_t = tbd.pad2d(torch.from_numpy(img), n, tbd.CLAMP)
    out = fb_kernels.fb_poly_expansion(padded_t, g, gx, gxx, rows)
    padded_j = jbd.pad2d(jnp.asarray(img), (n, n, n, n), jbd.CLAMP)
    ref = fb_poly_expansion_pallas(
        padded_j, tuple(map(float, g)), tuple(map(float, gx)),
        tuple(map(float, gxx)), tuple(tuple(map(float, r)) for r in rows),
        interpret=True)
    for a, b in zip(out, ref):
        assert a.shape == hw
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_poly_plain_skips_zero_coefficients():
    """A zero G^-1 coefficient drops its term (so an inf moment does not
    turn the output into nan), and an all-zero row gives zeros."""
    img = torch.zeros((5, 5), dtype=torch.float64)
    img[2, 2] = float("inf")
    one = np.array([1.0])
    rows = np.zeros((5, 6))
    rows[0, 0] = 1.0
    out = fb_kernels.fb_poly_expansion(img, one, 0 * one, 0 * one, rows)
    assert torch.isinf(out[0][2, 2]) and not torch.isnan(out[0]).any()
    assert all(torch.equal(o, torch.zeros((5, 5), dtype=torch.float64))
               for o in out[1:])


def _well_conditioned_m(h, w, seed):
    """tests/test_kernels.py's normal-equation field: A^T A and A^T b of a
    random A with a small off-diagonal."""
    r = np.random.default_rng(seed)
    a11 = r.normal(size=(h, w))
    a12 = 0.2 * r.normal(size=(h, w))
    a22 = r.normal(size=(h, w))
    db1 = r.normal(size=(h, w))
    db2 = r.normal(size=(h, w))
    return np.stack([a11 * a11 + a12 * a12, a12 * (a11 + a22),
                     a12 * a12 + a22 * a22, a11 * db1 + a12 * db2,
                     a12 * db1 + a22 * db2]).astype(np.float32)


@pytest.mark.parametrize("winsize", [9, 15, 48, 64])
@pytest.mark.parametrize("hw", [(40, 56), (57, 83)])
def test_blur_solve_plain_matches_pallas(winsize, hw):
    h, w = hw
    M = _well_conditioned_m(h, w, winsize)
    m = winsize // 2
    Mp = np.pad(M, ((0, 0), (m, m), (m, m)), mode="edge")
    before = _counts()
    u, v = fb_kernels.fb_blur_solve(torch.from_numpy(Mp), winsize)
    uj, vj = fb_blur_solve_pallas(jnp.asarray(Mp), winsize, interpret=True)
    extra = 1 - winsize % 2  # an even window gives one more row and column
    assert u.shape == (h + extra, w + extra) == uj.shape
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    assert _counts() == before


@pytest.mark.parametrize("winsize,atol", [(200, 1e-5), (640, 1e-4)])
def test_blur_solve_plain_matches_pallas_wide_window(winsize, atol):
    """Windows past the parent kernel's shared-memory ceiling (~155): the
    card runs 200 staged and 640 in the wide form. tpuflow sums in 8-tap
    blocks, the port tap by tap; the two orders' float32 rounding grows
    with the 2 x 640 terms of a sum, so 640 is held at 1e-4 (2.4e-5
    measured on this input), the others at 1e-5."""
    h, w = 13, 22
    M = _well_conditioned_m(h, w, winsize)
    m = winsize // 2
    Mp = np.pad(M, ((0, 0), (m, m), (m, m)), mode="edge")
    u, v = fb_kernels.fb_blur_solve(torch.from_numpy(Mp), winsize)
    uj, vj = fb_blur_solve_pallas(jnp.asarray(Mp), winsize, interpret=True)
    assert u.shape == (h + 1, w + 1) == uj.shape
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=atol)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=atol)


def test_blur_solve_clamps_singular_det():
    """A singular system (m11 = m12 = 0) solves against det = 1e-9:
    u = m22 * h1 / 1e-9, v = 0."""
    M = torch.zeros((5, 8, 9), dtype=torch.float32)
    M[2] = 1.0
    M[3] = 1e-12
    u, v = fb_kernels.fb_blur_solve(M, 3)
    torch.testing.assert_close(u, torch.full_like(u, 1e-3), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(v, torch.zeros_like(v))


class CudaStandIn:
    """Stands in for a CUDA tensor (there is no card here): it carries
    what the wrappers' argument checks read, and nothing to launch on."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def unbind(self, dim):
        assert dim == 0
        return [CudaStandIn(self.shape[1:], self.dtype)
                for _ in range(self.shape[0])]


LAUNCH_FNS = {sepconv: ("_launch", "_wide_launch"),
              fb_kernels: ("_poly_launch", "_poly_wide_launch",
                           "_blur_launch", "_blur_wide_launch")}


def _launched(monkeypatch, module, fn, *args):
    """The launch functions of ``module`` that fn(*args) calls, each
    replaced by a recorder (no build, no launch)."""
    calls = []
    for name in LAUNCH_FNS[module]:
        monkeypatch.setattr(module, name,
                            lambda *a, name=name: calls.append(name))
    fn(*args)
    return calls


def test_sepconv_refuses_what_the_kernel_cannot_run(monkeypatch):
    k5 = np.ones(5)
    with pytest.raises(TypeError, match="float32"):
        sepconv.sep_conv2d_valid(CudaStandIn((40, 40), torch.float64), k5, k5)
    with pytest.raises(ValueError, match="do not fit"):
        sepconv.sep_conv2d_valid(CudaStandIn((4, 40)), k5, k5)
    # 129 taps, past the parameter struct: the staged kernel, its taps from
    # device memory.
    assert _launched(monkeypatch, sepconv, sepconv.sep_conv2d_valid,
                     CudaStandIn((400, 400)), np.ones(129), k5) == ["_launch"]
    assert sepconv.instantiation(129, 5) == (sepconv.DEVICE_TAPS,) * 2
    with pytest.raises(ValueError):
        sepconv.sep_conv2d_valid(torch.zeros((2, 8, 8)), k5, k5)


def test_poly_refuses_what_the_kernel_cannot_run(monkeypatch):
    g, gx, gxx, rows = _poly_args(5, 1.1)
    with pytest.raises(TypeError, match="float32"):
        fb_kernels.fb_poly_expansion(CudaStandIn((50, 50), torch.float64),
                                     g, gx, gxx, rows)
    with pytest.raises(ValueError, match="do not fit"):
        fb_kernels.fb_poly_expansion(CudaStandIn((50, 50)), g, gx[:-1], gxx,
                                     rows)
    # 65 taps, past the parameter struct: the staged kernel, its taps from
    # device memory.
    g65, gx65, gxx65, rows65 = _poly_args(32, 8.0)
    assert _launched(monkeypatch, fb_kernels, fb_kernels.fb_poly_expansion,
                     CudaStandIn((200, 200)), g65, gx65, gxx65,
                     rows65) == ["_poly_launch"]
    assert fb_kernels.poly_instantiation(65) == fb_kernels.DEVICE_TAPS


def test_blur_solve_refuses_what_the_kernel_cannot_run(monkeypatch):
    with pytest.raises(TypeError, match="float32"):
        fb_kernels.fb_blur_solve(CudaStandIn((5, 80, 80), torch.float64), 15)
    with pytest.raises(ValueError, match=r"\(5, Hp, Wp\)"):
        fb_kernels.fb_blur_solve(CudaStandIn((4, 80, 80)), 15)
    with pytest.raises(ValueError, match="does not fit"):
        fb_kernels.fb_blur_solve(CudaStandIn((5, 10, 80)), 15)
    # Winsize 200, past the parent kernel's shared memory: staged.
    assert _launched(monkeypatch, fb_kernels, fb_kernels.fb_blur_solve,
                     CudaStandIn((5, 400, 400)), 200) == ["_blur_launch"]


@pytest.mark.parametrize("case", [
    # (module, wrapper, shape, taps or winsize, launch function)
    ("sep", (1128, 1967), (48, 48), "_launch"),
    ("sep", (1082, 1922), (3, 3), "_launch"),
    ("sep", (900, 900), (652, 652), "_launch"),
    ("sep", (900, 900), (5, 653), "_wide_launch"),
    ("sep", (900, 900), (653, 5), "_launch"),
    ("poly", (1096, 1936), 17, "_poly_launch"),
    ("poly", (1200, 1200), 995, "_poly_launch"),
    ("poly", (1200, 1200), 997, "_poly_wide_launch"),
    ("blur", (5, 1128, 1968), 48, "_blur_launch"),
    ("blur", (5, 700, 700), 598, "_blur_launch"),
    ("blur", (5, 700, 700), 599, "_blur_wide_launch"),
])
def test_wrappers_dispatch_by_shape(monkeypatch, case):
    """A CUDA tensor goes to the staged kernel at the main paths' shapes
    and past them while its tile fits, and to the wide form beyond."""
    kind, shape, arg, want = case
    x = CudaStandIn(shape)
    if kind == "sep":
        got = _launched(monkeypatch, sepconv, sepconv.sep_conv2d_valid, x,
                        np.ones(arg[0]), np.ones(arg[1]))
        assert sepconv.form_for(*arg) == ("wide" if "wide" in want
                                          else "staged")
    elif kind == "poly":
        taps = np.ones(arg)
        got = _launched(monkeypatch, fb_kernels, fb_kernels.fb_poly_expansion,
                        x, taps, taps, taps, np.ones((5, 6)))
        assert fb_kernels.poly_form(arg) == ("wide" if "wide" in want
                                             else "staged")
    else:
        got = _launched(monkeypatch, fb_kernels, fb_kernels.fb_blur_solve, x,
                        arg)
        assert fb_kernels.blur_form(arg) == ("wide" if "wide" in want
                                             else "staged")
    assert got == [want]


def test_main_path_geometries_fit_shared_memory():
    """The taps and windows of the bench configs fit one Hopper block."""
    assert sepconv.smem_bytes(64, 64) <= _build.MAX_SMEM_BYTES
    assert sepconv.smem_bytes(sepconv.MAX_TAPS, sepconv.MAX_TAPS) \
        <= _build.MAX_SMEM_BYTES
    assert fb_kernels.poly_smem_bytes(fb_kernels.MAX_POLY_TAPS) \
        <= _build.MAX_SMEM_BYTES
    for winsize in (15, 48, 64):
        assert fb_kernels.blur_smem_bytes(winsize) <= _build.MAX_SMEM_BYTES
