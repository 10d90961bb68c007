"""The gated refine's energy check (``irls_stencil.irls_gated_energy``) on
the CPU.

The CPU takes the plain version, which must be the refine's energy as the
three refine loops computed it inline (the float32 terms of
``bm_flow._neighbor_energy`` and the data term, summed in float64), to the
last bit. ``gated_energy_kernel`` has no CPU form: a NumPy model of it
(each pixel's term with gated-off neighbours skipped, then its fixed
float64 sum order) holds its design against the plain version, the terms
bitwise and the sum to 1e-12. The wrapper's argument checks run on meta
tensors, which reach the checks the card path makes.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpuflow_torch.solvers.bm_flow as tb
from flowbench import harness
from tpuflow_torch.kernels import irls_stencil
from tpuflow_torch.solvers.mestimators import geman_mcclure_rho

ARGS = (tb.LAMBDA_D, tb.LAMBDA_S, tb.SIGMA_D_BM, tb.SIGMA_S_BM)
SUM_RTOL = 1e-12
CU = (Path(irls_stencil.__file__).resolve().parent.parent / "csrc"
      / "irls_gated.cu")


def _fields(batch, dtype, h=40, w=70, seed=5):
    """u, v with zero vectors and opposed neighbours (both branches of the
    cosine), gx, gy, it and 6 regions' labels; u, v, it (B, H, W) or
    (H, W) at batch 0."""
    rng = np.random.default_rng(seed)
    b = max(batch, 1)
    u = 0.3 * rng.normal(size=(b, h, w))
    v = 0.3 * rng.normal(size=(b, h, w))
    u[:, ::7, ::5] = 0.0
    v[:, ::7, ::5] = 0.0
    u[:, 3, 1::2] = -u[:, 3, 0:-1:2]
    v[:, 3, 1::2] = -v[:, 3, 0:-1:2]
    it = 5.0 * rng.normal(size=(b, h, w))
    gx, gy = 5.0 * rng.normal(size=(2, h, w))
    labels = rng.integers(0, 6, (h, w)).astype(np.int32)
    labels[10:20] = 2  # one larger region
    cut = (slice(None) if batch else 0)
    fields = [torch.from_numpy(np.ascontiguousarray(a[cut])).to(dtype)
              for a in (u, v, it)]
    return (fields[0], fields[1], torch.from_numpy(gx).to(dtype),
            torch.from_numpy(gy).to(dtype), fields[2],
            torch.from_numpy(labels))


def _inline_terms(u, v, gx, gy, it, labels):
    """Each pixel's term as the refine loops computed it inline."""
    gates = tb._region_gates(labels, gx.dtype)
    center = geman_mcclure_rho(gx * u + gy * v + it, ARGS[2])
    return (ARGS[0] * center
            + ARGS[1] * tb._neighbor_energy(u, v, labels, ARGS[3], gates))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [0, 1, 2])
def test_energy_is_the_refine_energy(batch, dtype):
    """On the CPU, bitwise the refine's inline energy; one float64 a
    direction; no launch."""
    fields = _fields(batch, dtype)
    before = irls_stencil.LAUNCHES_GATED_ENERGY
    got = irls_stencil.irls_gated_energy(*fields, *ARGS)
    want = torch.sum(_inline_terms(*fields), dim=(-2, -1),
                     dtype=torch.float64)
    assert got.dtype == torch.float64
    assert got.shape == fields[0].shape[:-2]
    assert torch.equal(got, want)
    assert torch.equal(irls_stencil.irls_gated_energy_plain(*fields, *ARGS),
                       want)
    assert irls_stencil.LAUNCHES_GATED_ENERGY == before


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


def _model_terms(u, v, gx, gy, it, labels):
    """gated_energy_kernel's float32 term of each pixel: the neighbours
    read where they are in the frame and in the pixel's region, the others
    skipped, each operation rounded (NumPy float32)."""
    f = np.float32
    ld, ls, sd, ss = (f(a) for a in ARGS)
    u, v, gx, gy, it = (a.numpy() for a in (u, v, gx, gy, it))
    lab = labels.numpy()
    h, w = lab.shape

    def rho(x, s):
        return x * x / (s + x * x)

    center = rho(gx * u + gy * v + it, sd)
    nc = np.sqrt(u * u + v * v)
    e = np.zeros_like(u)
    ys, xs = np.mgrid[0:h, 0:w]
    for dx, dy in irls_stencil.NEIGHBORS:
        qy, qx = ys + dy, xs + dx
        inside = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
        qy, qx = np.clip(qy, 0, h - 1), np.clip(qx, 0, w - 1)
        gate = inside & (lab[qy, qx] == lab)
        uq, vq = u[..., qy, qx], v[..., qy, qx]
        prod = nc * np.sqrt(uq * uq + vq * vq)
        with np.errstate(all="ignore"):
            cosang = np.where(prod > 0, (u * uq + v * vq)
                              / np.maximum(prod, f(1e-30)), f(1.0))
        m = f(0.5) * (f(1.0) + cosang)
        e = np.where(gate, e + m * (rho(u - uq, ss) + rho(v - vq, ss)), e)
    return ld * center + ls * e


def _model_sum(terms):
    """gated_energy_kernel's float64 sum of one direction's terms: each
    thread adds its pixels in order (block k's thread t the pixels
    k * P * T + j * T + t, j < P), the block its threads in a fixed tree;
    then the last block: thread t the partials t, t + T, ... in order, and
    the same tree."""
    threads = _cu_constant("ENERGY_THREADS")
    pixels = _cu_constant("ENERGY_PIXELS")

    def rows_then_tree(x, rows):
        # x: (..., rows * threads) zero-padded; rows added in order, then
        # the threads' sums in the tree.
        x = x.reshape(*x.shape[:-1], rows, threads)
        acc = np.zeros(x.shape[:-2] + (threads,))
        for k in range(rows):
            acc = acc + x[..., k, :]
        stride = threads // 2
        while stride:
            acc[..., :stride] += acc[..., stride : 2 * stride]
            stride //= 2
        return acc[..., 0]

    def padded(x, size):
        return np.concatenate([x, np.zeros(size - x.size)])

    x = terms.astype(np.float64).ravel()
    span = threads * pixels
    blocks = -(-x.size // span)
    partials = rows_then_tree(padded(x, blocks * span).reshape(blocks, span),
                              pixels)
    rows = -(-blocks // threads)
    return float(rows_then_tree(padded(partials, rows * threads), rows))


@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_model_matches_plain(batch):
    """The kernel's design on the CPU: its float32 terms bitwise the plain
    version's, its sum within SUM_RTOL of the plain float64 sum."""
    fields = _fields(batch, torch.float32, h=61, w=83)
    model = _model_terms(*fields)
    plain = _inline_terms(*fields).numpy()
    np.testing.assert_array_equal(model.view(np.int32), plain.view(np.int32))
    want = irls_stencil.irls_gated_energy(*fields, *ARGS)
    for b in range(batch):
        got = _model_sum(model[b])
        assert abs(got - float(want[b])) <= SUM_RTOL * abs(float(want[b]))


def test_energy_wrapper_rejects():
    u, v, gx, gy, it, labels = _fields(2, torch.float32)

    def call(*fields):
        return irls_stencil.irls_gated_energy(*fields, *ARGS)

    with pytest.raises(ValueError, match="share"):
        call(u[:, :-1], v, gx, gy, it, labels)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        call(u, v, gx[:-1], gy, it, labels)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        call(u, v, gx, gy, it, labels[:, :-1])
    with pytest.raises(ValueError, match="tensors on"):
        call(u, v, gx.to("meta"), gy, it, labels)
    meta = [f.to("meta") for f in (u, v, gx, gy, it, labels)]
    with pytest.raises(TypeError, match="float32 fields"):
        call(meta[0].double(), *meta[1:])
    with pytest.raises(TypeError, match="int32 labels"):
        call(*meta[:5], meta[5].long())
    with pytest.raises(ValueError, match="contiguous"):
        call(meta[0].transpose(-2, -1).contiguous().transpose(-2, -1),
             *meta[1:])
    with pytest.raises(ValueError, match="no kernel"):
        call(*meta)


def test_kernel_is_own_and_not_the_sweeps():
    """The energy kernel counts among the program's own kernels (so it
    leaves eager_device_ms_per_frame) and the sweeps' roofline, read by
    the name irls_gated_kernel, does not take its time."""
    assert {"gated_energy_kernel", "irls_gated_kernel"} <= (
        harness.program_kernels())
    trace = SimpleNamespace(op_s={
        "(anonymous namespace)::gated_energy_kernel(float const*, float "
        "const*, float const*, float const*, float const*, int const*, "
        "double*, double*, int, int, float, float, float, float)": 2.0,
        "void (anonymous namespace)::irls_gated_kernel<false>(float const*, "
        "float const*)": 3.0})
    assert harness.kernel_s(trace, "irls_gated_kernel") == 3.0
    assert harness.kernel_s(trace, "gated_energy_kernel") == 2.0
