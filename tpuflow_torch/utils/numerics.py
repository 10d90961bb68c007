"""Arithmetic that rounds the same on the CPU and on the card."""

from __future__ import annotations

import numpy as np
import torch


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a correctly rounded division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the CPU's division in the last bit
    (unless s is a power of two). Dividing by a 0-d tensor on x's device
    keeps both devices on the IEEE division.
    """
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device.

    PyTorch's vectorized CPU ``sqrt`` is not correctly rounded: about 0.6%
    of float64 (and 0.7% of float32) elements come out an ulp off, where
    the card's ``sqrt`` (and XLA's) rounds correctly. On the CPU this takes
    numpy's, which is; on the card ``torch.sqrt``.
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    return torch.sqrt(x)


def warm_cpu_sqrt() -> None:
    """Run one multi-threaded float64 ``torch.sqrt`` on the CPU.

    With torch 2.13 (CPU build, AVX512), the first such call in a process
    returns, about one time in 45, one thread's share of the tensor with
    ~1e-10 relative error instead of within an ulp; every later call is
    exact. Tests that hold the port's CPU path to 1e-12 call this once
    before they run.
    """
    torch.sqrt(torch.ones(1 << 16, dtype=torch.float64))


#: Elements per CPU ``pow`` call in :func:`pow_fixed_split`: below
#: PyTorch's intra-op grain size (32768), so each call runs on one thread,
#: and a multiple of every vector width, so no call but the last has a
#: scalar tail.
POW_CHUNK = 16384


def pow_fixed_split(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` whose CPU result does not depend on the thread count.

    PyTorch's vectorized CPU loops send the last few elements of each
    thread's share through the scalar routine, and ``pow``'s vector and
    scalar forms round apart in the last bit, so the result depends on how
    the work was split, and so on the thread count. Here the CPU work is
    split at fixed points instead (POW_CHUNK elements a call): the result
    is the same bits as one thread's at every count, and no process-wide
    setting changes. On the card this is ``x ** p``.
    """
    if x.device.type != "cpu" or x.numel() <= POW_CHUNK:
        return x ** p
    flat = x.contiguous().view(-1)
    return torch.cat([c ** p for c in flat.split(POW_CHUNK)]).view(x.shape)



def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``torch.atan2`` with the same bits on every device.

    ``atan2`` is not correctly rounded: the card's and the CPU's differ in
    the last bit, and the HOG bins and the alignment test threshold the
    angle (an exact diagonal gradient of an 8-bit frame sits on a bin
    boundary). So it is taken on the host, for a CUDA tensor too (the
    flagship's Lab conversion does the same), in fixed chunks as in
    :func:`pow_fixed_split` so that the bits do not depend on the thread
    count; the result goes back to y's device.
    """
    if y.device.type != "cpu":
        return atan2(y.cpu(), x.cpu()).to(y.device)
    if y.numel() <= POW_CHUNK:
        return torch.atan2(y, x)
    yf, xf = y.contiguous().view(-1), x.contiguous().view(-1)
    return torch.cat([torch.atan2(a, b) for a, b in
                      zip(yf.split(POW_CHUNK), xf.split(POW_CHUNK))]
                     ).view(y.shape)

#: Block of XLA's CPU cumulative sum: the scanned axis is cut into blocks
#: of this many elements, each scanned sequentially, and the blocks'
#: totals are scanned the same way.
XLA_SCAN_BLOCK = 16


def scan_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim``, grouped as XLA's CPU scan.

    ``jnp.cumsum`` lowers to a reduce-window that XLA's CPU compiler
    rewrites into blocks of :data:`XLA_SCAN_BLOCK`: a sequential prefix
    sum inside each block (the last block padded with zeros), plus the
    sequential (recursively blocked) sum of the earlier blocks' totals.
    These adds, elementwise each, give tpuflow's CPU bits, and the CPU and
    the card give the same bits, where ``torch.cumsum`` on the two devices
    rounds apart.
    """
    dim = dim % x.dim()
    t = x.movedim(dim, -1)
    n = t.shape[-1]
    b = XLA_SCAN_BLOCK

    def seq(blocks):  # sequential inclusive prefix along the last axis
        out = torch.empty_like(blocks)
        acc = blocks[..., 0]
        out[..., 0] = acc
        for i in range(1, blocks.shape[-1]):
            acc = acc + blocks[..., i]
            out[..., i] = acc
        return out

    if n <= b:
        out = seq(t)
    else:
        nb = -(-n // b)
        padded = torch.nn.functional.pad(t, (0, nb * b - n))
        pre = seq(padded.reshape(*t.shape[:-1], nb, b))
        inclusive = scan_cumsum(pre[..., -1], -1)
        offset = torch.cat([torch.zeros_like(inclusive[..., :1]),
                            inclusive[..., :-1]], dim=-1)
        out = (pre + offset[..., None]).reshape(*t.shape[:-1], nb * b)
        out = out[..., :n]
    return out.movedim(-1, dim).contiguous()


#: Window of XLA's CPU tree reduction: a reduced axis longer than this is
#: summed in windows of this many elements, then over the windows.
XLA_REDUCE_WINDOW = 32


def window_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` of a length above :data:`XLA_REDUCE_WINDOW`, in
    XLA's CPU order: the axis, padded at both ends to a multiple of the
    window, is summed sequentially in each window, then the windows'
    sums are (recursively) summed the same way.

    A fixed order of elementwise adds, so the CPU and the card give the
    same bits, and the same bits as ``jnp.sum`` in tpuflow's CPU runs
    (reductions whose operand is not fused into the sum). Each add spans
    every other axis: take ``dim`` as a leading axis for speed.
    """
    dim = dim % x.dim()
    n = x.shape[dim]

    def seq(t, start, stop):
        acc = t.select(dim, start)
        for i in range(start + 1, stop):
            acc = acc + t.select(dim, i)
        return acc

    if n <= XLA_REDUCE_WINDOW:
        # Zero + x is exact: a sequential sum from the first element.
        return seq(x, 0, n)
    w = XLA_REDUCE_WINDOW
    total = -(-n // w) * w
    left = (total - n) // 2
    parts = []
    for k in range(total // w):
        # The window's zero padding adds nothing: sum its real elements.
        lo = max(k * w - left, 0)
        hi = min((k + 1) * w - left, n)
        parts.append(seq(x, lo, hi))
    return window_sum(torch.stack(parts, dim=dim), dim)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    p = a * b
    # Veltkamp's split: 2^ceil(p/2) + 1 for a p-bit significand.
    c = 134217729.0 if a.dtype == torch.float64 else 4097.0

    def split(x):
        t = c * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, from plain adds and multiplies.

    XLA's CPU compiler contracts ``x * y + z`` inside a fusion into a
    fused multiply-add, which PyTorch offers no operation for. This is
    Boldo and Melquiond's emulation: the product split exactly
    (Veltkamp/Dekker), its low part added to the exact remainder of the
    high sum rounded to odd, then one rounding to nearest. Exact for
    float32 and float64 away from overflow and underflow; the same bits on
    every device.
    """
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    # Round s to odd: where the sum was inexact and s's last bit is 0,
    # step one ulp towards the lost part.
    ibits = torch.int64 if s.dtype == torch.float64 else torch.int32
    even = (s.view(ibits) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    v = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return th + v
