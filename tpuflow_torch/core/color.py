"""Color conversions: RGB<->gray, sRGB->CIE Lab (port of :mod:`tpuflow.core.color`).

- gray: ITU-R BT.601 luma (0.299 R + 0.587 G + 0.114 B), OpenCV's
  cvtColor(BGR2GRAY) weights, as in the demo projects
  (``HornSchunckOF/main.cpp:11-26``).
- Lab: sRGB (D65) gamma linearization -> XYZ -> CIE L*a*b*. Inputs are
  normalized sRGB in [0, 1]; L, a and b come out divided by 100 (L in
  [0, 1]). Consumers that need the standard CIE scale the reference's
  constants assume multiply by :data:`LAB_SCALE`.

Everything is elementwise on the tensor's device and dtype. The ``pow``
branches go through :func:`~tpuflow_torch.utils.numerics.pow_fixed_split`,
so a CPU result is the same bits at every torch thread count.
"""

from __future__ import annotations

import torch

from tpuflow_torch.utils.numerics import pow_fixed_split

#: Factor between this module's normalized Lab ([0, 1] L) and the
#: standard CIE scale the reference's constants assume.
LAB_SCALE = 100.0

# BT.601 luma weights (OpenCV RGB2GRAY).
_LUMA_R, _LUMA_G, _LUMA_B = 0.299, 0.587, 0.114

# sRGB -> XYZ (D65) matrix rows.
_SRGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
# D65 reference white.
_XN, _YN, _ZN = 0.95047, 1.0, 1.08883


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) BT.601 luma."""
    return (_LUMA_R * rgb[..., 0] + _LUMA_G * rgb[..., 1]
            + _LUMA_B * rgb[..., 2])


def gray_to_rgb(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 3) by channel replication (pnm Gray2RGB)."""
    return torch.stack([gray, gray, gray], dim=-1)


def _srgb_linearize(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       pow_fixed_split((c + 0.055) / 1.055, 2.4))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    delta = 6.0 / 29.0
    # Cube root of the positive branch; the other branch covers t <= delta^3.
    cbrt = pow_fixed_split(t.abs(), 1.0 / 3.0)
    return torch.where(t > delta**3, cbrt, t / (3.0 * delta**2) + 4.0 / 29.0)


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Normalized sRGB (..., H, W, 3) in [0, 1] -> Lab (..., H, W, 3),
    each channel divided by 100."""
    lin = _srgb_linearize(rgb)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _SRGB_TO_XYZ
    x = m[0][0] * r + m[0][1] * g + m[0][2] * b
    y = m[1][0] * r + m[1][1] * g + m[1][2] * b
    z = m[2][0] * r + m[2][1] * g + m[2][2] * b
    fx = _lab_f(x / _XN)
    fy = _lab_f(y / _YN)
    fz = _lab_f(z / _ZN)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L / 100.0, a / 100.0, bb / 100.0], dim=-1)
