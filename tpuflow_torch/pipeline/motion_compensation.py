"""Motion compensation: predict a frame by warping along flow (port of
:mod:`tpuflow.pipeline.motion_compensation`).

Reconstruction of ``MotionCompensation<T>`` (``OpticalFlow/OpticalFlow.cpp:
389-424``, ``OpticalFlow_BlockMatching.cpp:595-830``): the compensated
image reads the next frame at (x + u, y + v); its agreement with the
previous frame is the check of flow accuracy the reference relies on.
Nearest (the C++-style round) and bilinear sampling; out-of-range reads
are zero.
"""

from __future__ import annotations

import torch

from tpuflow_torch.core import borders as bd


def compensate(next_img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               method: str = "nearest") -> torch.Tensor:
    """Warp next_img by (u, v): out(x, y) = next(x + u, y + v).

    Takes (H, W) gray or (H, W, C) colour (channels warped identically),
    on the tensors' device.
    """
    h, w = u.shape
    xs = torch.arange(w, device=u.device)[None, :] + u
    ys = torch.arange(h, device=u.device)[:, None] + v
    img = next_img
    if img.dim() == 3:
        img = img.movedim(-1, 0)  # (C, H, W)
    if method == "nearest":
        # jnp.round and torch.round both round half to even.
        out = bd.gather2d(img, torch.round(xs).long(), torch.round(ys).long(),
                          bd.ZERO)
    elif method == "bilinear":
        x0 = torch.floor(xs).long()
        y0 = torch.floor(ys).long()
        fx = (xs - x0).to(img.dtype)
        fy = (ys - y0).to(img.dtype)
        p00 = bd.gather2d(img, x0, y0, bd.ZERO)
        p10 = bd.gather2d(img, x0 + 1, y0, bd.ZERO)
        p01 = bd.gather2d(img, x0, y0 + 1, bd.ZERO)
        p11 = bd.gather2d(img, x0 + 1, y0 + 1, bd.ZERO)
        out = ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p10
               + (1 - fx) * fy * p01 + fx * fy * p11)
    else:
        raise ValueError(f"unknown method {method}")
    if next_img.dim() == 3:
        out = out.movedim(0, -1)
    return out
