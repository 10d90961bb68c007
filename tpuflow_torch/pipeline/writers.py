"""Result writers: flow file plus compensated image (port of
:mod:`tpuflow.pipeline.writers`).

Parity with the reference's ``MultipleMotion_write`` overloads
(``OpticalFlow/OpticalFlow.cpp:381-490``, gray + RGB): the flow binary in
the reference format next to a ``compensated_<name>`` PGM/PPM built by
motion compensation, and ``MultipleMotion_Affine_write`` (6-coefficient
text, ``Affine_MultipleMotion.cpp:243-270``). The compensation runs on the
flow's device when given tensors; numpy arrays go to ``device`` first (the
card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.core.io import write_affine, write_flow, write_pnm
from tpuflow_torch.pipeline.motion_compensation import compensate


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_flow_with_compensated(
    filename: str | Path,
    next_img,
    u,
    v,
    maxval: int = 255,
    method: str = "nearest",
    device="cuda",
) -> Path:
    """Write the flow binary and ``compensated_<name>`` PGM/PPM beside it.

    Tensors stay on their device; numpy arrays are put on ``device``. The
    compensation runs on the flow's device."""
    filename = Path(filename)
    ut, vt, img = (x if torch.is_tensor(x)
                   else torch.from_numpy(np.asarray(x)).to(device)
                   for x in (u, v, next_img))
    write_flow(filename, _host(ut), _host(vt))
    comp = compensate(img.to(ut.device), ut, vt.to(ut.device), method=method)
    comp_path = filename.parent / f"compensated_{filename.name}"
    arr = _host(comp)
    # Float images are assumed already in [0, maxval] intensity units.
    write_pnm(comp_path.with_suffix(".pgm" if arr.ndim == 2 else ".ppm"),
              arr, maxval=maxval)
    return comp_path


def write_affine_params(filename: str | Path, a) -> None:
    write_affine(filename, _host(a))
