"""Plain reference of the kitti_black_anandan configuration.

Coarse-to-fine Black-Anandan robust flow (Black & Anandan, CVIU 63(1),
1996; ``OpticalFlow/OpticalFlow.cpp``) as the configuration runs it: 5x5
Gaussian pyramid with mirrored borders, 2x2 gradients and temporal
difference, sigmas annealed from (0.8, 0.3)/sqrt(2) to (0.2, 0.03)/sqrt(2),
Geman-McClure IRLS Jacobi sweeps with the reference's Lipschitz step,
LevelDown warp and prolongation between levels, and the fused solver's stop
test: the energy every 64 sweeps on level 0 and every ``fuse`` sweeps above
it, stop on E < threshold or more than 3 consecutive increases.

Plain PyTorch, one sweep at a time, frozen from the port's plain paths
(``pyramid/pyramid.py``, ``solvers/black_anandan*.py``,
``kernels/irls_stencil.irls_sweeps_plain``). It imports nothing of the
program. ``dtype`` is the precision the whole solve runs in: float32 as the
configuration states, bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LAMBDA_D = 5.0
LAMBDA_S = 1.0
SIGMA_D_INIT = 0.8 / math.sqrt(2.0)
SIGMA_D_L0 = 0.2 / math.sqrt(2.0)
SIGMA_S_INIT = 0.3 / math.sqrt(2.0)
SIGMA_S_L0 = 0.03 / math.sqrt(2.0)
NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1))
_A = 0.4
_W5 = np.array([_A / 2, 0.5, _A, 0.5, _A / 2]) / (1.0 + 2 * _A)


def true_div(x, s: float):
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def in_dtype(x: float, dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def psi(x, sigma):
    d = sigma + x * x
    return 2.0 * x * sigma / (d * d)


def rho(x, sigma):
    return x * x / (sigma + x * x)


# -- pyramid -----------------------------------------------------------------


def pyramid_sizes(width: int, height: int, max_level: int):
    sizes = [(width, height)]
    for lev in range(1, max_level + 1):
        w = math.ceil(width * 0.5**lev)
        h = math.ceil(height * 0.5**lev)
        if w <= 0 or h <= 0:
            break
        sizes.append((w, h))
    return sizes


def _mirror(i, n):
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def _downsample(img, out_wh):
    out_w, out_h = out_wh
    w5 = _W5.astype(np.float32 if img.dtype != torch.float64 else np.float64)
    taps = w5[:, None] * w5[None, :]
    need_h = 2 * (out_h - 1) + 3
    need_w = 2 * (out_w - 1) + 3
    h, w = img.shape
    dev = img.device
    ys = _mirror(torch.arange(-2, h + max(need_h - h, 0), device=dev), h)
    xs = _mirror(torch.arange(-2, w + max(need_w - w, 0), device=dev), w)
    p = img.index_select(0, ys).index_select(1, xs)
    out = None
    for m in range(5):
        for n in range(5):
            term = p[m : m + 2 * out_h - 1 : 2, n : n + 2 * out_w - 1 : 2] \
                * float(taps[m, n])
            out = term if out is None else out + term
    return out


def pyramider(img, max_level: int):
    h, w = img.shape
    levels = [img]
    for wl, hl in pyramid_sizes(w, h, max_level)[1:]:
        levels.append(_downsample(levels[-1], (wl, hl)))
    return levels


def _corner_index(h, w, device):
    x = torch.arange(w, device=device).clamp(0, max(w - 2, 0))
    y = torch.arange(h, device=device).clamp(0, max(h - 2, 0))
    return x, (x + 1).clamp(max=w - 1), y, (y + 1).clamp(max=h - 1)


def _corners(im, idx):
    x, x1, y, y1 = idx
    r0 = im.index_select(0, y)
    r1 = im.index_select(0, y1)
    return (r0.index_select(1, x), r0.index_select(1, x1),
            r1.index_select(1, x), r1.index_select(1, x1))


def grad_level(img):
    i00, i10, i01, i11 = _corners(img, _corner_index(*img.shape, img.device))
    return (i10 - i00 + i11 - i01) / 2.0, (i01 - i00 + i11 - i10) / 2.0


def dt_level(a, b):
    d00, d10, d01, d11 = _corners(b - a, _corner_index(*a.shape, a.device))
    return (d00 + d10 + d01 + d11) / 4.0


def _upsample(coarse, hw):
    h, w = hw
    ch, cw = coarse.shape
    x = (torch.arange(w, device=coarse.device) // 2).clamp(0, cw - 1)
    y = (torch.arange(h, device=coarse.device) // 2).clamp(0, ch - 1)
    return coarse.index_select(0, y).index_select(1, x)


def _zero_gather(img, x, y):
    h, w = img.shape
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    ys, xs = torch.broadcast_tensors(y.clamp(0, h - 1), x.clamp(0, w - 1))
    vals = img.reshape(h * w)[ys * w + xs]
    return torch.where(valid, vals, torch.zeros((), dtype=img.dtype,
                                                device=img.device))


def level_down(it_l, itp1_l, u_c, v_c):
    h, w = it_l.shape
    ox = torch.floor(2.0 * _upsample(u_c, (h, w))).to(torch.int64)
    oy = torch.floor(2.0 * _upsample(v_c, (h, w))).to(torch.int64)
    xs = torch.arange(w, device=it_l.device)[None, :]
    ys = torch.arange(h, device=it_l.device)[:, None]
    acc = torch.zeros_like(it_l)
    for dy in (0, 1):
        for dx in (0, 1):
            acc = acc + (_zero_gather(itp1_l, xs + dx + ox, ys + dy + oy)
                         - _zero_gather(it_l, xs + dx, ys + dy))
    return acc / 4.0


# -- IRLS --------------------------------------------------------------------


def _masks(h, w, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return [(ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            for dx, dy in NEIGHBORS]


def sweep(u, v, gx, gy, it, sup_x, sup_y, masks, sigma_d, sigma_s):
    """One Jacobi sweep u <- u - dE/du / sup (OpticalFlow.cpp:273-309)."""
    h, w = u.shape
    psi_d = psi(gx * u + gy * v + it, sigma_d)
    up = F.pad(u, (1, 1, 1, 1))
    vp = F.pad(v, (1, 1, 1, 1))
    nx = torch.zeros_like(u)
    ny = torch.zeros_like(v)
    for (dx, dy), m in zip(NEIGHBORS, masks):
        un = up[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        vn = vp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        nx = nx + torch.where(m, psi(u - un, sigma_s), 0.0)
        ny = ny + torch.where(m, psi(v - vn, sigma_s), 0.0)
    return (u - (LAMBDA_D * gx * psi_d + LAMBDA_S * nx) / sup_x,
            v - (LAMBDA_D * gy * psi_d + LAMBDA_S * ny) / sup_y)


def energy(u, v, gx, gy, it, sigma_d, sigma_s) -> float:
    """Error_MultipleMotion (OpticalFlow.cpp:335-378), summed in float64;
    each in-frame neighbour pair enters twice with the same value."""
    def total(x):
        return torch.sum(x, dtype=torch.float64)

    E = LAMBDA_D * total(rho(gx * u + gy * v + it, sigma_d))
    for f in (u, v):
        E = E + 2.0 * LAMBDA_S * (
            total(rho(f[:, 1:] - f[:, :-1], sigma_s))
            + total(rho(f[1:, :] - f[:-1, :], sigma_s)))
    return E.item()


def solve_level(gx, gy, it, sigma_d, sigma_s, iters, threshold, level0,
                fuse):
    """Sweeps one at a time; the stop test after every ``check`` sweeps
    (64 on level 0, ``fuse`` above), the total rounded up to whole blocks
    of ``fuse`` as the fused solver runs them. Returns (u, v, sweeps)."""
    sup_x, sup_y = (LAMBDA_D * torch.max(g * g) / sigma_d**2
                    + 4.0 * LAMBDA_S / sigma_s**2 for g in (gx, gy))
    check = max((64 if level0 else fuse) // fuse, 1) * fuse
    total = -(-iters // fuse) * fuse
    masks = _masks(*gx.shape, gx.device)
    u = torch.zeros_like(it)
    v = torch.zeros_like(it)
    E, inc, n = 0.0, 0, 0
    while n < total:
        u, v = sweep(u, v, gx, gy, it, sup_x, sup_y, masks, sigma_d, sigma_s)
        n += 1
        if n % check:
            continue
        E_new = energy(u, v, gx, gy, it, sigma_d, sigma_s)
        if not level0:
            inc = inc + 1 if E_new > E else 0
        E = E_new
        if E < threshold or inc > 3:
            break
    return u, v, n


def flow(prev: np.ndarray, nxt: np.ndarray, cfg: dict, device,
         dtype=torch.float32):
    """(u, v) float64 host arrays and the sweeps of each level, coarsest
    first, for one gray pair under the configuration ``cfg``."""
    it_img = torch.from_numpy(np.asarray(prev, np.float32)).to(device, dtype)
    itp1_img = torch.from_numpy(np.asarray(nxt, np.float32)).to(device, dtype)
    max_int = float(cfg["max_int"])
    fuse = int(cfg["fuse"])
    threshold = in_dtype(float(cfg["error_min_threshold"]), dtype)
    it_lv = pyramider(true_div(it_img, max_int), int(cfg["level"]))
    itp1_lv = pyramider(true_div(itp1_img, max_int), int(cfg["level"]))
    max_level = len(it_lv) - 1
    h0, w0 = it_img.shape
    u = v = None
    sweeps = []
    for level in range(max_level, -1, -1):
        sigma_d = SIGMA_D_INIT + (SIGMA_D_L0 - SIGMA_D_INIT) / max_level * (
            max_level - level)
        sigma_s = SIGMA_S_INIT + (SIGMA_S_L0 - SIGMA_S_INIT) / max_level * (
            max_level - level)
        gx, gy = grad_level(it_lv[level])
        if level < max_level:
            it_l = level_down(it_lv[level], itp1_lv[level], u, v)
        else:
            it_l = dt_level(it_lv[level], itp1_lv[level])
        iters = min(int((level + 1) * 10 * max(w0, h0)), int(cfg["iter_max"]))
        u_l, v_l, n = solve_level(gx, gy, it_l, sigma_d, sigma_s, iters,
                                  threshold, level == 0, fuse)
        sweeps.append(n)
        if level < max_level:
            hh, ww = u_l.shape
            u_l = u_l + 2.0 * _upsample(u, (hh, ww))
            v_l = v_l + 2.0 * _upsample(v, (hh, ww))
        u, v = u_l, v_l
    return (u.to(torch.float64).cpu().numpy(),
            v.to(torch.float64).cpu().numpy(), sweeps)
