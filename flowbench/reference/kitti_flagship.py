"""Plain reference of the kitti_flagship configuration.

The reference's segmentation block-matching flagship
(``OpticalFlow_BlockMatching.cpp``, mode 0) for one middle frame with its
previous and next frames:

1. sRGB / MaxInt to CIE Lab (divided by 100), on the host in float32;
2. mean-shift filter of the middle frame: flat kernels, spatial radius R,
   Lab radius ``kernel_intensity``, the original points within E = 2R of a
   query's origin swept in row-major order, 8 iterations, a query whose
   window empties jumping to (0, 0); then regions: 4-adjacent pixels whose
   modes lie within R/2 and the colour radius join, regions under 16 pixels
   merge into their most similar neighbour;
3. per region and direction, the exhaustive search over the 61 x 61 integer
   displacements of cost MAD - 0.5 ZNCC (zero-padded reads, region sums in
   float64), then the 3 x 3 half-pixel grid around the winner, bilinear;
4. the region-gated, direction-coherent Geman-McClure IRLS of each direction
   from zero flow under the zero warp, energy checks after sweeps 1, 65,
   129, ..., stop on E < 1e-6 or more than 3 consecutive increases, at most
   2048 sweeps;
5. per region the direction of lower cost (the previous frame on a tie),
   and the flow: its winner plus its refinement.

Plain PyTorch, one sweep and one offset at a time, frozen from the port's
plain paths (``core/color``, ``kernels/ms_filter._filter_plain``,
``segmentation/meanshift._merge_labels_plain``, the matcher's ``gather``
evaluator and ``_grid_refine``, ``solvers/bm_flow``'s gated refine). It
imports nothing of the program. ``dtype`` is the precision of every
per-pixel field (float32 as the configuration states; bfloat16 for the
control) and ``acc`` that of every region sum (float64; float32 for the
control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LAB_SCALE = 100.0
LAMBDA_D = 5.0
LAMBDA_S = 1.0
SIGMA_D = 0.2 / math.sqrt(2.0)
SIGMA_S = 0.03 / math.sqrt(2.0)
CHECK_EVERY = 64
NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1))
POW_CHUNK = 16384
_SRGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
                (0.2126729, 0.7151522, 0.0721750),
                (0.0193339, 0.1191920, 0.9503041))
_XN, _YN, _ZN = 0.95047, 1.0, 1.08883


def true_div(x, s: float):
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def psi(x, sigma):
    d = sigma + x * x
    return 2.0 * x * sigma / (d * d)


def rho(x, sigma):
    return x * x / (sigma + x * x)


# -- 1. Lab ------------------------------------------------------------------


def _pow(x, p):
    """x ** p on the CPU in fixed chunks, so no thread count changes its
    bits."""
    if x.numel() <= POW_CHUNK:
        return x ** p
    flat = x.contiguous().view(-1)
    return torch.cat([c ** p for c in flat.split(POW_CHUNK)]).view(x.shape)


def to_lab(rgb: np.ndarray, max_int: float) -> torch.Tensor:
    """(H, W, 3) sRGB in [0, max_int] -> float32 Lab / 100 on the host."""
    norm = true_div(torch.from_numpy(np.asarray(rgb, np.float32)), max_int)
    lin = torch.where(norm <= 0.04045, norm / 12.92,
                      _pow((norm + 0.055) / 1.055, 2.4))
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _SRGB_TO_XYZ
    x = m[0][0] * r + m[0][1] * g + m[0][2] * b
    y = m[1][0] * r + m[1][1] * g + m[1][2] * b
    z = m[2][0] * r + m[2][1] * g + m[2][2] * b
    delta = 6.0 / 29.0

    def f(t):
        return torch.where(t > delta**3, _pow(t.abs(), 1.0 / 3.0),
                           t / (3.0 * delta**2) + 4.0 / 29.0)

    fx, fy, fz = f(x / _XN), f(y / _YN), f(z / _ZN)
    return torch.stack([(116.0 * fy - 16.0) / 100.0,
                        500.0 * (fx - fy) / 100.0,
                        200.0 * (fy - fz) / 100.0], dim=-1)


# -- 2. segmentation ---------------------------------------------------------


def _state_bits(pos, col):
    flat = torch.cat([pos.reshape(-1, 2), col.reshape(-1, 3)], 1)
    return flat.contiguous().view(
        torch.int32 if flat.dtype == torch.float32 else torch.int16)


def mean_shift(lab: torch.Tensor, R: int, ki: float, iters: int,
               states: bool = False):
    """The filter on (H, W, 3) Lab; returns (pos (H, W, 2) xy, col (H, W,
    3)) and, with ``states``, the state bits after 0..iters iterations.

    Each offset's weight is 0 or 1 and dx, dy and the count are sums of
    small integers, exact in any order; only the colour sums keep the
    row-major order of offsets. Offsets farther than R + 2 + the largest
    drift from every query add exact zeros and are skipped."""
    h, w = lab.shape[:2]
    dt, dev = lab.dtype, lab.device
    E = 2 * int(R)
    sentinel = lab.abs().max() + (float(ki) + 1.0)
    labh = sentinel.expand(3, h + 2 * E, w + 2 * E).clone()
    labh[:, E : E + h, E : E + w] = lab.permute(2, 0, 1)
    hs2 = float(R) ** 2
    hr2 = float(ki) ** 2
    xs = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    ex = torch.zeros((h, w), dtype=dt, device=dev)
    ey = torch.zeros_like(ex)
    c = [labh[k, E : E + h, E : E + w] for k in range(3)]
    out = [_state_bits(torch.stack([xs + ex, ys + ey], -1),
                       torch.stack(c, -1))] if states else None
    for _ in range(iters):
        reach = float(R) + 2.0 + float(torch.sqrt(
            torch.max(ex * ex + ey * ey).float()))
        s_dx = torch.zeros((h, w), dtype=dt, device=dev)
        s_dy, s_n = torch.zeros_like(s_dx), torch.zeros_like(s_dx)
        s = [torch.zeros_like(s_dx) for _ in range(3)]
        for dy in range(-E, E + 1):
            if abs(dy) > reach:
                continue
            half = min(E, int(math.floor(math.sqrt(reach * reach - dy * dy))))
            dxs = torch.arange(-half, half + 1, device=dev)
            k = dxs.numel()
            ty = dy - ey
            ty2 = (ty * ty)[..., None]
            band = labh[:, E + dy : E + dy + h].unfold(2, w, 1)
            q = band[:, :, E - half : E + half + 1].permute(0, 1, 3, 2)
            tx = dxs.to(dt) - ex[..., None]
            d_sp = tx * tx + ty2
            a = q[0] - c[0][..., None]
            b = q[1] - c[1][..., None]
            cc = q[2] - c[2][..., None]
            d_cl = a * a + b * b + cc * cc
            wgt = ((d_sp <= hs2) & (d_cl <= hr2)).to(dt)
            s_dx = s_dx + (wgt * dxs.to(dt)).sum(-1)
            s_dy = s_dy + wgt.sum(-1) * dy
            s_n = s_n + wgt.sum(-1)
            for j in range(k):
                wj = wgt[..., j]
                for ch in range(3):
                    s[ch] = s[ch] + wj * q[ch][..., j]
        n = torch.clamp_min(s_n, 1.0)
        got = s_n > 0
        ex = torch.where(got, s_dx / n, -xs)
        ey = torch.where(got, s_dy / n, -ys)
        c = [s[ch] / n for ch in range(3)]
        if states:
            out.append(_state_bits(torch.stack([xs + ex, ys + ey], -1),
                                   torch.stack(c, -1)))
    return torch.stack([xs + ex, ys + ey], -1), torch.stack(c, -1), out


def merge_labels(pos: np.ndarray, col: np.ndarray, R: float, ki: float,
                 min_size: int):
    """Regions from the modes (float64 distances): connected components of
    4-adjacent pixels within R/2 and ki, then regions under ``min_size``
    merged into their most similar touching neighbour. Returns (labels
    (H, W) int32, n)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    pos = np.asarray(pos, np.float64)
    col = np.asarray(col, np.float64)
    h, w = pos.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    feats = np.concatenate([pos, col], axis=-1)
    pairs = (((slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
             ((slice(None), slice(0, w - 1)), (slice(None), slice(1, w))))
    rows, cols = [], []
    for sa, sb in pairs:
        fa = feats[sa].reshape(-1, 5)
        fb = feats[sb].reshape(-1, 5)
        ok = ((((fa[:, :2] - fb[:, :2]) ** 2).sum(-1) <= (0.5 * R) ** 2)
              & (((fa[:, 2:] - fb[:, 2:]) ** 2).sum(-1) <= ki**2))
        rows.append(idx[sa].reshape(-1)[ok])
        cols.append(idx[sb].reshape(-1)[ok])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = coo_matrix((np.ones(len(r)), (r, c)), shape=(h * w, h * w))
    n, lab = connected_components(g, directed=False)
    lab = lab.reshape(h, w)
    if min_size <= 1:
        return lab.astype(np.int32), n
    flat = lab.reshape(-1)
    flat_col = col.reshape(-1, 3)
    counts = np.bincount(flat, minlength=n).astype(np.int64)
    col_sums = np.stack([np.bincount(flat, weights=flat_col[:, k],
                                     minlength=n) for k in range(3)], -1)
    eas, ebs = [], []
    for sa, sb in pairs:
        la, lb = lab[sa].reshape(-1), lab[sb].reshape(-1)
        m = la != lb
        eas.append(la[m])
        ebs.append(lb[m])
    ea = np.concatenate(eas + ebs)
    eb = np.concatenate(ebs + eas)
    edges = np.unique(ea.astype(np.int64) * n + eb)
    ea, eb = edges // n, edges % n
    remap_total = np.arange(n)
    for _ in range(64):
        tiny = (counts > 0) & (counts < min_size)
        if not tiny.any():
            break
        mean_col = col_sums / np.maximum(counts, 1)[:, None]
        sel = tiny[ea]
        pa, pb = ea[sel], eb[sel]
        if len(pa) == 0:
            break
        d = ((mean_col[pa] - mean_col[pb]) ** 2).sum(-1)
        order = np.lexsort((d, pa))
        pa_s, pb_s = pa[order], pb[order]
        first = np.ones(len(pa_s), bool)
        first[1:] = pa_s[1:] != pa_s[:-1]
        src, dst = pa_s[first], pb_s[first]
        keep = (~tiny[dst]) | (dst < src)
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            break
        remap = np.arange(n)
        remap[src] = dst
        for _ in range(8):
            remap = remap[remap]
        counts = np.bincount(remap, weights=counts,
                             minlength=n).astype(np.int64)
        col_sums = np.stack([np.bincount(remap, weights=col_sums[:, k],
                                         minlength=n) for k in range(3)], -1)
        remap_total = remap[remap_total]
        ea, eb = remap[ea], remap[eb]
        inner = ea != eb
        edges = np.unique(ea[inner] * n + eb[inner])
        ea, eb = edges // n, edges % n
    uniq, lab = np.unique(remap_total[lab], return_inverse=True)
    return lab.reshape(h, w).astype(np.int32), len(uniq)


# -- 3. region matching ------------------------------------------------------


def range_sums(sorted_fields, bounds, acc, chunk: int = 512):
    """Per-region sums of label-sorted (N, C) fields in ``acc``: chunk
    partial sums, their running sum, and masked prefixes of the boundary
    chunks (fixed order on every device)."""
    f = sorted_fields.to(acc)
    n, c = f.shape
    f = torch.nn.functional.pad(f, (0, 0, 0, -(-n // chunk) * chunk - n))
    chunks = f.view(-1, chunk, c)
    cs = torch.cat([torch.zeros((1, c), dtype=acc, device=f.device),
                    torch.cumsum(chunks.sum(dim=1), dim=0)], dim=0)
    cidx = torch.div(bounds, chunk, rounding_mode="floor")
    rows = chunks[torch.clamp_max(cidx, chunks.shape[0] - 1)]
    mask = (torch.arange(chunk, device=f.device)[None, :]
            < (bounds % chunk)[:, None]).to(acc)
    s_at = cs[cidx] + (rows * mask[:, :, None]).sum(dim=1)
    return s_at[1:] - s_at[:-1]


def region_costs(sums, coeff_mad: float, coeff_zncc: float):
    """(..., n_regions, 7) moment sums -> MAD - coeff * ZNCC (inf where a
    region has no pixel); ZNCC clamped to [-1, 1]."""
    n, s_mad, s_a, s_b, s_aa, s_bb, s_ab = sums.unbind(-1)
    n_safe = torch.clamp_min(n, 1.0)
    mad = s_mad / n_safe
    sa, sb = s_a / n_safe, s_b / n_safe
    var_a = torch.clamp_min(s_aa / n_safe - sa * sa, 0.0)
    var_b = torch.clamp_min(s_bb / n_safe - sb * sb, 0.0)
    zncc = torch.clamp((s_ab / n_safe - sa * sb)
                       / (torch.sqrt(var_a * var_b) + 1e-12), -1.0, 1.0)
    mad = torch.where(n > 0, mad, torch.full((), math.inf, dtype=mad.dtype,
                                             device=mad.device))
    return coeff_mad * mad - coeff_zncc * zncc


def _fields(cur, ref_s):
    """(N, 1, 3) current and (N, K, 3) reference samples -> (N, K, 7):
    membership, Lab L1 in standard units, and the L-channel moments."""
    d = (cur - ref_s).abs()
    l1 = (d[..., 0] + d[..., 1] + d[..., 2]) * (LAB_SCALE / 3.0)
    a = cur[..., 0].expand_as(l1)
    b = ref_s[..., 0]
    return torch.stack([torch.ones_like(l1), l1, a, b, a * a, b * b, a * b],
                       dim=-1)


@dataclass
class Matcher:
    """One direction's search: the current and reference Lab frames and
    the region plan of the current frame's labels."""

    cur: torch.Tensor
    ref: torch.Tensor
    labels: torch.Tensor      # (H, W) int64
    perm: torch.Tensor
    bounds: torch.Tensor
    n_regions: int
    acc: torch.dtype
    coeff_mad: float
    coeff_zncc: float

    def integer_costs(self, search_range: int, chunk: int = 32):
        h, w, c = self.cur.shape
        Rr = search_range // 2
        cand = torch.stack(torch.meshgrid(
            torch.arange(-Rr, Rr + 1, device=self.cur.device),
            torch.arange(-Rr, Rr + 1, device=self.cur.device),
            indexing="ij"), -1).reshape(-1, 2)
        ref_p = torch.nn.functional.pad(self.ref, (0, 0, Rr, Rr, Rr, Rr))
        cur = self.cur.reshape(h * w, 1, c)
        yy0 = torch.arange(h, device=cur.device)[:, None, None] + Rr
        xx0 = torch.arange(w, device=cur.device)[None, :, None] + Rr
        out = []
        for k0 in range(0, cand.shape[0], chunk):
            d = cand[k0 : k0 + chunk]
            sub = ref_p[yy0 + d[None, None, :, 0], xx0 + d[None, None, :, 1]]
            f = _fields(cur, sub.reshape(h * w, d.shape[0], c))
            sums = range_sums(f.reshape(h * w, -1)[self.perm], self.bounds,
                              self.acc)
            out.append(region_costs(
                sums.view(self.n_regions, d.shape[0], 7).transpose(0, 1),
                self.coeff_mad, self.coeff_zncc))
        return cand, torch.cat(out, 0)

    def cost_at(self, disp):
        """Each region's cost at its displacement ``disp`` ((n_regions, 2)
        (dy, dx), integers and halves): bilinear between the four integer
        neighbours, zero outside the frame."""
        h, w, c = self.cur.shape
        dt, dev = self.cur.dtype, self.cur.device
        d_pix = disp[self.labels].reshape(-1, 2)[self.perm]
        base = torch.floor(d_pix)
        fy = (d_pix[:, 0] - base[:, 0]).to(dt)[:, None]
        fx = (d_pix[:, 1] - base[:, 1]).to(dt)[:, None]
        pix = self.perm
        y = torch.div(pix, w, rounding_mode="floor") + base[:, 0].long()
        x = pix % w + base[:, 1].long()
        ref_flat = self.ref.reshape(h * w, c)

        def g(yy, xx):
            ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(dt)
            return ref_flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)] \
                * ok[:, None]

        interp = ((1 - fx) * (1 - fy) * g(y, x) + fx * (1 - fy) * g(y, x + 1)
                  + (1 - fx) * fy * g(y + 1, x) + fx * fy * g(y + 1, x + 1))
        cur = self.cur.reshape(h * w, c)[pix]
        f = _fields(cur[:, None], interp[:, None])[:, 0]
        return region_costs(range_sums(f, self.bounds, self.acc),
                            self.coeff_mad, self.coeff_zncc)

    def search(self, search_range: int, subpixel_scale: int):
        """(winner (n_regions, 2) (dy, dx), its cost): the first minimum of
        the integer grid, then of the half-pixel grid around it."""
        cand, costs = self.integer_costs(search_range)
        best = cand[torch.argmin(costs, dim=0)].to(torch.float64)
        steps = np.arange(-(subpixel_scale - 1), subpixel_scale)
        sub = np.stack(np.meshgrid(steps, steps, indexing="ij"),
                       -1).reshape(-1, 2) * (1.0 / subpixel_scale)
        sub_costs = torch.stack([self.cost_at(best + torch.as_tensor(
            s, dtype=torch.float64, device=best.device)) for s in sub])
        k = torch.argmin(sub_costs, dim=0)
        disp = best + torch.as_tensor(sub, dtype=torch.float64,
                                      device=best.device)[k]
        return disp, sub_costs.gather(0, k[None])[0]


def plan(labels: np.ndarray, n_regions: int, device):
    flat = labels.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        flat, minlength=n_regions))]).astype(np.int64)
    return (torch.from_numpy(labels.astype(np.int64)).to(device),
            torch.from_numpy(perm).to(device),
            torch.from_numpy(bounds).to(device))


# -- 4. gated refine ---------------------------------------------------------


def _mirror_shift(img, dx: int, dy: int):
    h, w = img.shape
    xs = torch.arange(w, device=img.device) + dx
    ys = torch.arange(h, device=img.device) + dy
    xs = torch.where(xs >= w, 2 * w - 2 - xs, xs.abs())
    ys = torch.where(ys >= h, 2 * h - 2 - ys, ys.abs())
    return img.index_select(0, ys).index_select(1, xs)


def _shift(f, dx: int, dy: int):
    return torch.roll(f, shifts=(-dy, -dx), dims=(-2, -1))


def _gates(labels, dt):
    h, w = labels.shape
    out = []
    for dx, dy in NEIGHBORS:
        inb = torch.ones((h, w), dtype=torch.bool, device=labels.device)
        if dx == 1:
            inb[:, w - 1] = False
        elif dx == -1:
            inb[:, 0] = False
        if dy == 1:
            inb[h - 1, :] = False
        elif dy == -1:
            inb[0, :] = False
        out.append((inb & (_shift(labels, dx, dy) == labels)).to(dt))
    return out


def _neighbors(u, v, gates, energy: bool):
    """The gated, direction-coherence-weighted neighbour sums (dE/du, dE/dv)
    or, with ``energy``, the neighbour energy."""
    norm_c = torch.sqrt(u * u + v * v)
    nx = torch.zeros_like(u)
    ny = torch.zeros_like(v)
    for (dx, dy), gate in zip(NEIGHBORS, gates):
        un, vn = _shift(u, dx, dy), _shift(v, dx, dy)
        prod = norm_c * _shift(norm_c, dx, dy)
        cosang = torch.where(prod > 0, (u * un + v * vn)
                             / torch.clamp_min(prod, 1e-30), 1.0)
        m = gate * (0.5 * (1.0 + cosang))
        if energy:
            nx = nx + m * (rho(u - un, SIGMA_S) + rho(v - vn, SIGMA_S))
        else:
            nx = nx + m * psi(u - un, SIGMA_S)
            ny = ny + m * psi(v - vn, SIGMA_S)
    return nx, ny


def refine(ref_lab, int_lab, labels, iter_max: int, threshold: float):
    """One direction's gated IRLS from zero flow under the zero warp;
    returns (u, v) on the frames' device."""
    il = int_lab[..., 0] * LAB_SCALE
    rl = ref_lab[..., 0] * LAB_SCALE
    i00, i10 = il, _mirror_shift(il, 1, 0)
    i01, i11 = _mirror_shift(il, 0, 1), _mirror_shift(il, 1, 1)
    gx = true_div((i10 - i00) + (i11 - i01), 2.0)
    gy = true_div((i01 - i00) + (i11 - i10), 2.0)
    it = true_div(rl - il + _mirror_shift(rl, 1, 0) - i10
                  + _mirror_shift(rl, 0, 1) - i01
                  + _mirror_shift(rl, 1, 1) - i11, 4.0)
    sup_x, sup_y = (true_div(LAMBDA_D * torch.max(g * g), SIGMA_D**2)
                    + 4.0 * LAMBDA_S / SIGMA_S**2 for g in (gx, gy))
    gates = _gates(labels, gx.dtype)
    threshold = torch.tensor(threshold, dtype=gx.dtype).item()
    u = torch.zeros_like(gx)
    v = torch.zeros_like(gx)
    E, inc = 0.0, 0
    for n in range(iter_max):
        psi_d = psi(gx * u + gy * v + it, SIGMA_D)
        nx, ny = _neighbors(u, v, gates, False)
        u, v = (u - (LAMBDA_D * gx * psi_d + LAMBDA_S * nx) / sup_x,
                v - (LAMBDA_D * gy * psi_d + LAMBDA_S * ny) / sup_y)
        if n % CHECK_EVERY:
            continue
        E_new = torch.sum(LAMBDA_D * rho(gx * u + gy * v + it, SIGMA_D)
                          + LAMBDA_S * _neighbors(u, v, gates, True)[0],
                          dtype=torch.float64).item()
        inc = inc + 1 if E_new > E else 0
        E = E_new
        if E < threshold or inc > 3:
            break
    return u, v


# -- the middle frame --------------------------------------------------------


@dataclass
class FrameReference:
    """What the reference works out for one middle frame, kept to judge
    the program's output for it (or the control's)."""

    labels: np.ndarray
    n_regions: int
    pos: np.ndarray
    col: np.ndarray
    matchers: tuple           # (previous, next)
    best_cost: torch.Tensor   # per region, the better direction's cost
    t: np.ndarray
    bm_u: np.ndarray
    bm_v: np.ndarray
    refined: tuple            # ((u, v) previous, (u, v) next), host float32
    u: np.ndarray
    v: np.ndarray
    states: list | None


def frame_reference(prev_rgb, mid_rgb, next_rgb, cfg: dict, device,
                    dtype=torch.float32, acc=torch.float64,
                    states: bool = False) -> FrameReference:
    max_int = float(cfg["max_int"])
    R, ki = int(cfg["kernel_spatial"]), float(cfg["kernel_intensity"])
    labs = [to_lab(f, max_int).to(device, dtype)
            for f in (prev_rgb, mid_rgb, next_rgb)]
    pos, col, st = mean_shift(labs[1], R, ki, int(cfg["ms_iters"]), states)
    pos = pos.float().cpu().numpy()
    col = col.float().cpu().numpy()
    labels, n = merge_labels(pos, col, float(R), ki,
                             int(cfg["label_min_size"]))
    lab_t, perm, bounds = plan(labels, n, device)
    matchers = tuple(Matcher(labs[1], ref, lab_t, perm, bounds, n, acc,
                             float(cfg["coeff_mad"]),
                             float(cfg["coeff_zncc"]))
                     for ref in (labs[0], labs[2]))
    found = [m.search(int(cfg["search_range"]), int(cfg["subpixel_scale"]))
             for m in matchers]
    (d_p, c_p), (d_n, c_n) = found
    prev_wins = c_p <= c_n
    disp = torch.where(prev_wins[:, None], d_p, d_n).float()
    refined = [refine(ref, labs[1], lab_t, int(cfg["iter_max"]),
                      float(cfg["error_min_threshold"]))
               for ref in (labs[0], labs[2])]
    t_pix = prev_wins[lab_t]
    bm_u = disp[:, 1][lab_t].to(dtype)
    bm_v = disp[:, 0][lab_t].to(dtype)
    u = bm_u + torch.where(t_pix, refined[0][0], refined[1][0])
    v = bm_v + torch.where(t_pix, refined[0][1], refined[1][1])

    def host(x):
        return x.float().cpu().numpy()

    return FrameReference(
        labels=labels, n_regions=n, pos=pos, col=col, matchers=matchers,
        best_cost=torch.minimum(c_p, c_n),
        t=np.where(host(t_pix) > 0, -1, 1).astype(np.int8),
        bm_u=host(bm_u), bm_v=host(bm_v),
        refined=tuple((host(a), host(b)) for a, b in refined),
        u=host(u), v=host(v), states=st)


def partition_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    """Share of pixels outside the best-matching region of the other
    partition, the larger of the two ways round (0 for equal partitions
    whatever the numbering)."""
    def one(x, y):
        key = x.astype(np.int64).reshape(-1) * (int(y.max()) + 1) \
            + y.reshape(-1)
        uniq, counts = np.unique(key, return_counts=True)
        best = np.zeros(int(x.max()) + 1, np.int64)
        np.maximum.at(best, uniq // (int(y.max()) + 1), counts)
        return 1.0 - best.sum() / x.size

    return max(one(a, b), one(b, a))


def judge(out, ref: FrameReference, pos_tol: float = 1e-3,
          col_tol: float = 1e-5) -> dict:
    """The numbers compared for one middle frame. ``out`` carries the
    program's (or the control's) labels, pos, col, bm_u, bm_v, t, u, v as
    host arrays.

    - ``filter_diff_share``: share of pixels whose filtered position or
      colour lies farther than pos_tol / col_tol from the reference's;
    - ``label_mismatch_share``: :func:`partition_mismatch` of the labels;
    - ``match_cost_gap``: over the reference's regions, the most by which
      the cost of the direction and displacement the output chose (read at
      each region's first pixel) lies above the reference's best cost;
    - ``flow_max_abs_px``: the largest gap between the output's (u, v) and
      its own winner plus the reference's refinement of its direction."""
    d_pos = np.abs(np.asarray(out.pos, np.float64) - ref.pos).max(-1)
    d_col = np.abs(np.asarray(out.col, np.float64) - ref.col).max(-1)
    filt = float(np.mean((d_pos > pos_tol) | (d_col > col_tol)))
    first = ref.matchers[0].perm[ref.matchers[0].bounds[:-1]].cpu().numpy()
    h, w = ref.labels.shape
    yy, xx = first // w, first % w
    dev = ref.best_cost.device
    disp = torch.from_numpy(np.stack([out.bm_v[yy, xx], out.bm_u[yy, xx]],
                                     -1).astype(np.float64)).to(dev)
    prev = torch.from_numpy(out.t[yy, xx] < 0).to(dev)
    claim = torch.where(prev, ref.matchers[0].cost_at(disp),
                        ref.matchers[1].cost_at(disp))
    gap = float(torch.max(claim - ref.best_cost))
    t_prev = np.asarray(out.t) < 0
    ru = np.where(t_prev, ref.refined[0][0], ref.refined[1][0])
    rv = np.where(t_prev, ref.refined[0][1], ref.refined[1][1])
    def off(f, bm, r):
        f, bm = np.asarray(f, np.float32), np.asarray(bm, np.float32)
        return float(np.abs(f - (bm + r)).max())

    flow = max(off(out.u, out.bm_u, ru), off(out.v, out.bm_v, rv))
    return {"filter_diff_share": filt,
            "label_mismatch_share": float(partition_mismatch(out.labels,
                                                             ref.labels)),
            "match_cost_gap": gap, "flow_max_abs_px": flow}
