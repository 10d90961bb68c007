"""Segmentation-based block-matching flow: the reference's flagship path.

Port of :mod:`tpuflow.solvers.bm_flow` (``OpticalFlow_BlockMatching.cpp:
13-362``), mode OPTICALFLOW on one device:

1. normalize sRGB by MaxInt, convert to CIE Lab (lines 58-81);
2. keep a <=4-frame history of Lab frames + segmentations in an explicit
   :class:`BMFlowState` (the reference's static deques, lines 16-22, 84-93);
3. mean-shift segmentation of the newest frame
   (:mod:`tpuflow_torch.segmentation`; lines 137-196);
4. region block matching, bidirectional once 3 frames are buffered
   (:mod:`tpuflow_torch.blockmatching`; lines 198-219);
5. the region-gated robust gradient refinement (lines 367-590), its sweeps
   through :func:`tpuflow_torch.kernels.irls_stencil.irls_gated_sweeps`;
   or, in mode AFFINE, the per-region 6-parameter fit
   :func:`affine_parametric_flow` (Affine_BlockMatching.cpp:11-116);
6. compose BM vector + refinement into (u, v, t), t in {-1, +1}
   (Vector_ST, lines 306-361).

**Host syncs:** the gradient refinement reads its energy
(:func:`tpuflow_torch.kernels.irls_stencil.irls_gated_energy`, one kernel
launch on the card) back with ``.item()`` at each check, at tpuflow's
cadence (after sweeps 1, 65, 129, ...: 32 per 2048-sweep refine); the
affine fit reads its all-done flag once every :data:`AFFINE_CHECK_EVERY`
iterations; the segmentation's labeling runs on the host.

``mesh`` (a :class:`tpuflow_torch.dist.Mesh`; every rank calls the driver
with the same frames) runs the device stages over the mesh's ranks, as
tpuflow's does: the new frame's mean-shift filter tiled with its halo, the
searches candidate-parallel (:mod:`tpuflow_torch.dist.bm`), the gated
refine tiled with fused halos and the affine fit with all-reduced region
sums (:mod:`tpuflow_torch.dist.bm_refine`). Every rank labels the same
gathered filter output on its host and returns the same result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from tpuflow_torch.blockmatching import matcher
from tpuflow_torch.core.color import LAB_SCALE, srgb_to_lab
from tpuflow_torch.core.config import (
    MODE_OUTPUT_AFFINE_BLOCKMATCHING,
    MultipleMotionParam,
)
from tpuflow_torch.kernels import irls_stencil
from tpuflow_torch.segmentation import meanshift
from tpuflow_torch.segmentation.meanshift import SegmentationResult
from tpuflow_torch.solvers.black_anandan import emit_energy_trace, in_dtype
from tpuflow_torch.solvers.mestimators import (geman_mcclure_psi,
                                               geman_mcclure_rho)
from tpuflow_torch.utils import numerics
from tpuflow_torch.utils.numerics import true_div
from tpuflow_torch.utils.telemetry import note, record_span

LAMBDA_D = 5.0
LAMBDA_S = 1.0

#: Named profiles of :func:`optical_flow_block_matching` (tpuflow's).
#: ``"faithful"`` (== None) keeps the reference's exhaustive search and
#: over-damped refinement;
#: ``"quality"`` segments on the stride-2 frame (``seg_scale=2``: more,
#: finer regions); ``"fast"`` searches the stride-2 candidate subgrid
#: (``matmul_coarse``) and refines with the analytic sup, a plateau stop
#: and at most 1024 sweeps; ``"turbo"`` adds the stride-2 segmentation.
#: On a mesh a profile's ``seg_scale`` is ignored, as in tpuflow.
PROFILES = {
    "faithful": {},
    "fast": {
        "bm_method": "matmul_coarse",
        "refine_sup_mode": "analytic",
        "refine_plateau_rtol": 1.0e-3,
        "refine_iter_max": 1024,
    },
    "quality": {
        "seg_scale": 2,
    },
    "turbo": {
        "bm_method": "matmul_coarse",
        "refine_sup_mode": "analytic",
        "refine_plateau_rtol": 1.0e-3,
        "refine_iter_max": 1024,
        "seg_scale": 2,
    },
}
SIGMA_D_BM = 0.2 / math.sqrt(2.0)   # OpticalFlow_BlockMatching.cpp:47
SIGMA_S_BM = 0.03 / math.sqrt(2.0)  # OpticalFlow_BlockMatching.cpp:48
SIGMA_AFFINE_BM = 0.2 / math.sqrt(2.0)  # Affine_BlockMatching.cpp:17
HISTORY_MAX = 4
#: Sweeps between energy checks (the reference's E(n) cadence).
CHECK_EVERY = 64
#: Sweeps per launch of the gated kernel.
DEFAULT_FUSE = 16
#: Iterations of the per-region affine fit between two reads of its
#: all-regions-done flag (the fit's only host syncs).
AFFINE_CHECK_EVERY = 16


# ---------------------------------------------------------------------------
# Gradients and dt under the BM warp (mirror borders)


def _mirror_shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img.get_mirror(x + dx, y + dy) for small static offsets."""
    h, w = img.shape
    xs = torch.arange(w, device=img.device) + dx
    ys = torch.arange(h, device=img.device) + dy
    xs = torch.where(xs >= w, 2 * w - 2 - xs, xs.abs())
    ys = torch.where(ys >= h, 2 * h - 2 - ys, ys.abs())
    return img.index_select(0, ys).index_select(1, xs)


def gradient_method_grad(interest_l: torch.Tensor):
    """2x2 forward-difference gradient of the interest frame's L channel
    (OpticalFlow_BlockMatching.cpp:372-384)."""
    i00 = interest_l
    i10 = _mirror_shift(interest_l, 1, 0)
    i01 = _mirror_shift(interest_l, 0, 1)
    i11 = _mirror_shift(interest_l, 1, 1)
    gx = true_div((i10 - i00) + (i11 - i01), 2.0)
    gy = true_div((i01 - i00) + (i11 - i10), 2.0)
    return gx, gy


def gradient_method_dt(reference_l: torch.Tensor, interest_l: torch.Tensor,
                       mv_u: torch.Tensor, mv_v: torch.Tensor):
    """4-tap temporal difference under the floor(MV) warp
    (OpticalFlow_BlockMatching.cpp:385-397)."""
    h, w = reference_l.shape
    xs = torch.arange(w, device=reference_l.device)[None, :]
    ys = torch.arange(h, device=reference_l.device)[:, None]
    xt = xs + torch.floor(mv_u).long()
    yt = ys + torch.floor(mv_v).long()

    def mirror(i, n):
        i = i.abs()
        period = 2 * n - 2 if n > 1 else 1
        i = i % period
        return torch.where(i >= n, period - i, i)

    def ref_at(ddx, ddy):
        return reference_l[mirror(yt + ddy, h), mirror(xt + ddx, w)]

    def int_at(ddx, ddy):
        return _mirror_shift(interest_l, ddx, ddy)

    return true_div(ref_at(0, 0) - int_at(0, 0)
                    + ref_at(1, 0) - int_at(1, 0)
                    + ref_at(0, 1) - int_at(0, 1)
                    + ref_at(1, 1) - int_at(1, 1), 4.0)


def gradient_method_dt_zero(reference_l: torch.Tensor,
                            interest_l: torch.Tensor):
    """:func:`gradient_method_dt` with MV == 0 (the flagship zeroes MV
    before refinement, OpticalFlow_BlockMatching.cpp:291-293): static
    mirror shifts, the same operation order."""
    def at(img, ddx, ddy):
        return _mirror_shift(img, ddx, ddy)

    return true_div(at(reference_l, 0, 0) - at(interest_l, 0, 0)
                    + at(reference_l, 1, 0) - at(interest_l, 1, 0)
                    + at(reference_l, 0, 1) - at(interest_l, 0, 1)
                    + at(reference_l, 1, 1) - at(interest_l, 1, 1), 4.0)


# ---------------------------------------------------------------------------
# Region-gated IRLS (OpticalFlow_GradientMethod)


def _shift_field(f: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    return torch.roll(f, shifts=(-dy, -dx), dims=(-2, -1))


_NEIGHBOR_OFFSETS = irls_stencil.NEIGHBORS  # (-1, 0), (1, 0), (0, -1), (0, 1)


def _region_gates(labels: torch.Tensor, dt) -> list[torch.Tensor]:
    """Sweep-invariant neighbour gates: in frame AND same region, one
    (H, W) float mask per neighbour offset."""
    h, w = labels.shape[-2:]
    gates = []
    for dx, dy in _NEIGHBOR_OFFSETS:
        ln = _shift_field(labels, dx, dy)
        inb = torch.ones((h, w), dtype=torch.bool, device=labels.device)
        if dx == 1:
            inb[:, w - 1] = False
        elif dx == -1:
            inb[:, 0] = False
        if dy == 1:
            inb[h - 1, :] = False
        elif dy == -1:
            inb[0, :] = False
        gates.append((inb & (ln == labels)).to(dt))
    return gates


def _coherence(u, v, norm_c, dx: int, dy: int):
    """(u_n, v_n, 0.5 * (1 + cos(u, u_n))) for the neighbour at (dx, dy);
    the cosine is 1 where |u||u_n| is 0 (the zero-field limit of the
    reference's 0/0). The neighbour's norm is the shifted centre norm."""
    un = _shift_field(u, dx, dy)
    vn = _shift_field(v, dx, dy)
    prod = norm_c * _shift_field(norm_c, dx, dy)
    cosang = torch.where(prod > 0,
                         (u * un + v * vn) / torch.clamp_min(prod, 1e-30), 1.0)
    return un, vn, 0.5 * (1.0 + cosang)


def _neighbor_terms(u, v, labels, sigma_s, gates=None):
    """Region-gated, direction-coherence-weighted neighbour sums
    (Error_u_Block, OpticalFlow_BlockMatching.cpp:465-514). ``u``/``v``
    may carry a leading batch axis; ``labels``/``gates`` are (H, W)."""
    if gates is None:
        gates = _region_gates(labels, u.dtype)
    norm_c = numerics.sqrt(u * u + v * v)
    nx = torch.zeros_like(u)
    ny = torch.zeros_like(v)
    for (dx, dy), gate in zip(_NEIGHBOR_OFFSETS, gates):
        un, vn, coeff = _coherence(u, v, norm_c, dx, dy)
        m = gate * coeff
        nx = nx + m * geman_mcclure_psi(u - un, sigma_s)
        ny = ny + m * geman_mcclure_psi(v - vn, sigma_s)
    return nx, ny


def _neighbor_energy(u, v, labels, sigma_s, gates=None):
    if gates is None:
        gates = _region_gates(labels, u.dtype)
    norm_c = numerics.sqrt(u * u + v * v)
    E = torch.zeros_like(u)
    for (dx, dy), gate in zip(_NEIGHBOR_OFFSETS, gates):
        un, vn, coeff = _coherence(u, v, norm_c, dx, dy)
        m = gate * coeff
        E = E + m * (geman_mcclure_rho(u - un, sigma_s)
                     + geman_mcclure_rho(v - vn, sigma_s))
    return E


def _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
               sup_mode: str = "reference"):
    """Lipschitz bound of the region-gated IRLS (sup_Error_uu_Block,
    OpticalFlow_BlockMatching.cpp:517-537), as 0-d tensors on the fields'
    device. ``"reference"`` divides by sigma^2 as the reference does (an
    over-damped step: the Geman-McClure psi in use has max curvature
    2/sigma); ``"analytic"`` takes the true bound."""
    return sup_of_max(torch.max(gx * gx), torch.max(gy * gy), lambda_d,
                      lambda_s, sigma_d, sigma_s, sup_mode)


def sup_of_max(gx2, gy2, lambda_d, lambda_s, sigma_d, sigma_s,
               sup_mode: str = "reference"):
    """:func:`_gated_sup` from the largest gx^2 and gy^2 (0-d tensors; a
    mesh reduces them over its tiles first)."""
    if sup_mode == "analytic":
        return tuple((lambda_d * g2 * (2.0 / sigma_d)
                      + 4.0 * lambda_s * (2.0 / sigma_s)).to(gx2.dtype)
                     for g2 in (gx2, gy2))
    if sup_mode != "reference":
        raise ValueError(f"unknown sup_mode {sup_mode!r}")
    return tuple(true_div(lambda_d * g2, sigma_d**2)
                 + 4.0 * lambda_s / sigma_s**2 for g2 in (gx2, gy2))


def _sweep_block(u, v, gx, gy, it, labels, sup_x, sup_y, n: int,
                 lambda_d, lambda_s, sigma_d, sigma_s):
    """``n`` sweeps as launches of at most :data:`DEFAULT_FUSE`; returns
    (u, v, launches)."""
    launches = 0
    while n > 0:
        k = min(DEFAULT_FUSE, n)
        u, v = irls_stencil.irls_gated_sweeps(
            u, v, gx, gy, it, labels, sup_x, sup_y, k, lambda_d, lambda_s,
            sigma_d, sigma_s)
        n -= k
        launches += 1
    return u, v, launches


def _check_schedule(iter_max: int):
    """tpuflow's loop checks after the sweep with 0-based index n whenever
    n % 64 == 0. Yields (sweeps to run, index of the check after them or
    None): 1 sweep, then blocks of 64, then the remainder."""
    n = 0
    while n < iter_max:
        k = -(-n // CHECK_EVERY) * CHECK_EVERY
        end = min(k + 1, iter_max)
        yield end - n, (k if end == k + 1 else None)
        n = end


def _n_checks(iter_max: int) -> int:
    return max(-(-iter_max // CHECK_EVERY), 1)


def irls_gradient_method(
    gx, gy, it, labels,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float,
    u0=None, v0=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """IRLS_OpticalFlow_GradientMethod (OpticalFlow_BlockMatching.cpp:
    412-462): Jacobi sweeps with the region-gated neighbour term, energy
    check after sweeps 1, 65, 129, ... (tpuflow's cadence), stop when
    E < threshold or after more than 3 consecutive increases.

    The sweeps between two checks run in launches of at most
    :data:`DEFAULT_FUSE`
    through :func:`tpuflow_torch.kernels.irls_stencil.irls_gated_sweeps`;
    the descent is tpuflow's default (not its ``_fast`` variant's). Each
    check computes the energy through
    :func:`tpuflow_torch.kernels.irls_stencil.irls_gated_energy` and reads
    it back with ``.item()``. ``plateau_rtol > 0`` also stops once a check
    window improves the energy by less than that fraction. ``blocks``,
    when a list, receives the launch count.

    Returns (u, v, E, n, trace): ``trace[k]`` is E after the sweep with
    index 64 k (a tensor of the fields' dtype); NaN past the stop.
    """
    sup_x, sup_y = _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
                              sup_mode)
    threshold = in_dtype(error_min_threshold, gx.dtype)
    trace = [math.nan] * _n_checks(iter_max)
    u = torch.zeros_like(gx) if u0 is None else u0
    v = torch.zeros_like(gx) if v0 is None else v0
    E, n, launches, checks = 0.0, 0, 0, 0
    inc = 0
    for k, check in _check_schedule(iter_max):
        u, v, nl = _sweep_block(u, v, gx, gy, it, labels, sup_x, sup_y, k,
                                lambda_d, lambda_s, sigma_d, sigma_s)
        n += k
        launches += nl
        if check is None:
            break
        energy = irls_stencil.irls_gated_energy(
            u, v, gx, gy, it, labels, lambda_d, lambda_s, sigma_d, sigma_s)
        with record_span("wait.refine_check"):
            E_new = energy.item()  # host sync
        checks += 1
        inc = inc + 1 if E_new > E else 0
        E_prev, E = E, E_new
        trace[check // CHECK_EVERY] = E
        if (E < threshold or inc > 3 or (
                plateau_rtol > 0.0 and E_prev > 0
                and E >= (1.0 - plateau_rtol) * E_prev)):
            break
    note(launches=launches, checks=checks)
    if blocks is not None:
        blocks.append(launches)
    return u, v, E, n, torch.tensor(trace, dtype=gx.dtype)


def irls_gradient_method_batched(
    gx, gy, its, labels,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float,
    u0=None, v0=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """:func:`irls_gradient_method` over a batch of temporal-difference
    fields ``its`` (B, H, W) sharing gx/gy/labels: the bidirectional
    refine's two directions in one launch per block of sweeps. Each
    element keeps the serial semantics: its own energy, strike counter and
    stop; a stopped element is frozen (left out of later launches) while
    the others run on. Returns (u, v, E, n, trace) with a leading batch
    axis (trace: (B, n_checks), NaN past each element's stop)."""
    sup_x, sup_y = _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
                              sup_mode)
    threshold = in_dtype(error_min_threshold, gx.dtype)
    batch = its.shape[0]
    trace = [[math.nan] * _n_checks(iter_max) for _ in range(batch)]
    u = torch.zeros_like(its) if u0 is None else u0
    v = torch.zeros_like(its) if v0 is None else v0
    E = [0.0] * batch
    inc = [0] * batch
    stop = [False] * batch
    n, launches, checks = 0, 0, 0
    for k, check in _check_schedule(iter_max):
        if all(stop):
            break
        active = [b for b in range(batch) if not stop[b]]
        if len(active) == batch:
            u, v, nl = _sweep_block(u, v, gx, gy, its, labels, sup_x, sup_y,
                                    k, lambda_d, lambda_s, sigma_d, sigma_s)
        else:
            with record_span("wait.refine_active"):
                idx = torch.tensor(active, device=its.device)
            ua, va, nl = _sweep_block(u[idx], v[idx], gx, gy, its[idx],
                                      labels, sup_x, sup_y, k, lambda_d,
                                      lambda_s, sigma_d, sigma_s)
            u = u.index_copy(0, idx, ua)
            v = v.index_copy(0, idx, va)
        n += k
        launches += nl
        if check is None:
            break
        energy = irls_stencil.irls_gated_energy(
            u, v, gx, gy, its, labels, lambda_d, lambda_s, sigma_d, sigma_s)
        with record_span("wait.refine_check"):
            E_all = energy.tolist()  # host sync
        checks += 1
        for b in active:
            E_prev, E[b] = E[b], E_all[b]
            inc[b] = inc[b] + 1 if E[b] > E_prev else 0
            trace[b][check // CHECK_EVERY] = E[b]
            stop[b] = (E[b] < threshold or inc[b] > 3 or (
                plateau_rtol > 0.0 and E_prev > 0
                and E[b] >= (1.0 - plateau_rtol) * E_prev))
    note(launches=launches, checks=checks)
    if blocks is not None:
        blocks.append(launches)
    return (u, v, torch.tensor(E, dtype=gx.dtype), n,
            torch.tensor(trace, dtype=gx.dtype))


def irls_gradient_method_fast(
    gx, gy, it, labels,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float,
    u0=None, v0=None,
    fuse: int = DEFAULT_FUSE,
):
    """tpuflow's caller of its Pallas kernel: blocks of ``fuse`` sweeps
    (ceil(iter_max / fuse) of them), energy and strike checks after every
    64 // fuse blocks, i.e. after sweeps 64, 128, ... The descent is
    :func:`irls_gradient_method`'s; only the stop decision points move.
    Returns (u, v, E, blocks, trace)."""
    sup_x, sup_y = _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s)
    threshold = in_dtype(error_min_threshold, gx.dtype)
    per_check = max(CHECK_EVERY // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    trace = [math.nan] * max(-(-n_blocks // per_check), 1)
    u = torch.zeros_like(gx) if u0 is None else u0
    v = torch.zeros_like(gx) if v0 is None else v0
    E, inc, b = 0.0, 0, 0
    while b < n_blocks:
        u, v = irls_stencil.irls_gated_sweeps(
            u, v, gx, gy, it, labels, sup_x, sup_y, fuse, lambda_d,
            lambda_s, sigma_d, sigma_s)
        b += 1
        if b % per_check:
            continue
        E_new = irls_stencil.irls_gated_energy(
            u, v, gx, gy, it, labels, lambda_d, lambda_s, sigma_d,
            sigma_s).item()  # host sync
        inc = inc + 1 if E_new > E else 0
        E = E_new
        trace[b // per_check - 1] = E
        if E < threshold or inc > 3:
            break
    return u, v, E, b, torch.tensor(trace, dtype=gx.dtype)


def gradient_method_flow(
    reference_lab: torch.Tensor,
    interest_lab: torch.Tensor,
    mv_u: torch.Tensor,
    mv_v: torch.Tensor,
    labels: torch.Tensor,
    lambda_d: float = LAMBDA_D,
    lambda_s: float = LAMBDA_S,
    sigma_d: float = SIGMA_D_BM,
    sigma_s: float = SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    u0=None,
    v0=None,
    zero_warp: bool = False,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """OpticalFlow_GradientMethod (OpticalFlow_BlockMatching.cpp:367-409)
    on the frames' device. Gradients and dt in standard Lab units (the
    reference's robust constants assume L in [0, 100]). The reference
    zeroes MV before refinement; ``zero_warp=True`` takes the static-shift
    dt. ``u0``/``v0`` warm-start the IRLS. Returns (u, v)."""
    interest_l = interest_lab[..., 0] * LAB_SCALE
    reference_l = reference_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    if zero_warp:
        it = gradient_method_dt_zero(reference_l, interest_l)
    else:
        it = gradient_method_dt(reference_l, interest_l, mv_u, mv_v)
    u, v, _, _, trace = irls_gradient_method(
        gx, gy, it, labels, lambda_d, lambda_s, sigma_d, sigma_s,
        int(iter_max), error_min_threshold, u0, v0, sup_mode=sup_mode,
        plateau_rtol=float(plateau_rtol), blocks=blocks)
    emit_energy_trace(0, trace, CHECK_EVERY, 0)
    return u, v


def gradient_method_flow_bidirectional(
    reference_labs,
    interest_lab: torch.Tensor,
    labels: torch.Tensor,
    lambda_d: float = LAMBDA_D,
    lambda_s: float = LAMBDA_S,
    sigma_d: float = SIGMA_D_BM,
    sigma_s: float = SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    mvs=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """Both time directions of the gradient refine through
    :func:`irls_gradient_method_batched` (gx/gy/labels belong to the
    interest frame and are shared; only dt differs). ``mvs`` (B (H, W, 2)
    BM fields) switches each direction's dt to the BM warp. Returns a list
    of B (u, v) pairs, each equal to the serial
    :func:`gradient_method_flow` call."""
    interest_l = interest_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    if mvs is None:
        its = torch.stack([gradient_method_dt_zero(r[..., 0] * LAB_SCALE,
                                                   interest_l)
                           for r in reference_labs])
    else:
        its = torch.stack([
            gradient_method_dt(r[..., 0] * LAB_SCALE, interest_l,
                               mv[..., 0], mv[..., 1])
            for r, mv in zip(reference_labs, mvs)])
    u, v, _, _, trace = irls_gradient_method_batched(
        gx, gy, its, labels, lambda_d, lambda_s, sigma_d, sigma_s,
        int(iter_max), error_min_threshold, sup_mode=sup_mode,
        plateau_rtol=float(plateau_rtol), blocks=blocks)
    for b in range(len(reference_labs)):
        emit_energy_trace(0, trace[b], CHECK_EVERY, 0)
    return [(u[b], v[b]) for b in range(len(reference_labs))]


# ---------------------------------------------------------------------------
# Per-region affine parametric motion (AffineParametric)


def _irls_affine_regions(gx, gy, it, plan, sigma: float,
                         iter_max: int, error_min_threshold: float,
                         normalize_steps: bool = False, a0=None,
                         origin=(0, 0), reduce_sum=None, reduce_max=None):
    """All regions' 6-parameter IRLS at once (IRLS_AffineParametric_region,
    Affine_BlockMatching.cpp:84-116; omega = 1): ``iter_max`` iterations,
    a region frozen once its energy falls below the threshold. Returns
    (a (n_regions, 6), u, v).

    Every per-region sum runs through ``plan``, the fields' own
    :class:`matcher.RegionPlan` (pixels sorted by label once, then
    contiguous range sums in :data:`matcher.ACC`, cast back to the fields'
    dtype), so the stop tests and the parameters do not depend on a run's
    summation order; the six basis fields are permuted once, psi and rho
    every iteration.

    On a mesh tile (:mod:`tpuflow_torch.dist.bm_refine`) the fields are
    the tile's, ``origin`` its frame coordinates, and ``reduce_sum`` /
    ``reduce_max`` reduce the tile's float64 region sums and maxima over
    the mesh before they are used."""
    h, w = gx.shape
    dt, dev = gx.dtype, gx.device
    reduce_sum = reduce_sum or (lambda t: t)
    reduce_max = reduce_max or (lambda t: t)
    n_regions, perm, bounds = plan.n_regions, plan.perm, plan.bounds
    lab = plan.labels.long()
    x = (torch.arange(w, dtype=dt, device=dev) + origin[1])[None, :].expand(
        h, w)
    y = (torch.arange(h, dtype=dt, device=dev) + origin[0])[:, None].expand(
        h, w)
    basis = torch.stack([gx, gx * x, gx * y, gy, gy * x, gy * y],
                        dim=-1).reshape(-1, 6)
    basis_sorted = basis[perm]

    def seg_sum(f_sorted):  # (N, C) in label order -> (n_regions, C)
        return reduce_sum(matcher._contiguous_range_sums(f_sorted,
                                                         bounds)).to(dt)

    def sorted_column(f):  # (H, W) -> (N, 1) in label order
        return f.reshape(-1)[perm][:, None]

    # sup_i per region: 2 * max_site (basis_i^2) / sigma^2
    # (sup_Error_aa_region); the max is order-free.
    seg_max = reduce_max(torch.full((n_regions, 6), -math.inf, dtype=dt,
                                    device=dev).scatter_reduce(
        0, lab.reshape(-1, 1).expand(-1, 6), basis * basis, "amax"))
    sup = true_div(2.0 * seg_max, sigma**2)
    tiny = sup.abs() < 1.0e-10
    step = torch.where(tiny, torch.where(sup >= 0, 1.0e10, -1.0e10).to(dt),
                       1.0 / torch.where(tiny, 1.0, sup))
    if normalize_steps:
        # tpuflow's stabilized step (not in the reference): dE is a sum
        # over the region while sup is a per-site max, so the reference's
        # omega = 1 step overshoots on large regions; divide by the size.
        counts = reduce_sum(bounds[1:] - bounds[:-1]).to(dt)
        step = step / torch.clamp_min(counts, 1.0)[:, None]

    def flow_of(a):
        a_pix = a[lab]  # (H, W, 6)
        u = a_pix[..., 0] + a_pix[..., 1] * x + a_pix[..., 2] * y
        v = a_pix[..., 3] + a_pix[..., 4] * x + a_pix[..., 5] * y
        return u, v

    a = (torch.zeros((n_regions, 6), dtype=dt, device=dev) if a0 is None
         else torch.as_tensor(a0, dtype=dt, device=dev))
    done = torch.zeros(n_regions, dtype=torch.bool, device=dev)
    u, v = flow_of(a)
    for k in range(iter_max):
        if k and k % AFFINE_CHECK_EVERY == 0 and bool(done.all()):  # sync
            break
        psi = geman_mcclure_psi(gx * u + gy * v + it, sigma)
        dE = seg_sum(basis_sorted * sorted_column(psi))  # (n_regions, 6)
        a = torch.where(done[:, None], a, a - step * dE)
        u, v = flow_of(a)
        E = seg_sum(sorted_column(
            geman_mcclure_rho(gx * u + gy * v + it, sigma)))[:, 0]
        done = done | (E < error_min_threshold)
    return a, u, v


def affine_parametric_flow(
    reference_lab: torch.Tensor,
    interest_lab: torch.Tensor,
    mv_u: torch.Tensor,
    mv_v: torch.Tensor,
    labels,
    n_regions: int,
    sigma: float = SIGMA_AFFINE_BM,
    iter_max: int = 256,
    error_min_threshold: float = 1.0e-6,
    normalize_steps: bool = False,
    a0=None,
):
    """AffineParametric (Affine_BlockMatching.cpp:11-77): per-region
    6-parameter robust fit of the residual motion under the BM warp
    (mv_u, mv_v), on the frames' device. ``labels``: the host (H, W) label
    map, or its :class:`matcher.RegionPlan` on the frames' device. Returns
    (a (n_regions, 6), u, v).

    ``normalize_steps=True`` selects tpuflow's stabilized step (the mean
    gradient instead of the reference's summed gradient, which diverges
    on mean-shift-sized regions); False reproduces the reference. The
    flagship defaults to the stabilized step. tpuflow pads the region
    count to a compile bucket and slices the result back; the port works
    with the true count.
    """
    interest_l = interest_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    it = gradient_method_dt(reference_lab[..., 0] * LAB_SCALE, interest_l,
                            mv_u, mv_v)
    plan = matcher.as_plan(labels, n_regions, interest_lab.device)
    return _irls_affine_regions(gx, gy, it, plan, float(sigma), int(iter_max),
                                error_min_threshold, normalize_steps, a0)


# ---------------------------------------------------------------------------
# Vector_ST composition (OpticalFlow_BlockMatching.cpp:306-361): row
# gathers of the per-region (u, v) and cost, on the device. The costs stay
# in the matcher's float64, so t compares what the search compared.


def _compose_bidirectional(labels, bm_p, bm_n, ru_p, rv_p, ru_n, rv_n):
    (uv_p, cost_p), (uv_n, cost_n) = bm_p, bm_n
    neg = cost_p[labels] <= cost_n[labels]
    t = torch.where(neg, -1, 1).to(torch.int8)
    g_p = uv_p[labels]  # (H, W, 2): [u, v]
    g_n = uv_n[labels]
    u_bm = torch.where(neg, g_p[..., 0], g_n[..., 0])
    v_bm = torch.where(neg, g_p[..., 1], g_n[..., 1])
    u_out = u_bm + torch.where(neg, ru_p, ru_n)
    v_out = v_bm + torch.where(neg, rv_p, rv_n)
    return u_out, v_out, t, u_bm, v_bm


def _compose_unidirectional(labels, bm_p, ru, rv):
    g = bm_p[0][labels]
    u_bm = g[..., 0]
    v_bm = g[..., 1]
    return u_bm + ru, v_bm + rv, u_bm, v_bm


# ---------------------------------------------------------------------------
# The flagship's entry points, with explicit history state


@dataclass
class BMFlowState:
    """The reference's static deques made explicit (newest first): Lab
    frames as tensors on the device it runs on, normalized RGB frames and
    segmentations on the host."""

    lab_frames: list = field(default_factory=list)
    rgb_frames: list = field(default_factory=list)
    segmentations: list = field(default_factory=list)

    def push(self, lab, rgb, seg):
        self.lab_frames.insert(0, lab)
        self.rgb_frames.insert(0, rgb)
        self.segmentations.insert(0, seg)
        # History_Max = 4 (OpticalFlow_BlockMatching.cpp:16-22).
        if len(self.lab_frames) > HISTORY_MAX:
            self.lab_frames.pop()
            self.rgb_frames.pop()
            self.segmentations.pop()

    @classmethod
    def from_tpuflow(cls, state, device) -> "BMFlowState":
        """Carry a tpuflow ``BMFlowState`` across, by field name: its Lab
        frames become tensors on ``device``, the rest host arrays."""
        return cls(
            lab_frames=[torch.from_numpy(np.array(f)).to(device)
                        for f in state.lab_frames],
            rgb_frames=[np.array(r) for r in state.rgb_frames],
            segmentations=[SegmentationResult(
                labels=np.array(s.labels), n_regions=int(s.n_regions),
                shift_spatial=np.array(s.shift_spatial),
                shift_color=np.array(s.shift_color))
                for s in state.segmentations])


@dataclass
class BMFlowOutput:
    u: np.ndarray            # (H, W) composed flow x
    v: np.ndarray            # (H, W)
    t: np.ndarray            # (H, W) int8 time direction in {-1, +1}
    segmentation: SegmentationResult
    quantized_rgb: np.ndarray        # (H, W, 3) uint8 side output
    shift_vector: np.ndarray         # (H, W, 2) mean-shift spatial shifts
    bm_u: np.ndarray
    bm_v: np.ndarray
    # True when >= 3 frames were buffered: the motion belongs to the
    # middle frame (Scratch_MeaningfulMotion.cpp:544-552).
    bidirectional: bool = False


def _region_sums(rgb_norm: np.ndarray,
                 seg: SegmentationResult) -> np.ndarray:
    """Per-region colour sums, float64 (n_regions, 3), added in pixel
    order: ``np.bincount`` adds each weight into its bin in index order,
    in double, so the sums are ``np.add.at``'s bit for bit, without its
    slow path for a 2-D target."""
    flat = seg.labels.reshape(-1)
    channels = rgb_norm.reshape(-1, 3).T.astype(np.float64, order="C")
    return np.stack([np.bincount(flat, weights=c, minlength=seg.n_regions)
                     for c in channels], axis=-1)


def _quantize_colors(rgb_norm: np.ndarray,
                     seg: SegmentationResult) -> np.ndarray:
    """Per-region mean colour, x255, clipped (the colour-quantized side
    output, OpticalFlow_BlockMatching.cpp:154-181)."""
    sums = _region_sums(rgb_norm, seg)
    counts = np.maximum(np.bincount(seg.labels.reshape(-1),
                                    minlength=seg.n_regions), 1)
    means = np.clip(sums / counts[:, None] * 255.0, 0, 255)
    # The cast is elementwise: cast the table, then gather bytes.
    return np.take(means.astype(np.uint8), seg.labels, axis=0)


def _shift_vector(shift_spatial: np.ndarray) -> np.ndarray:
    """The mean-shift side output: each pixel's converged (x, y) less its
    own (x, y), float64 (H, W, 2)."""
    h, w = shift_spatial.shape[:2]
    shift = np.empty((h, w, 2))
    np.subtract(shift_spatial[..., 0], np.arange(w), out=shift[..., 0])
    np.subtract(shift_spatial[..., 1], np.arange(h)[:, None],
                out=shift[..., 1])
    return shift


def _to_lab(rgb: np.ndarray, max_int: float):
    """Normalized RGB and Lab, float32, computed on the host: the card's
    pow differs from the CPU's in the last bit, and the segmentation
    thresholds Lab distances, so both devices segment the same bits. The
    conversion's bits do not depend on the torch thread count (a mesh rank
    runs one thread): see ``numerics.pow_fixed_split``."""
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    norm = true_div(torch.from_numpy(np.asarray(rgb, np.float32)), max_int)
    return norm, srgb_to_lab(norm)


def optical_flow_block_matching_async(
    it_rgb: np.ndarray,
    itp1_rgb: np.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    mode: int = 0,
    iter_max: int = 2048,
    state: BMFlowState | None = None,
    search_range: int = 61,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    subpixel_scale: int = 2,
    mesh=None,
    bm_method: str = "matmul",
    refine_warp: bool = False,
    affine_normalize_steps: bool = True,
    refine_sup_mode: str = "reference",
    refine_plateau_rtol: float = 0.0,
    seg_scale: int = 1,
    profile: str | None = None,
    device="cuda",
    blocks: list | None = None,
):
    """The flagship, split into the device work and a deferred
    fetch. Takes numpy RGB frames as tpuflow's does and runs on
    ``device`` (the card unless told otherwise).

    The first call (empty ``state``) segments both frames and matches the
    new frame against the old one (unidirectional, t = -1); once two
    frames are buffered, each call matches and refines the MIDDLE frame
    (segmented on the previous call) against its previous and next frames
    and composes (u, v, t) from the better direction per region. The new
    frame's filter is launched first and its output copied to pinned host
    memory right behind it; the host labels it once the middle frame's
    search is issued. The search's blocking uploads (its plan's labels and
    its tables) come before its first launch, so the labeling runs beside
    the search on the card.

    ``profile``: :data:`PROFILES`; ``seg_scale > 1`` segments the
    stride-``seg_scale`` frame; ``refine_sup_mode``/``refine_plateau_rtol``:
    see :func:`irls_gradient_method`; ``refine_warp=True`` feeds the
    refinement the real BM field instead of the reference's zeros;
    ``bm_method``: one of :data:`matcher.METHODS`; ``blocks``, when a
    list, receives the gated refine's launch count (0 in mode AFFINE; on a
    mesh, its fused blocks). ``mode``
    ``MODE_OUTPUT_AFFINE_BLOCKMATCHING`` refines each direction with
    :func:`affine_parametric_flow` under the real BM field (at most 256
    iterations; ``affine_normalize_steps`` picks its step) instead of the
    gated gradient method. ``mesh`` runs every device stage over the
    mesh's ranks on its device (``device`` is then the mesh's; see the
    module docstring); as in tpuflow, the first frame's segmentation runs
    on each rank alone, and the sharded refine checks its energy at the
    fused-block cadence (sweeps 64, 128, ...).

    Returns ``(finalize, state)``; ``finalize()`` fetches the composed
    fields as a :class:`BMFlowOutput`. Flow semantics: inverse flow,
    vectors point from current-frame pixels to the reference frame, with
    t = -1 (previous) or +1 (next).
    """
    if profile is not None:
        if profile not in PROFILES:
            raise ValueError(f"unknown profile {profile!r}; expected one "
                             f"of {sorted(PROFILES)}")
        knobs = PROFILES[profile]
        bm_method = knobs.get("bm_method", bm_method)
        refine_sup_mode = knobs.get("refine_sup_mode", refine_sup_mode)
        refine_plateau_rtol = knobs.get("refine_plateau_rtol",
                                        refine_plateau_rtol)
        if mesh is None:
            seg_scale = knobs.get("seg_scale", seg_scale)
        if "refine_iter_max" in knobs:
            iter_max = min(iter_max, knobs["refine_iter_max"])
    matcher.validate_method(bm_method)
    device = torch.device(device if mesh is None else mesh.device)
    if param is None:
        param = MultipleMotionParam()
    if state is None:
        state = BMFlowState()
    seg_args = (kernel_spatial, kernel_intensity)

    def lab_on_device(rgb):
        with record_span("bm.lab"):
            norm, lab = _to_lab(np.asarray(rgb), max_int)
            with record_span("wait.lab_upload"):
                return norm, lab.to(device)

    def segment_async(lab, on_mesh=None):
        with record_span("bm.segment", device=device):
            return meanshift.segment_meanshift_async(
                lab, *seg_args, scale=int(seg_scale), mesh=on_mesh)

    def label(finalize_seg):
        with record_span("bm.label"):
            seg = finalize_seg()
            note(regions=seg.n_regions)
        return seg

    # With the new frame not yet pushed: state[0] = the middle frame,
    # state[1] = the one before it (OpticalFlow_BlockMatching.cpp:84-93).
    bidirectional = len(state.lab_frames) >= 2
    with record_span("bm.frame", bidirectional=bidirectional):
        if not state.lab_frames:
            it_norm, it_lab = lab_on_device(it_rgb)
            state.push(it_lab, it_norm.numpy(),
                       label(segment_async(it_lab)))
        itp1_norm, itp1_lab = lab_on_device(itp1_rgb)
        finalize_seg = segment_async(itp1_lab, mesh)
        if mesh is None:
            match_one = matcher._match_device
            match_two = matcher._match_device_bidirectional
        else:
            from tpuflow_torch.dist import bm as dist_bm, bm_refine

            def match_one(cur, ref, plan, *args):
                return dist_bm._match_device_sharded(cur, ref, plan, mesh,
                                                     *args)

            def match_two(cur, refp, refn, plan, *args):
                return dist_bm._match_device_sharded_bidirectional(
                    cur, refp, refn, plan, mesh, *args)

        if bidirectional:
            interest_lab = state.lab_frames[0]
            seg = state.segmentations[0]
            ref_prev = state.lab_frames[1]
            ref_next = itp1_lab
            with record_span("bm.search", device=device, directions=2):
                plan = matcher.region_plan(seg.labels, seg.n_regions, device)
                bm_dev = list(match_two(
                    interest_lab, ref_prev, ref_next, plan, search_range,
                    1.0, 0.5, subpixel_scale, 16, bm_method))
            seg_new = label(finalize_seg)
        else:
            # First pair: the new frame's segmentation gates the match.
            seg_new = seg = label(finalize_seg)
            interest_lab = itp1_lab
            ref_prev = state.lab_frames[0]
            with record_span("bm.search", device=device, direction="prev"):
                plan = matcher.region_plan(seg.labels, seg.n_regions, device)
                bm_dev = [match_one(
                    interest_lab, ref_prev, plan, search_range, 1.0, 0.5,
                    subpixel_scale, 16, bm_method)]

        refine_kw = dict(iter_max=iter_max,
                         error_min_threshold=param.error_min_threshold,
                         sup_mode=refine_sup_mode,
                         plateau_rtol=refine_plateau_rtol, blocks=blocks)
        labels_long = plan.labels.long()

        def mv_of(bm_uv):
            return bm_uv[labels_long]

        with record_span("bm.refine", device=device):
            if mode == MODE_OUTPUT_AFFINE_BLOCKMATCHING:
                # AffineParametric receives the real per-pixel BM field:
                # the reference zeroes MV only in the gradient branch
                # (OpticalFlow_BlockMatching.cpp:278-304). One fit a
                # direction.
                affine_kw = dict(
                    iter_max=min(iter_max, 256),
                    error_min_threshold=param.error_min_threshold,
                    normalize_steps=affine_normalize_steps)
                if mesh is not None:
                    # The search's geometry bounds |MV| (the subpixel step
                    # adds less than 1 px): the warp halo needs no host sync.
                    affine_kw.update(mesh=mesh,
                                     max_displacement=search_range // 2 + 1)
                fit = (affine_parametric_flow if mesh is None
                       else bm_refine.affine_parametric_flow_sharded)
                refined = []
                for ref, bm in zip((ref_prev, ref_next) if bidirectional
                                   else (ref_prev,), bm_dev):
                    mv = mv_of(bm[0])
                    _, u, v = fit(ref, interest_lab, mv[..., 0],
                                  mv[..., 1], plan, seg.n_regions,
                                  **affine_kw)
                    refined.append((u, v))
                if blocks is not None:
                    blocks.append(0)
            elif mesh is not None:
                mvs = ([mv_of(bm[0]) for bm in bm_dev] if refine_warp
                       else None)
                refs = [ref_prev, ref_next] if bidirectional else [ref_prev]
                pairs, trace = (
                    bm_refine.gradient_method_flow_sharded_bidirectional(
                        refs, interest_lab, plan.labels, mesh, mvs=mvs,
                        **refine_kw))
                # E(n) at sweeps 0, 64, ... as tpuflow records it
                for row in trace:
                    emit_energy_trace(0, row, CHECK_EVERY, 0)
                refined = pairs
            elif bidirectional:
                refined = gradient_method_flow_bidirectional(
                    [ref_prev, ref_next], interest_lab, plan.labels,
                    mvs=([mv_of(bm_dev[0][0]), mv_of(bm_dev[1][0])]
                         if refine_warp else None), **refine_kw)
            elif refine_warp:
                mv = mv_of(bm_dev[0][0])
                refined = [gradient_method_flow(
                    ref_prev, interest_lab, mv[..., 0], mv[..., 1],
                    plan.labels, **refine_kw)]
            else:
                zeros = torch.zeros_like(interest_lab[..., 0])
                refined = [gradient_method_flow(
                    ref_prev, interest_lab, zeros, zeros, plan.labels,
                    zero_warp=True, **refine_kw)]

        with record_span("bm.compose", device=device):
            if bidirectional:
                composed = _compose_bidirectional(
                    labels_long, *bm_dev, *refined[0], *refined[1])
            else:
                composed = _compose_unidirectional(labels_long, bm_dev[0],
                                                   *refined[0])

        with record_span("bm.side_outputs"):
            state.push(itp1_lab, itp1_norm.numpy(), seg_new)
            quantized = _quantize_colors(itp1_norm.numpy(), seg_new)
            shift = _shift_vector(seg_new.shift_spatial)

    def finalize() -> BMFlowOutput:
        with record_span("bm.fetch"):
            with record_span("wait.fetch", count=len(composed)):
                fields = [f.cpu().numpy() for f in composed]
            if bidirectional:
                u_out, v_out, t, u_bm, v_bm = fields
            else:
                u_out, v_out, u_bm, v_bm = fields
                t = np.full(seg.labels.shape, -1, np.int8)
            return BMFlowOutput(
                u=u_out, v=v_out, t=t, segmentation=seg,
                quantized_rgb=quantized, shift_vector=shift,
                bm_u=u_bm, bm_v=v_bm, bidirectional=bidirectional)

    return finalize, state


def optical_flow_block_matching(
    it_rgb: np.ndarray,
    itp1_rgb: np.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    mode: int = 0,
    iter_max: int = 2048,
    state: BMFlowState | None = None,
    search_range: int = 61,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    subpixel_scale: int = 2,
    mesh=None,
    bm_method: str = "matmul",
    refine_warp: bool = False,
    affine_normalize_steps: bool = True,
    refine_sup_mode: str = "reference",
    refine_plateau_rtol: float = 0.0,
    seg_scale: int = 1,
    profile: str | None = None,
    device="cuda",
    blocks: list | None = None,
) -> tuple[BMFlowOutput, BMFlowState]:
    """The flagship (OpticalFlow_BlockMatching.cpp:13-362):
    :func:`optical_flow_block_matching_async` and its fetch."""
    finalize, state = optical_flow_block_matching_async(
        it_rgb, itp1_rgb, max_int, param=param, mode=mode,
        iter_max=iter_max, state=state, search_range=search_range,
        kernel_spatial=kernel_spatial, kernel_intensity=kernel_intensity,
        subpixel_scale=subpixel_scale, mesh=mesh, bm_method=bm_method,
        refine_warp=refine_warp,
        affine_normalize_steps=affine_normalize_steps,
        refine_sup_mode=refine_sup_mode,
        refine_plateau_rtol=refine_plateau_rtol, seg_scale=seg_scale,
        profile=profile, device=device, blocks=blocks)
    return finalize(), state
