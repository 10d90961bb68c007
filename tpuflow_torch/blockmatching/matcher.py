"""Block matching over labeled regions (port of :mod:`tpuflow.blockmatching.matcher`).

Reconstruction of ``BlockMatching<Lab>`` (OpticalFlow_BlockMatching.cpp:
96-219): per region, an exhaustive search over a ``search_range``-wide
window of integer displacements with cost ``coeff_MAD * MAD - coeff_ZNCC
* ZNCC`` (lower is better), then a ``subpixel``-scale refinement around
the integer winner. Out-of-frame reference reads are zeros (the
reference's ``get_zeropad``).

The integer-search evaluators, as in tpuflow (:data:`METHODS`):

- ``"matmul"`` (default): every region's float64 (:data:`ACC`) moment
  sums for every candidate, from
  :func:`tpuflow_torch.kernels.bm_cost.region_sums`: on the card one
  hand-written kernel (``csrc/bm_cost.cu``) over the whole candidate
  list; on the CPU its plain version ``bm_cost._matmul_sums``, where per
  32-row strip the region one-hot matrix L (strip pixels x regions present
  in the strip) reduces every candidate chunk's moment fields in ONE
  ``L^T @ F`` product, the shifted reference one gather per chunk from a
  zero-padded copy;
- ``"matmul_bf16"``: the same, with the per-candidate moment fields
  rounded to bfloat16 first (tpuflow's ``mxu_dtype``), then summed exactly
  as the others are;
- ``"matmul_coarse"`` / ``"matmul_coarse3"``: the stride-2 / stride-3
  subgrid of the candidates (:func:`coarse_candidates`), then an inclusive
  +-1-px refinement at 1/subpixel steps around the coarse winner
  (:func:`_refine_offsets`), which recovers the skipped cells;
- ``"matmul_half"`` / ``"matmul_half2"``: the stride-2 subgrid scored on
  anti-aliased half-resolution frames and labels (:func:`_half_res`,
  :meth:`RegionPlan.view`), then the same refinement at full resolution
  (radius 2 for ``_half2``);
- ``"gather"``: pixels permuted into label order once, per-region sums
  by chunk sums + boundary prefixes (:func:`_contiguous_range_sums`).

The coarse and half-resolution methods are not bitwise the exhaustive
search (a distant coarse cell can out-score the true winner's
neighbours); they are held to tpuflow's same method.

The per-pixel fields are computed in the frames' dtype, as in tpuflow,
and every per-region sum, cost and argmin in float64 (:data:`ACC`, where
tpuflow sums in float32):
float32 sums taken in two devices' orders differ by ~1e-6 relative, which
the ZNCC's moment form amplifies past the gap between neighbouring
subpixel candidates of a small region, so the card and the CPU would
pick different winners. Every reduction is deterministic: no
``index_add_``/``scatter_add_`` (CUDA sums those with atomics in a
changing order, which would flip an argmin at a near-tie from run to
run). The candidate list is padded with (0, 0) fillers to a multiple of
the chunk (:func:`padded_candidates`, tpuflow's ``_padded_candidates``),
so every chunk's product has the same shape and contents whether one
device scores the whole list or a mesh rank scores its slice
(:mod:`tpuflow_torch.dist.bm`): the two agree bitwise (the card's kernel
sums each candidate in an order of its own, so its columns agree too).
tpuflow's ``region_bucket``/``pad_region_bounds``, which dodge XLA
recompiles, are not ported: the port works with the true region count.

Every search reduces by one :class:`RegionPlan` of its label map
(:func:`region_plan`: the labels go to the frames' device once and are
sorted there), which the flagship's refine and compose reuse; the
candidate table and the refine's offsets go to the device once a search.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpuflow_torch.kernels import bm_cost
from tpuflow_torch.kernels.bm_cost import _l1, _shifted
from tpuflow_torch.utils.telemetry import note, record_span

#: The integer-search evaluators (tpuflow's, in its order).
METHODS = ("matmul", "matmul_bf16", "matmul_coarse", "matmul_coarse3",
           "matmul_half", "matmul_half2", "gather")

#: The dtype of every per-region sum and cost.
ACC = torch.float64

#: Most regions a match takes. The per-candidate sums hold n_cand x
#: n_regions x 8 floats (61x61 search: 1.9 GB at this limit); a frame
#: segmented finer than this is refused with its count, not left to run
#: out of memory.
MAX_REGIONS = 16384


def validate_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(
            f"unknown block-matching method {method!r}; expected one of "
            f"{METHODS}")


def grid_labels(h: int, w: int, block_size: int) -> np.ndarray:
    """The reference's fixed-block domain map
    (OpticalFlow_BlockMatching.cpp:103-108)."""
    ys, xs = np.mgrid[0:h, 0:w]
    nbx = -(-w // block_size)
    return (nbx * (ys // block_size) + xs // block_size).astype(np.int32)


@dataclass
class BlockMatchResult:
    """Per-pixel motion vectors (+ per-region winners), host arrays."""

    u: np.ndarray        # (H, W) x-displacement (toward the reference frame)
    v: np.ndarray        # (H, W)
    cost: np.ndarray     # (H, W) winning cost (per pixel via its region)
    region_uv: np.ndarray    # (n_regions, 2)
    region_cost: np.ndarray  # (n_regions,)


@dataclass
class RegionPlan:
    """One label map's region reduction plan (:func:`region_plan`): the
    stable sort of its pixels by label and the region bounds in that
    order, beside the map on the host and on the frames' device."""

    host_labels: np.ndarray  # (H, W) host label map (the CPU strip loop)
    labels: torch.Tensor     # (H, W) contiguous int32 on the device
    perm: torch.Tensor       # (H * W,) int64: pixels in label order
    bounds: torch.Tensor     # (n_regions + 1,) int64 region offsets in perm
    seg_end: torch.Tensor    # (n_regions,) int64 (bm_cost.segment_plan)
    n_regions: int

    def view(self, rows: slice, cols: slice) -> "RegionPlan":
        """The plan of a window of the map (a mesh tile, or the stride-2
        half-resolution grid), from the device labels: no upload."""
        labels = self.labels[rows, cols].contiguous()
        return RegionPlan(self.host_labels[rows, cols], labels,
                          *bm_cost.segment_plan(labels, self.n_regions),
                          self.n_regions)


def region_plan(labels, n_regions: int, device) -> RegionPlan:
    """The :class:`RegionPlan` of the host label map ``labels`` (values in
    [0, n_regions)) on ``device``: one upload, then
    ``bm_cost.segment_plan`` on the device (no host sort)."""
    labels = np.asarray(labels)
    n_regions = int(n_regions)
    if n_regions > MAX_REGIONS:
        raise ValueError(f"block matching: {n_regions} regions, more than "
                         f"MAX_REGIONS={MAX_REGIONS}")
    if labels.size and (labels.min() < 0 or labels.max() >= n_regions):
        raise ValueError(f"block matching: labels outside [0, {n_regions})")
    with record_span("wait.plan"):
        labels_t = torch.from_numpy(
            np.ascontiguousarray(labels, dtype=np.int32)).to(device)
    return RegionPlan(labels, labels_t,
                      *bm_cost.segment_plan(labels_t, n_regions), n_regions)


def as_plan(labels, n_regions: int, device) -> RegionPlan:
    """``labels`` if a :class:`RegionPlan`, else its host map's plan."""
    if isinstance(labels, RegionPlan):
        return labels
    return region_plan(labels, n_regions, device)


def region_reduction_plan(labels: np.ndarray, n_regions: int):
    """The sort-by-label pixel permutation and the region boundary offsets
    on the host: the plain reference of :class:`RegionPlan`'s."""
    flat = np.asarray(labels).reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int64)
    counts = np.bincount(flat, minlength=n_regions)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return perm, bounds


def _contiguous_range_sums(sorted_fields: torch.Tensor, bounds: torch.Tensor,
                           chunk: int = 512) -> torch.Tensor:
    """Per-range sums S[bounds[r]:bounds[r+1]] of an (N, C) array, in
    :data:`ACC`: chunk partial sums, their cumsum, and masked prefixes of
    the boundary chunks."""
    sorted_fields = sorted_fields.to(ACC)
    n, c = sorted_fields.shape
    n_pad = -(-n // chunk) * chunk
    f = torch.nn.functional.pad(sorted_fields, (0, 0, 0, n_pad - n))
    chunks = f.view(n_pad // chunk, chunk, c)
    partial = chunks.sum(dim=1)                          # (n_chunks, C)
    cs = torch.cat([torch.zeros((1, c), dtype=f.dtype, device=f.device),
                    torch.cumsum(partial, dim=0)], dim=0)
    cidx = torch.div(bounds, chunk, rounding_mode="floor")
    off = bounds % chunk
    rows = chunks[torch.clamp_max(cidx, chunks.shape[0] - 1)]
    mask = (torch.arange(chunk, device=f.device)[None, :]
            < off[:, None]).to(f.dtype)
    prefix = (rows * mask[:, :, None]).sum(dim=1)        # (n_bounds, C)
    s_at = cs[cidx] + prefix
    return s_at[1:] - s_at[:-1]


def _moment_fields(cur: torch.Tensor, ref_shifted: torch.Tensor,
                   member: torch.Tensor) -> torch.Tensor:
    """(N, 7) per-pixel moment fields for the MAD+ZNCC cost: membership,
    Lab L1 (standard Lab units: tpuflow's Lab is normalized by 100) and
    the L-channel ZNCC moments. Out-of-frame reads arrive as zeros."""
    m = member.to(cur.dtype)
    lab_l1 = _l1(cur, ref_shifted)
    a = cur[..., 0]
    b = ref_shifted[..., 0]
    return torch.stack(
        [m, m * lab_l1, m * a, m * b, m * a * a, m * b * b, m * a * b],
        dim=-1).reshape(-1, 7)


def _cost_core(n, s_mad, s_a, s_b, s_aa, s_bb, s_ab):
    """Moment sums (broadcastable) -> (mad, zncc, n). ZNCC is clamped to
    [-1, 1]: the float moment form loses the Cauchy-Schwarz bound on
    near-constant regions."""
    n_safe = torch.clamp_min(n, 1.0)
    mad = s_mad / n_safe
    sa = s_a / n_safe
    sb = s_b / n_safe
    saa = s_aa / n_safe
    sbb = s_bb / n_safe
    sab = s_ab / n_safe
    var_a = torch.clamp_min(saa - sa * sa, 0.0)
    var_b = torch.clamp_min(sbb - sb * sb, 0.0)
    denom = torch.sqrt(var_a * var_b) + 1e-12
    zncc = torch.clamp((sab - sa * sb) / denom, -1.0, 1.0)
    big = torch.full((), float("inf"), dtype=mad.dtype, device=mad.device)
    return torch.where((n > 0).expand_as(mad), mad, big), zncc, n


def _cost_from_sums(sums: torch.Tensor):
    """(..., n_regions, 7) moment sums -> (mad, zncc, n)."""
    return _cost_core(*sums.unbind(-1))


def search_candidates(search_range: int) -> np.ndarray:
    """The (2R+1)^2 integer displacement grid, (n, (dy, dx)), row-major
    over dy then dx (the order every evaluator shares)."""
    R = search_range // 2
    return np.stack(
        np.meshgrid(np.arange(-R, R + 1), np.arange(-R, R + 1),
                    indexing="ij"), -1).reshape(-1, 2)


def padded_candidates(cand: np.ndarray, chunk: int,
                      n_shards: int = 1) -> np.ndarray:
    """``cand`` padded with (0, 0) fillers so each of ``n_shards`` slices
    holds a multiple of ``chunk`` (tpuflow's ``_padded_candidates``); the
    fillers' costs are dropped after scoring."""
    per = -(-len(cand) // n_shards)
    per = -(-per // chunk) * chunk
    pad = per * n_shards - len(cand)
    return np.concatenate([cand, np.zeros((pad, 2), cand.dtype)])


def coarse_candidates(search_range: int, stride: int = 2) -> np.ndarray:
    """The stride-``stride`` subgrid of :func:`search_candidates` (dy and
    dx both multiples of the stride, (0, 0) included), in the same order."""
    cand = search_candidates(search_range)
    keep = (cand[:, 0] % stride == 0) & (cand[:, 1] % stride == 0)
    return cand[keep]


def coarse_stride(method: str) -> int:
    return 3 if method == "matmul_coarse3" else 2


def is_coarse(method: str) -> bool:
    """Methods that score a candidate subgrid and finish with the local
    refine of :func:`_refine_offsets`."""
    return method.startswith(("matmul_coarse", "matmul_half"))


def method_candidates(method: str, search_range: int) -> np.ndarray:
    """The candidates ``method`` scores, before padding."""
    if is_coarse(method):
        return coarse_candidates(search_range, coarse_stride(method))
    return search_candidates(search_range)


def _binomial3(img: torch.Tensor) -> torch.Tensor:
    """Separable (1/4, 1/2, 1/4) low-pass of an (H, W, C) frame with
    edge-clamped borders, rows first (tpuflow's shift-adds)."""
    p = torch.cat([img[:1], img, img[-1:]], dim=0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    r = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
    return 0.25 * r[:, :-2] + 0.5 * r[:, 1:-1] + 0.25 * r[:, 2:]


def _half_res(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased half-resolution view of an (H, W, C) frame."""
    return _binomial3(img)[::2, ::2].contiguous()


def _integer_costs(cur_lab, ref_lab, plan: RegionPlan, cand,
                   coeff_mad: float, coeff_zncc: float, chunk: int,
                   radius: int):
    """The gather evaluator: MAD+ZNCC cost of every candidate,
    (n_cand, n_regions), reduced by ``plan``; ``radius`` bounds max |d|."""
    h, w, c = cur_lab.shape
    R = radius
    n_regions = plan.n_regions
    ref_p = torch.nn.functional.pad(ref_lab, (0, 0, R, R, R, R))
    cur = cur_lab.reshape(h * w, 1, c)
    a = cur[..., 0]
    out = []
    for k0 in range(0, cand.shape[0], chunk):
        d = cand[k0 : k0 + chunk]
        sub = _shifted(ref_p, R, 0, h, d)                 # (N, CH, C)
        b = sub[..., 0]
        one = torch.ones_like(b)
        f = torch.stack([one, _l1(cur, sub), a.expand_as(b), b,
                         (a * a).expand_as(b), b * b, a * b], dim=-1)
        sums = _contiguous_range_sums(f.reshape(h * w, -1)[plan.perm],
                                      plan.bounds)
        mad, zncc, _ = _cost_from_sums(
            sums.view(n_regions, d.shape[0], 7).transpose(0, 1))
        out.append(coeff_mad * mad - coeff_zncc * zncc)
    return torch.cat(out, dim=0)


def _matmul_costs(cur_lab, refs, plan: RegionPlan, cand, coeff_mad: float,
                  coeff_zncc: float, chunk: int, radius: int,
                  bf16: bool = False):
    """The matmul evaluator for one or more reference frames matched
    against the same current frame and plan: the region sums of
    :func:`tpuflow_torch.kernels.bm_cost.region_sums` (on a CUDA tensor
    the kernel, on a CPU tensor its plain strip loop), then the MAD + ZNCC
    cost of each. Returns one (n_cand, n_regions) cost table per
    reference, each equal to a single-reference call."""
    return _sums_costs(*bm_cost.region_sums(
        cur_lab, refs, plan.host_labels,
        (plan.perm, plan.bounds, plan.seg_end), plan.n_regions, cand, chunk,
        radius, bf16), coeff_mad, coeff_zncc)


def _sums_costs(acc_var, acc_fix, coeff_mad: float, coeff_zncc: float):
    """One (n_cand, n_regions) MAD + ZNCC cost table per reference from
    the region sums of ``bm_cost.region_sums``."""
    var = acc_var.permute(2, 0, 1)                      # (n_cand, n_reg, 4k)
    out = []
    for off in range(0, var.shape[-1], 4):
        mad, zncc, _ = _cost_core(acc_fix[:, 0], var[..., off],
                                  acc_fix[:, 1], var[..., off + 1],
                                  acc_fix[:, 2], var[..., off + 2],
                                  var[..., off + 3])
        out.append(coeff_mad * mad - coeff_zncc * zncc)
    return out


def method_costs(method: str, cur_lab, refs, plan: RegionPlan, cand,
                 search_range: int, coeff_mad: float, coeff_zncc: float,
                 chunk: int):
    """The integer cost tables, one per reference in ``refs`` (one or
    two), over the candidates ``cand`` (a device tensor, a padded slice of
    :func:`method_candidates`): ``"gather"`` by :func:`_integer_costs`;
    ``_half`` methods score the half-resolution frames and plan at half
    the displacement, the other matmul methods the frames themselves."""
    if method == "gather":
        return [_integer_costs(cur_lab, ref, plan, cand, coeff_mad,
                               coeff_zncc, chunk, search_range // 2)
                for ref in refs]
    if method.startswith("matmul_half"):
        half = slice(None, None, 2)
        return _matmul_costs(
            _half_res(cur_lab), [_half_res(r) for r in refs],
            plan.view(half, half), torch.div(cand, 2, rounding_mode="floor"),
            coeff_mad, coeff_zncc, chunk, -(-(search_range // 2) // 2))
    return _matmul_costs(cur_lab, refs, plan, cand, coeff_mad, coeff_zncc,
                         chunk, search_range // 2, method == "matmul_bf16")


def _refine_offsets(method: str, subpixel_scale: int):
    """The offsets (n_sub, (dy, dx)) the refine re-scores around each
    integer winner, on the host, or None (no refine): for a coarse method
    the inclusive [-radius, +radius]^2 grid at 1/subpixel steps (tpuflow's
    ``_local_refine``, which recovers the cells a coarse search skipped;
    radius 2 for ``matmul_half2``, else 1), else with ``subpixel_scale >
    1`` the 1/subpixel grid in (-1, 1)."""
    if is_coarse(method):
        scale = max(subpixel_scale, 1)
        radius = 2 if method == "matmul_half2" else 1
        steps = np.arange(-radius * scale, radius * scale + 1) * (1.0 / scale)
        return np.stack(np.meshgrid(steps, steps, indexing="ij"),
                        -1).reshape(-1, 2)
    if subpixel_scale > 1:
        steps = np.arange(-(subpixel_scale - 1), subpixel_scale)
        return np.stack(np.meshgrid(steps, steps, indexing="ij"),
                        -1).reshape(-1, 2) * (1.0 / subpixel_scale)
    return None


def _search_tables(method: str, search_range: int, chunk: int,
                   subpixel_scale: int, n_regions: int, dtype, device,
                   n_shards: int = 1):
    """A search's constant tables (cand, n_cand, sub, offsets): ``method``'s
    candidates padded to the chunk for each of ``n_shards`` slices
    (:func:`padded_candidates`) on ``device`` and their count before the
    padding, and the refine's offsets (:func:`_refine_offsets`) on the host
    and on ``device`` in ``dtype`` (both None without a refine); the
    uploads in one span. Notes the candidates' count and the regions."""
    cand_np = method_candidates(method, search_range)
    note(candidates=len(cand_np), regions=n_regions)
    sub = _refine_offsets(method, subpixel_scale)
    with record_span("wait.candidates", count=1 if sub is None else 2):
        cand = torch.as_tensor(padded_candidates(cand_np, chunk, n_shards),
                               device=device)
        offsets = (None if sub is None
                   else torch.as_tensor(sub, dtype=dtype, device=device))
    return cand, len(cand_np), sub, offsets


def _grid_refine(cur_lab, ref_lab, plan: RegionPlan, best_d, sub: np.ndarray,
                 offsets, coeff_mad: float, coeff_zncc: float):
    """Re-score each region at its integer winner plus each offset of
    ``sub`` ((n_sub, (dy, dx)); ``offsets`` the same on the device) and
    keep the best: every offset's bilinear taps lie in the integer cells
    floor(min sub) .. floor(max sub) + 1 around the winner, gathered once
    in label-sorted order; one range-sum pass reduces every offset's
    moment fields."""
    dt = cur_lab.dtype
    dev = cur_lab.device
    h, w, c = cur_lab.shape
    n_pix = h * w
    n_sub = sub.shape[0]
    perm = plan.perm
    d_pix = best_d[plan.labels]              # (H, W, (dy, dx)), integral
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    x_base = (xs + d_pix[..., 1].long()).reshape(-1)[perm]
    y_base = (ys + d_pix[..., 0].long()).reshape(-1)[perm]
    ref_flat = ref_lab.reshape(n_pix, c)
    cur_s = cur_lab.reshape(n_pix, c)[perm]
    ones = torch.ones((n_pix,), dtype=dt, device=dev)

    def g(yy, xx):
        # Zero-pad taps (get_zeropad), as in the integer search.
        ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(dt)
        yy = yy.clamp(0, h - 1)
        xx = xx.clamp(0, w - 1)
        return ref_flat[yy * w + xx] * ok[:, None]

    taps = range(int(np.floor(sub.min())), int(np.floor(sub.max())) + 2)
    nb = {(jy, jx): g(y_base + jy, x_base + jx) for jy in taps for jx in taps}
    fields_all = []
    for dy_f, dx_f in sub:
        iy = int(np.floor(dy_f))
        ix = int(np.floor(dx_f))
        fx = float(dx_f - ix)
        fy = float(dy_f - iy)
        interp = ((1 - fx) * (1 - fy) * nb[(iy, ix)]
                  + fx * (1 - fy) * nb[(iy, ix + 1)]
                  + (1 - fx) * fy * nb[(iy + 1, ix)]
                  + fx * fy * nb[(iy + 1, ix + 1)])
        fields_all.append(_moment_fields(cur_s, interp, ones))
    fs = torch.stack(fields_all, dim=1).reshape(n_pix, n_sub * 7)
    sums = _contiguous_range_sums(fs, plan.bounds)  # (n_regions, n_sub*7)
    mad, zncc, _ = _cost_from_sums(
        sums.view(plan.n_regions, n_sub, 7).transpose(0, 1))
    sub_costs = coeff_mad * mad - coeff_zncc * zncc   # (n_sub, n_regions)
    sbest = torch.argmin(sub_costs, dim=0)
    best_cost = sub_costs.gather(0, sbest[None, :])[0]
    return best_d + offsets[sbest], best_cost


def _argmin_and_refine(costs, cur_lab, ref_lab, plan: RegionPlan, tables,
                       coeff_mad: float, coeff_zncc: float,
                       method: str = "matmul"):
    """The scoring tail every evaluator shares: the argmin over the
    (possibly padding-trailed) cost table of ``method``'s candidates
    (``tables``: :func:`_search_tables`), then, for a coarse method, the
    zero re-seed of regions no coarse candidate scored (every cost inf, as
    a region with no pixel on the half-resolution grid), and the refine
    of :func:`_refine_offsets` -> (uv (n_regions, 2), cost)."""
    cand, n_cand, sub, offsets = tables
    costs = costs[:n_cand]
    best = torch.argmin(costs, dim=0)        # first minimum, as jnp.argmin
    best_cost = costs.gather(0, best[None, :])[0]
    best_d = cand[best].to(cur_lab.dtype)
    if is_coarse(method):
        best_d = torch.where(torch.isfinite(best_cost)[:, None], best_d, 0.0)
    if sub is not None:
        best_d, best_cost = _grid_refine(cur_lab, ref_lab, plan, best_d, sub,
                                         offsets, coeff_mad, coeff_zncc)
    return torch.stack([best_d[:, 1], best_d[:, 0]], dim=-1), best_cost


def match_chunk(method: str, chunk: int) -> int:
    """The candidates a chunk scores: at least 64 for the matmul methods."""
    return max(int(chunk), 64) if method.startswith("matmul") else int(chunk)


def _match_refs(cur_lab, refs, plan: RegionPlan, search_range, coeff_mad,
                coeff_zncc, subpixel_scale, chunk, method: str):
    """The search of ``cur_lab``'s regions against each of ``refs`` on the
    frames' device: one evaluator over every reference, then each one's
    argmin and refine. Returns [(uv (n_regions, 2), cost (n_regions,))]
    per reference, each equal to a single-reference search."""
    validate_method(method)
    search_range = int(search_range)
    chunk = match_chunk(method, chunk)
    tables = _search_tables(method, search_range, chunk,
                            int(subpixel_scale), plan.n_regions,
                            cur_lab.dtype, cur_lab.device)
    coeffs = (float(coeff_mad), float(coeff_zncc))
    costs = method_costs(method, cur_lab, refs, plan, tables[0],
                         search_range, *coeffs, chunk)
    return [_argmin_and_refine(c, cur_lab, ref, plan, tables, *coeffs,
                               method)
            for c, ref in zip(costs, refs)]


def _match_device(cur_lab, ref_lab, plan: RegionPlan, search_range,
                  coeff_mad, coeff_zncc, subpixel_scale, chunk,
                  method: str = "matmul"):
    """One direction's search on the frames' device; returns device
    tensors (uv (n_regions, 2), cost (n_regions,))."""
    return _match_refs(cur_lab, [ref_lab], plan, search_range, coeff_mad,
                       coeff_zncc, subpixel_scale, chunk, method)[0]


def _match_device_bidirectional(cur_lab, refp_lab, refn_lab,
                                plan: RegionPlan, search_range, coeff_mad,
                                coeff_zncc, subpixel_scale, chunk,
                                method: str = "matmul"):
    """Both directions' searches over one plan and one set of tables; the
    matmul methods share one evaluator over both references. Each
    direction equals its single-direction search. Returns ((uv_p,
    cost_p), (uv_n, cost_n))."""
    return tuple(_match_refs(cur_lab, [refp_lab, refn_lab], plan,
                             search_range, coeff_mad, coeff_zncc,
                             subpixel_scale, chunk, method))


def _result_from_host(uv, cost, lab_np) -> BlockMatchResult:
    uv = uv.cpu().numpy()
    cost = cost.cpu().numpy()
    return BlockMatchResult(
        u=uv[lab_np][..., 0], v=uv[lab_np][..., 1], cost=cost[lab_np],
        region_uv=uv, region_cost=cost)


def block_matching_labels(
    cur_lab: torch.Tensor,
    ref_lab: torch.Tensor,
    labels,
    n_regions: int,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
) -> BlockMatchResult:
    """Match every region of ``cur`` against ``ref`` on their device;
    vectors point from cur pixels toward their reference-frame position
    (inverse flow, like the reference's get_prev)."""
    plan = region_plan(labels, n_regions, cur_lab.device)
    uv, cost = _match_device(cur_lab, ref_lab, plan, search_range,
                             coeff_mad, coeff_zncc, subpixel_scale, chunk,
                             method)
    return _result_from_host(uv, cost, plan.host_labels)


def block_matching_bidirectional(
    cur_lab: torch.Tensor,
    prev_lab: torch.Tensor,
    next_lab: torch.Tensor,
    labels,
    n_regions: int,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
):
    """Bidirectional matching: returns (prev_result, next_result,
    t (H, W) in {-1, +1}) with t = -1 where the prev match wins
    (BlockMatching::get's Vector_ST time direction)."""
    plan = region_plan(labels, n_regions, cur_lab.device)
    d_prev, d_next = _match_device_bidirectional(
        cur_lab, prev_lab, next_lab, plan, search_range, coeff_mad,
        coeff_zncc, subpixel_scale, chunk, method)
    r_prev = _result_from_host(*d_prev, plan.host_labels)
    r_next = _result_from_host(*d_next, plan.host_labels)
    t = np.where(r_prev.cost <= r_next.cost, -1, 1).astype(np.int8)
    return r_prev, r_next, t
