"""Sharded L1 image ops: the reference's ImgLibrary OpenMP sites over a
mesh of ranks (port of :mod:`tpuflow.dist.ops`).

``ImgLibrary.cpp`` parallelizes its filter loops with OpenMP row loops
(``Filterer``:445-447, ``Gaussian``:223-225, ``EpsilonFilter``:97-99);
here the frame is tiled over the (ty, tx) mesh, each tile takes a
kernel-radius halo from its neighbours
(:func:`~tpuflow_torch.dist.halo.halo_pad_2d`) and runs the same tile body
as the single-device op (:mod:`tpuflow_torch.ops.filters`), so the
results are the single-device bits. As the other sharded functions of
the port, each takes the full frame on every rank (on the mesh's device)
and returns the full result on every rank.

At the frame's border the halo carries zeros; for the other border
policies :func:`halo_pad_2d_border` re-points the out-of-frame halo rows
and columns at the policy's source (mirror, reflect101 and clamp sources
lie inside the border tile whenever the tile is at least the radius
wide). The median's one-sided window and the scratch test's side
windows follow GLOBAL columns.

:func:`hog_matching_sharded` splits the window's offsets over the ranks
in contiguous slices of tpuflow's order (padded with out-of-window
sentinels, never with duplicates: a duplicate would corrupt the
second-best distance); each rank scans its slice, the partial
best/second-best tables are all-gathered, and a merge in slice order
keeps the sequential scan's first-better-wins ties, so the result is the
single-device one bitwise.
"""

from __future__ import annotations

import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.core.config import (
    AVE_FAR,
    FILTER_ID_EPSILON,
    FILTER_ID_GAUSSIAN,
    MEAN_WIDTH,
)
from tpuflow_torch.detection.scratch import HALF, confirm, side_counts
from tpuflow_torch.dist.halo import (all_gather, gather_tiles, halo_pad_2d,
                                    tile_of)
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.features import hog as hog_mod
from tpuflow_torch.ops.filters import (
    _check_epsilon_size,
    _conv2d_valid,
    _taps,
    epsilon_window,
    gaussian_kernel,
    median_window,
)

_INDEX_FN = {
    bd.MIRROR: bd.mirror_index,
    bd.REFLECT101: bd.reflect101_index,
    bd.CLAMP: bd.clamp_index,
}


def _check(img: torch.Tensor, mesh: Mesh) -> tuple[int, int]:
    h, w = img.shape
    if h % mesh.ty or w % mesh.tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    return h, w


def halo_pad_2d_border(tile: torch.Tensor, r: int, mode: str, mesh: Mesh,
                       h: int, w: int) -> torch.Tensor:
    """(th + 2r, tw + 2r) tile padded with its neighbours' halos AND the
    frame's border policy: the tile's window of ``bd.pad2d(img, r,
    mode)``. The non-zero policies need tiles at least r wide."""
    p = halo_pad_2d(tile, r, mesh)
    if mode == bd.ZERO:
        return p
    idx = _INDEX_FN[mode]
    th, tw = tile.shape[-2:]
    row0, col0 = mesh.iy * th, mesh.ix * tw
    ar_y = torch.arange(th + 2 * r, device=tile.device)
    ar_x = torch.arange(tw + 2 * r, device=tile.device)
    ly = (idx(row0 - r + ar_y, h) - row0 + r).clamp(0, th + 2 * r - 1)
    lx = (idx(col0 - r + ar_x, w) - col0 + r).clamp(0, tw + 2 * r - 1)
    return p.index_select(-2, ly).index_select(-1, lx)


def conv2d_sharded(img: torch.Tensor, kernel, mesh: Mesh,
                   border: str = bd.ZERO, flip: bool = False,
                   anchor: tuple[int, int] | None = None) -> torch.Tensor:
    """Sharded :func:`tpuflow_torch.ops.filters.conv2d`: the same
    signature, flip/anchor semantics and tap order, the frame tiled over
    the mesh."""
    taps = _taps(kernel)
    kh, kw = taps.shape
    if flip:
        taps = taps[::-1, ::-1]
        if anchor is None:
            anchor = (kw - 1 - kw // 2, kh - 1 - kh // 2)
    if anchor is None:
        anchor = (kw // 2, kh // 2)
    ax, ay = anchor
    h, w = _check(img, mesh)
    r = max(ay, kh - 1 - ay, ax, kw - 1 - ax, 1)
    tile = tile_of(img, mesh)
    th, tw = tile.shape
    p = halo_pad_2d_border(tile, r, border, mesh, h, w)
    # conv2d's asymmetric pad (ay, kh-1-ay, ax, kw-1-ax) cut out of the
    # symmetric halo.
    p = p[r - ay : r - ay + th + kh - 1, r - ax : r - ax + tw + kw - 1]
    return gather_tiles(_conv2d_valid(p, taps), mesh)


def filterer_sharded(img: torch.Tensor, kernel, mesh: Mesh,
                     mirroring: bool = False) -> torch.Tensor:
    """Sharded reference ``Filterer`` (ImgLibrary.cpp:408-464, the OMP
    row loop at :445-447)."""
    return conv2d_sharded(img, kernel, mesh,
                          border=bd.MIRROR if mirroring else bd.ZERO,
                          flip=True)


def gaussian_filter_sharded(img: torch.Tensor, size_wh, sigma: float,
                            mesh: Mesh) -> torch.Tensor:
    """Sharded reference ``Gaussian`` (ImgLibrary.cpp:124-244, OMP at
    :223-225): the 2-D kernel of ``gaussian_kernel`` through
    :func:`conv2d_sharded`, zero borders (tpuflow's choice; the
    single-device ``gaussian_filter`` takes odd sizes separably)."""
    k = gaussian_kernel(size_wh, sigma, dtype=img.dtype)
    return conv2d_sharded(img, k, mesh, border=bd.ZERO, flip=False)


def epsilon_filter_sharded(img: torch.Tensor, size_wh, epsilon: float,
                           mesh: Mesh) -> torch.Tensor:
    """Sharded reference ``EpsilonFilter`` (ImgLibrary.cpp:58-121, OMP at
    :97-99): the single-device window sum on each halo'd tile."""
    _check_epsilon_size(size_wh)
    h, w = _check(img, mesh)
    fw, fh = size_wh
    w2, h2 = fw // 2, fh // 2
    r = max(w2, h2, 1)
    tile = tile_of(img, mesh)
    th, tw = tile.shape

    def cut(p):
        return p[r - h2 : r - h2 + th + fh - 1, r - w2 : r - w2 + tw + fw - 1]

    pz = cut(halo_pad_2d_border(tile, r, bd.ZERO, mesh, h, w))
    pm = cut(halo_pad_2d_border(tile, r, bd.MIRROR, mesh, h, w))
    return gather_tiles(epsilon_window(tile, pz, pm, size_wh, epsilon), mesh)


def horizontal_median_sharded(img: torch.Tensor, width: int,
                              mesh: Mesh) -> torch.Tensor:
    """Sharded :func:`tpuflow_torch.ops.filters.horizontal_median`
    (HorizontalMedian, ImgLibrary.cpp:8-55): the one-sided window shrink
    follows GLOBAL columns."""
    h, w = _check(img, mesh)
    lo, hi = width // 2, (width - 1) // 2
    r = max(lo, hi, 1)
    tile = tile_of(img, mesh)
    th, tw = tile.shape
    p = halo_pad_2d_border(tile, r, bd.ZERO, mesh, h, w)
    p = p[r : r + th, r - hi : r - hi + tw + lo + hi]
    return gather_tiles(median_window(p, mesh.ix * tw, width, w), mesh)


def hog_matching_sharded(feat_prv: torch.Tensor, feat_cur: torch.Tensor,
                         mesh: Mesh, search_w: int = 65, search_h: int = 65):
    """Sharded HOG matching (HOG_Matching, HOG_match.cpp:9-75; the OMP
    loop at :30-32). Returns (u, v, score) like
    :func:`tpuflow_torch.features.hog.hog_matching`, bitwise, on every
    rank."""
    h, w, _ = feat_prv.shape
    offs = hog_mod.match_offsets(search_w, search_h)
    n = mesh.size
    per = -(-len(offs) // n)
    sentinel = max(h, w) + 1  # outside every window: never selected
    offs = offs + [(sentinel, sentinel)] * (per * n - len(offs))
    k = mesh.iy * mesh.tx + mesh.ix
    carry = hog_mod.match_scan(feat_prv, feat_cur, offs[k * per:(k + 1) * per],
                               hog_mod.match_init(h, w, feat_prv))
    parts = all_gather(torch.stack(carry), mesh)
    d1, d2, bx, by = parts[0]
    for p1, p2, px, py in parts[1:]:
        # In slice order: an earlier slice keeps a tie (first better wins).
        better1 = p1 < d1
        d2 = torch.where(better1, torch.minimum(d1, p2),
                         torch.minimum(d2, p1))
        d1 = torch.where(better1, p1, d1)
        bx = torch.where(better1, px, bx)
        by = torch.where(better1, py, by)
    return bx, by, hog_mod.match_score(d1, d2)


def detect_scratch_sharded(img: torch.Tensor, mesh: Mesh, s_med: float = 3.0,
                           s_avg: float = 20.0, filter_param=None,
                           do_detection: bool = True):
    """Sharded DetectScratch (Detection.cpp:7-132, the OMP row loop at
    :95-97): sharded prefilter, horizontal median and side-average test,
    the decisions of :func:`tpuflow_torch.detection.scratch.
    detect_scratch`. The side sums add the halo'd row's taps in order
    (the single-device test differences prefix sums): the same sums, exact
    on integer-valued frames. Returns (scratch_map, filtered_img)."""
    h, w = _check(img, mesh)
    filtered = img
    if filter_param is not None:
        if filter_param.type == FILTER_ID_EPSILON:
            filtered = epsilon_filter_sharded(
                img, filter_param.size, filter_param.epsilon, mesh)
        elif filter_param.type == FILTER_ID_GAUSSIAN:
            filtered = gaussian_filter_sharded(
                img, filter_param.size, filter_param.std_deviation, mesh)
    if not do_detection:
        return filtered, filtered
    med = tile_of(horizontal_median_sharded(filtered, MEAN_WIDTH, mesh), mesh)
    tile = tile_of(filtered, mesh)
    th, tw = tile.shape
    r = AVE_FAR
    # A zero halo: the clamped side windows sum only in-frame pixels, and
    # the out-of-frame halo is exactly zero, so a fixed-tap sum over the
    # halo'd row is the shrunk window's sum.
    p = halo_pad_2d_border(tile, r, bd.ZERO, mesh, h, w)[r : r + th]
    l_sum = torch.zeros_like(tile)
    r_sum = torch.zeros_like(tile)
    for d in range(HALF + 1, AVE_FAR + 1):
        l_sum = l_sum + p[:, r - d : r - d + tw]
        r_sum = r_sum + p[:, r + d : r + d + tw]
    xs = mesh.ix * tw + torch.arange(tw, device=tile.device)
    l_cnt, r_cnt, _ = side_counts(xs, w)
    out = confirm(tile, med, l_sum, r_sum, l_cnt, r_cnt, float(s_med),
                  float(s_avg))
    return gather_tiles(out, mesh), filtered
