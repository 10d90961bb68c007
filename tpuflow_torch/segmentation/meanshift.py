"""Mean-shift segmentation over CIE-Lab (port of :mod:`tpuflow.segmentation.meanshift`).

The reference's flagship constructs ``Segmentation<Lab>(img, 20, 16/255)``
(OpticalFlow_BlockMatching.cpp:122-135). Every pixel is a point in joint
(x, y, L, a, b) space; each query moves to the mean of the original
points within a flat kernel (spatial radius ``kernel_spatial``, Lab
radius ``kernel_intensity``); pixels whose modes coincide within half a
kernel and touch form a region.

The filter (:func:`mean_shift_filter`) is the device half: on a CUDA
tensor one launch of ``csrc/ms_filter.cu`` runs every iteration, on a CPU
tensor its plain version runs (:mod:`tpuflow_torch.kernels.ms_filter`).
The labeling (:func:`_merge_labels`) is irregular graph work on small
data and runs on the host in the native C++ labeler
(:mod:`tpuflow_torch.native`), as tpuflow's does; its numpy and scipy
body stays as :func:`_merge_labels_plain`. The filter runs on the device
of the Lab tensor it is given.
:func:`mean_shift_filter_sharded` tiles the filter over a mesh of ranks
(:mod:`tpuflow_torch.dist`), each tile through the tile entry of the same
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpuflow_torch.kernels import ms_filter
from tpuflow_torch.utils.telemetry import record_span


def _color_sentinel(lab: torch.Tensor,
                    kernel_intensity: float) -> torch.Tensor:
    """Pad value for the frame borders, a 0-d tensor on ``lab``'s device:
    farther than ``kernel_intensity`` from EVERY real colour, so a point
    read outside the image fails the colour-radius test by construction
    (no validity mask). The offset is a Python scalar, rounded to
    ``lab``'s dtype as a 0-d tensor of it would be: no host-to-device
    copy, which would synchronise the stream."""
    return lab.abs().max() + (float(kernel_intensity) + 1.0)


@dataclass
class SegmentationResult:
    """The ``Segmentation<Lab>`` surface (host arrays)."""

    labels: np.ndarray          # (H, W) int32 region ids, 0..n_regions-1
    n_regions: int
    shift_spatial: np.ndarray   # (H, W, 2) converged (x, y) positions
    shift_color: np.ndarray     # (H, W, 3) converged Lab
    regions: list[np.ndarray] | None = None  # lazily built (N_i, 2) (x, y)

    def build_regions(self) -> list[np.ndarray]:
        """ref_regions(): per-region (x, y) pixel lists."""
        if self.regions is None:
            h, w = self.labels.shape
            ys, xs = np.mgrid[0:h, 0:w]
            flat = self.labels.reshape(-1)
            order = np.argsort(flat, kind="stable")
            pts = np.stack([xs.reshape(-1)[order], ys.reshape(-1)[order]], -1)
            counts = np.bincount(flat, minlength=self.n_regions)
            self.regions = list(np.split(pts, np.cumsum(counts)[:-1]))
        return self.regions


def mean_shift_filter(lab: torch.Tensor, kernel_spatial: int = 20,
                      kernel_intensity: float = 16.0 / 255.0,
                      iters: int = 8, margin: int | None = None,
                      with_drift: bool = False,
                      return_trajectory: bool = False):
    """Run ``iters`` mean-shift steps; returns (pos (H, W, 2) xy,
    color (H, W, 3)).

    ``lab`` is (H, W, 3) normalized Lab. ``margin`` bounds the tracked
    drift (defaults to ``kernel_spatial``): each step sweeps the full
    (2E+1)^2 square of offsets, E = kernel_spatial + margin, at every
    iteration, in row-major order — the function of tpuflow's Pallas
    kernel (``mean_shift_filter_pallas``).

    ``with_drift=True`` also returns the largest |pos - origin| of any
    query before any step (a 0-d tensor): positions are exact up to the
    first drift past the margin, so a largest drift within the margin
    certifies the run (:func:`segment_meanshift`'s ``margin="auto"``).
    ``return_trajectory=True`` also returns the (iters, H, W, 2) drift
    after each step. Both ride on the kernel's launch on the card.

    tpuflow's default jnp filter sweeps a banded disc instead and shrinks
    iteration 0's window to R. For every query whose drift stays within
    the margin the dropped offsets weigh exactly zero, so the two agree
    bitwise; they differ only for out-of-contract queries (drift >
    margin), where both windows are truncated.
    """
    return ms_filter.mean_shift_filter(lab, kernel_spatial, kernel_intensity,
                                       iters, margin, with_drift,
                                       return_trajectory)


def mean_shift_filter_sharded(lab: torch.Tensor, mesh,
                              kernel_spatial: int = 20,
                              kernel_intensity: float = 16.0 / 255.0,
                              iters: int = 8, margin: int | None = None):
    """:func:`mean_shift_filter` over a (ty, tx) mesh of ranks; returns the
    full (pos, color) on every rank.

    Every rank takes the full frame (on the mesh's device) and filters its
    tile: the window reads points within E = R + margin of a query's
    origin, so the tile halo'd by E (its neighbours' pixels, the colour
    sentinel outside the frame) makes the whole iteration loop tile-local
    (tpuflow's ``_ms_sharded_fn``). The sentinel is the largest |Lab| over
    the tiles (an all-reduce MAX, exact) plus the colour radius + 1, as the
    single-device filter's. The tiles then gather to every rank; the
    result is bitwise :func:`mean_shift_filter`'s.
    """
    import torch.distributed as dist

    from tpuflow_torch.dist.halo import all_reduce, gather_tiles, tile_of

    h, w = lab.shape[:2]
    if h % mesh.ty or w % mesh.tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    th, tw = h // mesh.ty, w // mesh.tx
    E = ms_filter.window(kernel_spatial, margin)
    if E > th or E > tw:
        raise ValueError("tile smaller than the shift window halo")
    planes = lab.permute(2, 0, 1)
    tile = tile_of(planes, mesh)
    sentinel = all_reduce(tile.abs().max().reshape(1), mesh,
                          dist.ReduceOp.MAX)[0] + (float(kernel_intensity)
                                                   + 1.0)
    row0, col0 = mesh.iy * th, mesh.ix * tw
    ys = torch.arange(row0 - E, row0 + th + E, device=lab.device)[:, None]
    xs = torch.arange(col0 - E, col0 + tw + E, device=lab.device)[None, :]
    outside = (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)
    lab_p = torch.where(outside, sentinel, tile_of(planes, mesh, E))
    pos, col = ms_filter.mean_shift_filter_tile(
        lab_p.permute(1, 2, 0).contiguous(), row0, col0, E, kernel_spatial,
        kernel_intensity, iters)
    return tuple(gather_tiles(f.permute(2, 0, 1).contiguous(), mesh)
                 .permute(1, 2, 0).contiguous() for f in (pos, col))


def _merge_labels(pos: np.ndarray, col: np.ndarray,
                  kernel_spatial: float, kernel_intensity: float,
                  min_size: int) -> tuple[np.ndarray, int]:
    """Host-side region formation: join 4-adjacent pixels whose modes are
    within half a kernel, then absorb regions smaller than min_size into
    their most-similar touching neighbour.

    Runs the native C++ union-find labeler
    (:func:`tpuflow_torch.native.label_regions`, tpuflow's
    ``tf_label_regions``), bit-identical to :func:`_merge_labels_plain`."""
    from tpuflow_torch import native

    return native.label_regions(pos, col, kernel_spatial, kernel_intensity,
                                min_size)


def _merge_labels_plain(pos: np.ndarray, col: np.ndarray,
                        kernel_spatial: float, kernel_intensity: float,
                        min_size: int) -> tuple[np.ndarray, int]:
    """Python :func:`_merge_labels` (tpuflow's ``_merge_labels_py``), the
    native labeler's plain version."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = pos.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    feats = np.concatenate([pos, col], axis=-1)  # (H, W, 5)

    rows, cols = [], []
    sp_th = (0.5 * kernel_spatial) ** 2
    cl_th = kernel_intensity**2
    for sl_a, sl_b in (
            ((slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
            ((slice(None), slice(0, w - 1)), (slice(None), slice(1, w)))):
        fa = feats[sl_a].reshape(-1, 5)
        fb = feats[sl_b].reshape(-1, 5)
        d_sp = ((fa[:, :2] - fb[:, :2]) ** 2).sum(-1)
        d_cl = ((fa[:, 2:] - fb[:, 2:]) ** 2).sum(-1)
        ok = (d_sp <= sp_th) & (d_cl <= cl_th)
        rows.append(idx[sl_a].reshape(-1)[ok])
        cols.append(idx[sl_b].reshape(-1)[ok])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = coo_matrix((np.ones(len(r)), (r, c)), shape=(h * w, h * w))
    n, lab = connected_components(g, directed=False)
    lab = lab.reshape(h, w)

    if min_size > 1:
        # Tiny-region absorption at region level: pixel sums, counts and
        # the region adjacency are computed once; the merge loop runs on
        # arrays of the region count.
        flat_lab0 = lab.reshape(-1)
        flat_col = col.reshape(-1, 3)
        counts = np.bincount(flat_lab0, minlength=n).astype(np.int64)
        col_sums = np.stack(
            [np.bincount(flat_lab0, weights=flat_col[:, c], minlength=n)
             for c in range(3)], axis=-1)
        eas, ebs = [], []
        for sl_a, sl_b in (
                ((slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
                ((slice(None), slice(0, w - 1)), (slice(None), slice(1, w)))):
            la = lab[sl_a].reshape(-1)
            lb = lab[sl_b].reshape(-1)
            m = la != lb
            eas.append(la[m])
            ebs.append(lb[m])
        ea = np.concatenate(eas + ebs)
        eb = np.concatenate(ebs + eas)
        edges = np.unique(ea.astype(np.int64) * n + eb)
        ea = (edges // n).astype(np.int64)
        eb = (edges % n).astype(np.int64)

        remap_total = np.arange(n)
        for _ in range(64):  # until no tiny region remains (or give up)
            is_tiny = (counts > 0) & (counts < min_size)
            if not is_tiny.any():
                break
            mean_col = col_sums / np.maximum(counts, 1)[:, None]
            sel = is_tiny[ea]
            pa, pb = ea[sel], eb[sel]
            if len(pa) == 0:
                break
            d = ((mean_col[pa] - mean_col[pb]) ** 2).sum(-1)
            order = np.lexsort((d, pa))      # grouped by tiny id, best first
            pa_s, pb_s = pa[order], pb[order]
            first = np.ones(len(pa_s), bool)
            first[1:] = pa_s[1:] != pa_s[:-1]
            src = pa_s[first]
            dst = pb_s[first]
            # Tiny-into-tiny merges only toward smaller ids: breaks the
            # a<->b swap cycles that would otherwise never terminate.
            keep = (~is_tiny[dst]) | (dst < src)
            src, dst = src[keep], dst[keep]
            if len(src) == 0:
                break
            remap = np.arange(n)
            remap[src] = dst
            for _ in range(8):  # resolve chains
                remap = remap[remap]
            counts_new = np.bincount(remap, weights=counts,
                                     minlength=n).astype(np.int64)
            col_sums = np.stack(
                [np.bincount(remap, weights=col_sums[:, c], minlength=n)
                 for c in range(3)], axis=-1)
            counts = counts_new
            remap_total = remap[remap_total]
            ea = remap[ea]
            eb = remap[eb]
            inner = ea != eb
            ea, eb = ea[inner], eb[inner]
            edges = np.unique(ea * n + eb)
            ea = edges // n
            eb = edges % n
        lab = remap_total[lab]
        uniq, lab = np.unique(lab, return_inverse=True)  # compact labels
        lab = lab.reshape(h, w)
        n = len(uniq)
    return lab.astype(np.int32), n


def _upsample_segmentation(labels, n, pos, col, s: int, h: int,
                           w: int) -> SegmentationResult:
    """Expand a 1/s-resolution segmentation to full resolution: labels
    nearest-replicated (each sample pixel stands for its s x s block),
    converged positions mapped back to full-resolution coordinates (x s)."""
    rep = lambda a: np.repeat(np.repeat(a, s, 0), s, 1)[:h, :w]  # noqa: E731
    return SegmentationResult(
        labels=np.ascontiguousarray(rep(labels)), n_regions=n,
        shift_spatial=rep(pos) * s, shift_color=rep(col))


def segment_meanshift_async(
    lab: torch.Tensor,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    min_size: int = 16,
    margin: int | str | None = None,
    scale: int = 1,
    mesh=None,
):
    """:func:`segment_meanshift` split into the device filter, launched
    now, and a zero-argument ``finalize`` that fetches its output and runs
    the host labeling. A caller may queue other device work in between;
    ``finalize`` waits for the filter's output only, so the labeling
    overlaps whatever of that work the card still has queued
    (optical_flow_block_matching queues the middle frame's search behind
    the new frame's filter, then labels while the card runs the search).

    ``scale > 1`` segments the stride-``scale`` subsampled frame with the
    spatial kernel and min_size scaled to match, then nearest-replicates
    the labels back (~scale^4 less filter work; not faithful to the
    reference's full-resolution segmentation). ``margin="auto"`` first
    filters with the margin R/2 and keeps that run only if its largest
    drift (``with_drift``, read back here) stays within it, else filters
    again at the full margin. ``mesh`` runs the filter tiled over the
    mesh's ranks (:func:`mean_shift_filter_sharded`; single-device
    ``scale`` and ``margin="auto"`` are refused there, as in tpuflow); every
    rank labels the same gathered filter output with the same host code,
    so every rank holds the same labels."""
    h0, w0 = lab.shape[:2]
    if scale > 1:
        if mesh is not None:
            raise ValueError("scale > 1 is single-device only")
        lab = lab[::scale, ::scale].contiguous()
        kernel_spatial = max(int(kernel_spatial) // scale, 1)
        min_size = max(int(min_size) // (scale * scale), 1)
    R = int(kernel_spatial)
    if mesh is not None:
        if margin == "auto":
            raise ValueError('margin="auto" is single-device only')
        pos, col = mean_shift_filter_sharded(lab, mesh, kernel_spatial,
                                             float(kernel_intensity), iters,
                                             margin)
    elif margin == "auto" and R > 2:
        m0 = max(R // 2, 1)
        pos, col, drift = mean_shift_filter(
            lab, kernel_spatial, float(kernel_intensity), iters, margin=m0,
            with_drift=True)
        if float(drift) > m0:  # host sync: the certificate decides
            pos, col = mean_shift_filter(lab, kernel_spatial,
                                         float(kernel_intensity), iters)
    else:
        pos, col = mean_shift_filter(
            lab, kernel_spatial, float(kernel_intensity), iters,
            None if margin in (None, "auto") else int(margin))
    ready = None
    if pos.is_cuda:
        # Copy the filter's output right behind it into pinned host
        # memory: finalize then waits for the filter, not for whatever
        # the caller queues after it.
        pos, col = (x.to("cpu", non_blocking=True) for x in (pos, col))
        ready = torch.cuda.Event()
        ready.record()

    def finalize() -> SegmentationResult:
        if ready is not None:
            with record_span("wait.filter"):
                ready.synchronize()
        pos_np = pos.numpy()
        col_np = col.numpy()
        labels, n = _merge_labels(pos_np, col_np, float(kernel_spatial),
                                  float(kernel_intensity), min_size)
        if scale > 1:
            return _upsample_segmentation(labels, n, pos_np, col_np, scale,
                                          h0, w0)
        return SegmentationResult(labels=labels, n_regions=n,
                                  shift_spatial=pos_np, shift_color=col_np)

    return finalize


def segment_meanshift(
    lab: torch.Tensor,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    min_size: int = 16,
    margin: int | str | None = None,
    scale: int = 1,
) -> SegmentationResult:
    """Full segmentation: the mean-shift filter on ``lab``'s device, then
    the host labeling. ``margin`` (an int, None for ``kernel_spatial``, or
    ``"auto"``) and ``scale``: see :func:`segment_meanshift_async`."""
    return segment_meanshift_async(lab, kernel_spatial, kernel_intensity,
                                   iters, min_size, margin, scale)()
