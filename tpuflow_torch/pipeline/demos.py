"""The reference's pair demos as library entry points (port of
:mod:`tpuflow.pipeline.demos`).

Each mirrors one of the reference's demo binaries, with the same algorithm
parameters and the same output artifacts (SURVEY.md §2.1), and runs its
solver on ``device`` (the card unless the caller passes ``device="cpu"``)
in ``dtype`` (float32 by default, the kernels' dtype):

- :func:`demo_horn_schunck`   — HornSchunckOF (main.cpp:91-107, "hs"):
  5x5 window, 100 iterations, alpha 1 (``hs_sweeps``), u/v matrix text
  dumps + "<prefix>hsbresenhamLineFlow.png" quiver.
- :func:`demo_farneback_pair` — HornSchunckOF "fb" branch (main.cpp:
  108-121) and FarnebackOF (FarnebackOF.cpp:24-44): the demo
  parameterizations (``sep_conv2d_valid``, ``fb_poly_expansion``),
  matrix dumps / 10-px-grid overlay image.
- :func:`demo_lucas_kanade`   — LucasKanadeOF (LucasKanadeOF.cpp:50-114):
  corner seeding (``sep_conv2d_valid``), pair tracking and acceptance;
  returns the tracks and writes an overlay.

Frames are read and artifacts written on the host
(:mod:`tpuflow_torch.core.io`, the native codec for binary PNM, PIL for
PNG); quivers are drawn by the native rasterizer.

Note: the reference's HS-demo "fb" branch accidentally swaps u/v in its
plot call (main.cpp:119, SURVEY.md #2) — that bug is NOT reproduced; the
overlay here plots (u, v) in the correct order.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core.color import rgb_to_gray
from tpuflow_torch.core.io import read_image, write_image, write_matrix_txt
from tpuflow_torch.viz.quiver import (draw_tracks_cv, plot_quiver,
                                      plot_quiver_cv)


def _read_video_frames(video_path, frame_prev: int, frame_next: int):
    """Seek two frames of a video by index (the reference's mp4 branch,
    HornSchunckOF/main.cpp:54-60: ``capture.set(1, n); capture >> img``)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(
            f"Can't read the video. Please check the path: {video_path}")
    frames = []
    for n in (frame_prev, frame_next):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(n))
        ok, frame = cap.read()
        if not ok:
            cap.release()
            raise ValueError(f"Can't read frame {n} from {video_path}")
        frames.append(frame[..., ::-1].copy())  # BGR -> RGB
    cap.release()
    return frames


def _load_gray_pair(prev_path, next_path, video=None):
    if video is not None:
        prev, nxt = _read_video_frames(video, int(prev_path), int(next_path))
    else:
        prev, _ = read_image(prev_path)
        nxt, _ = read_image(next_path)
    if prev.shape != nxt.shape:
        raise ValueError("Image sizes are different. Please provide images "
                         "of same size.")  # main.cpp:69-72

    def gray(a):
        if a.ndim == 3:
            return _cvt_gray_fixed(a)
        return np.asarray(a, np.float64)

    return prev, nxt, gray(prev), gray(nxt)


def _cvt_gray_fixed(rgb: np.ndarray) -> np.ndarray:
    """BT.601 gray with OpenCV's fixed-point rounding.

    The reference demos preprocess with ``cvtColor(..., COLOR_BGR2GRAY)``
    (HornSchunckOF/main.cpp:11-26), whose 8-bit path is the shift-15
    fixed-point luma ``(9798 R + 19235 G + 3735 B + 2^14) >> 15`` — NOT
    float BT.601 rounded (the two differ on ~300 of 466k pixels per
    KITTI frame at .5 ties). Non-integral inputs (already-filtered floats)
    keep the float luma, computed in float64 on the host."""
    arr = np.asarray(rgb, np.float64)
    ints = np.rint(arr)
    if not (arr == ints).all():
        return rgb_to_gray(torch.from_numpy(arr)).numpy()
    r, g, b = (ints[..., i].astype(np.int64) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
            ).astype(np.float64)


def _on(device, dtype, *arrays):
    return [torch.as_tensor(np.asarray(a), dtype=dtype).to(device)
            for a in arrays]


def _host(*tensors):
    return [t.detach().cpu().numpy() for t in tensors]


def demo_horn_schunck(
    prev_path,
    next_path,
    save_prefix: str,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
    delta: int = 20,
    scale: float = 20.0,
    outlier: int = 5,
    video=None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """HornSchunckOF "hs": returns (u, v) as numpy arrays, writes
    uMatrixHS.txt / vMatrixHS.txt and the quiver overlay. With ``video``
    set, ``prev_path``/``next_path`` are frame indices into that clip
    (main.cpp:54-60)."""
    prev_raw, _, prev_g, next_g = _load_gray_pair(prev_path, next_path,
                                                  video=video)
    from tpuflow_torch.solvers import horn_schunck

    u, v = _host(*horn_schunck(*_on(device, dtype, prev_g, next_g),
                               window_size, max_iterations, alpha))
    write_matrix_txt(f"{save_prefix}uMatrixHS.txt", u, "u matrix")
    write_matrix_txt(f"{save_prefix}vMatrixHS.txt", v, "v matrix")
    quiver = plot_quiver(prev_raw, u, v, delta=delta, scale=scale,
                         outlier=outlier)
    write_image(f"{save_prefix}hsbresenhamLineFlow.png", quiver)
    return u, v


def demo_farneback_pair(
    prev_path,
    next_path,
    save_prefix: str,
    pyr_scale: float = 0.5,
    levels: int = 1,
    winsize: int = 64,
    iterations: int = 2,
    poly_n: int = 8,
    poly_sigma: float = 1.6,
    delta: int = 10,
    scale: float = 10.0,
    write_matrices: bool = False,
    video=None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """FarnebackOF pair demo (defaults = FarnebackOF.cpp:24); with
    ``write_matrices`` also dumps uMatrixFB/vMatrixFB (the HS demo's "fb"
    branch, whose parameters are (0.5, 3, 15, 3, 5, 1.2)). ``video``
    switches prev/next to frame indices (main.cpp:54-60). Returns (u, v)
    as numpy arrays."""
    prev_raw, next_raw, prev_g, next_g = _load_gray_pair(prev_path, next_path,
                                                         video=video)
    from tpuflow_torch.solvers import calc_optical_flow_farneback

    u, v = _host(*calc_optical_flow_farneback(
        *_on(device, dtype, prev_g, next_g), None, pyr_scale, levels,
        winsize, iterations, poly_n, poly_sigma))
    if write_matrices:
        write_matrix_txt(f"{save_prefix}uMatrixFB.txt", u, "u matrix")
        write_matrix_txt(f"{save_prefix}vMatrixFB.txt", v, "v matrix")
        # The HS-demo "fb" branch also draws the plotFlow-style overlay
        # on the PREV frame: plotBresenhamLine(v, u, 20, 300, 5)
        # (main.cpp:118-119 — the swapped argument order is CORRECT for
        # that plotter's row-first convention, unlike the "hs" branch).
        write_image(f"{save_prefix}fbbresenhamLineFlow.png",
                    plot_quiver(prev_raw, u, v, delta=20, scale=300.0,
                                outlier=5))
    # FarnebackOF.cpp:25-44 draws OpenCV-style on the NEXT frame: blue
    # thickness-1 cv::lines to cvRound'ed endpoints + radius-0 red dots
    # at the grid points (plot_quiver_cv replicates cv::line/cv::circle).
    quiver = plot_quiver_cv(next_raw, u, v, delta=delta, scale=scale,
                            line_color=(0, 0, 255), dot_color=(255, 0, 0),
                            dot_radius=0)
    write_image(f"{save_prefix}Farneback-{winsize}.png", quiver)
    return u, v


def demo_lucas_kanade(
    prev_path,
    next_path,
    save_path=None,
    max_count: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    min_motion: float = 2.0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """LucasKanadeOF pair demo: seed, track, accept; returns
    (points, new_points, accept_mask) as numpy arrays and optionally writes
    the reference's track overlay — red cv::lines from each accepted
    feature's initial to its tracked position + filled radius-3 green
    cv::circles at the tracked positions, drawn on the CURRENT (next)
    color frame (LucasKanadeOF.cpp:83-87)."""
    _, next_raw, prev_g, next_g = _load_gray_pair(prev_path, next_path)
    from tpuflow_torch.solvers import (
        accept_tracked_point,
        good_features_to_track,
        track_points,
    )

    prev_t, next_t = _on(device, dtype, prev_g, next_g)
    pts = good_features_to_track(prev_t, max_count, quality_level,
                                 min_distance)
    new_t, status = track_points(prev_t, next_t, pts)
    accept_t = accept_tracked_point(pts, new_t, status, min_motion)
    new_pts, accept = _host(new_t, accept_t)
    if save_path is not None:
        overlay = draw_tracks_cv(next_raw, pts[accept], new_pts[accept],
                                 line_color=(255, 0, 0),
                                 dot_color=(0, 255, 0), dot_radius=3)
        write_image(save_path, overlay)
    return pts, new_pts, accept


def main(argv=None) -> int:
    """``python -m tpuflow_torch.pipeline.demos {hs,fb,lk} prev next
    out_prefix [--video F] [--device D]`` — the demo binaries' command
    line."""
    import argparse

    p = argparse.ArgumentParser(prog="tpuflow_torch-demos")
    p.add_argument("algo", choices=["hs", "fb", "lk"])
    p.add_argument("prev", help="prev image path, or frame index with --video")
    p.add_argument("next", help="next image path, or frame index with --video")
    p.add_argument("out_prefix")
    p.add_argument("--video", default=None,
                   help="video file; prev/next become frame indices "
                        "(the reference's mp4 input branch)")
    p.add_argument("--device", default="cuda",
                   help="torch device the solver runs on (default cuda)")
    args = p.parse_args(argv)
    if args.algo == "hs":
        demo_horn_schunck(args.prev, args.next, args.out_prefix,
                          video=args.video, device=args.device)
    elif args.algo == "fb":
        demo_farneback_pair(args.prev, args.next, args.out_prefix,
                            video=args.video, device=args.device)
    else:
        demo_lucas_kanade(args.prev, args.next,
                          args.out_prefix + "lk_tracks.png",
                          device=args.device)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
