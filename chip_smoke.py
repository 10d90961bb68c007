#!/usr/bin/env python3
"""Drive tpuflow_torch's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one line of its own numbers:

1. device  — the card's name and power limit; TF32 off for the plain
   float32 references.
2. build   — builds the eight CUDA sources of ``tpuflow_torch/csrc`` (one
   nvcc each, all started together, into ``build/tpuflow_torch``) and
   reports seconds and ptxas usage (registers, spills), which the rows of
   ``hs_sweeps``, ``irls_sweeps``, ``irls_gated_sweeps``,
   ``hs_tile_sweeps``, ``irls_tile_sweeps``, ``sep_conv2d_valid`` and the
   resident pair log beside the blocks per SM that CUDA's occupancy
   calculator gives their launch.
3. kernels — each of the eleven ported kernels and the region matcher's
   sums (``bm_cost``) against its plain PyTorch version
   on the card, on float32 inputs from a numpy seed, with both versions'
   device times (``cuda_ms(..., device_only=True)``), the least time the
   card could take for the same work (``bound_ms``: the bytes over 3.35
   TB/s or the float32 operations over 67 TFLOP/s, whichever is larger)
   and, for sepconv and poly expansion, one ``F.conv2d`` computing the
   same function (``library_ms``; the port never calls it): HS 100 sweeps
   at 1080x1920 and IRLS 512 sweeps at 376x1240 (each at its main-path
   fuse and at a fuse that leaves a remainder) and both at 375x1242 (the
   ragged KITTI size), HS also at 3x3 there; IRLS 512 sweeps at fuse 16 at
   each level of BA's pyramid, where the launcher picks its staged tile
   per level (bitwise, launches counted, device ms per level); sepconv at
   1080x1920 with 48, 17, 15, 9, 3 and 48x15 taps, at 375x1242 with 64,
   and Lucas-Kanade's 3 taps at 376x1240 and 15 at 540x960 and 270x480
   (blocks per SM, registers and spills of the instantiation each runs:
   15, 48 and 64 have their count compiled in, the others take it at run
   time), 161 taps at 256x320 (from device memory) and 701 at 64x96 (the
   wide form, two launches; every row also in the kernels line's
   ``rows``); poly expansion with n = 8 (17 taps) at 1080x1920, 375x1242
   and 480x640, n = 5 (11 taps) at 1080x1920, 540x960 and 270x480 (both
   counts compiled in), n = 3 (7 taps, the count at run time), n = 40 (81
   taps, from device memory) at 256x320 and n = 500 at 16x32 (the wide
   form), with the blocks per SM, registers and spills of each row's
   instantiation (``poly_rows``, every row in the kernels line's
   ``rows``); blur-solve at 1080x1920 with winsize 48 (compiled in) and
   15 (run time), at 375x1242 with 64 (compiled in), 200 at 256x320 and
   640 at 48x64 (the wide form), likewise (``blur_rows``); each sepconv,
   poly and blur row also counts its launches (one, two in a wide form);
   the gated IRLS 256 sweeps at 376x1240 and 375x1242, fuse 16 and 15,
   one and two directions, on the flagship scene's own refine inputs; the
   mean-shift filter at R = 20 for one iteration at 376x1240 and eight on
   a 96x160 crop, in its wide form at
   R = 30 (E = 60, 2 iterations, 64x96) and R = 64 (E = 128, 1 iteration,
   32x48) on crops of the flagship frame, and the main path's eight at
   376x1240 timed, with the launcher's query rows per block, blocks per
   SM, registers and spills (``ms_rows``); the sharded solvers'
   tile sweeps on one whole-frame tile at origin (-need, -need) (HS 100
   sweeps at 2160x3840, fuse 5; IRLS 512 sweeps at 376x1240, fuse 16),
   each with a zero pad of (u, v) between launches, as a 1x1 mesh's halo
   exchange gives it, and again on a 2x2 cut at the tiles' frame origins,
   stitched, bitwise equal to hs_sweeps / irls_sweeps on the whole frame;
   the IRLS tile also at fuse 15 and at 375x1242, bitwise;
   the resident HS pair at 1080x1920, 100 sweeps (and 99, which ends in
   the other buffer), resident2 beside ``horn_schunck_fused``, with blocks
   per SM, registers and spills, and both bitwise in one launch each at
   windows 3, 5 and 65 (the wide form), at 1080x1920 and 375x1242, 100 and
   99 sweeps. Windows whose halo leaves no core in hs_stencil's staged
   tile, in the wide form (two launches a sweep): ``hs_sweeps`` at windows
   65 and 129 and ``hs_tile_sweeps`` on a 2x2 cut at 65, 3 sweeps at
   1080x1920, bitwise with their launch counts and ms per sweep. Blocks
   deeper than one launch takes, which the wrappers run as several
   launches: ``hs_sweeps`` and ``hs_tile_sweeps`` at window 5, fuse 16 at
   1080x1920 (and the tile's 2x2 cut against ``hs_sweeps``),
   ``irls_sweeps`` and ``irls_tile_sweeps`` at fuse 40 at 376x1240, the
   gated IRLS at fuse 40 with two directions; each bitwise its plain
   version, with its launch count. The sharded flagship's two tile
   entries (``phase_kernels_entries``): the gated tile entry on the four
   one tile of a one-rank mesh (the whole frame halo'd by the fuse, at
   (-fuse, -fuse); the shape phase dist (a) launches it at) and on the
   four tiles of a 2x2 cut of 376x1240 (GATED_SWEEPS sweeps, fuse
   DIST_GATED_FUSE, two directions, real label halos), bitwise its plain
   version on both and, stitched, the whole-frame gated kernel; the
   mean-shift tile entry at E = 40 (halos with the sentinel outside the
   frame) on the one-rank tile at MS_ITERS iterations and on the same
   cut at MS_TILE_ITERS, bitwise its plain version on both and, stitched
   at MS_ITERS, the whole-frame filter (timed); and the
   filter's drift and trajectory outputs at 376x1240 (MS_EXTRA_ITERS
   iterations), bitwise their plain
   version, pos and col bitwise the launch without them. Each with ms,
   bound, blocks per SM, registers, spills and launches. The region
   matcher's sums (``bm_cost_rows``): both directions of the Voronoi pan's
   middle frame at 376x1240, its BM_CELLS cells as labels, search 61,
   every float64 sum within SUM_RTOL of the plain version on the card and
   each direction's winners equal, the kernel's device ms beside
   ``bm_cost_bound`` (the float32-to-float64 conversions at 16 a clock per
   SM bind; the float64 adds, float32 operations and bytes logged beside
   them) and its share, the plain version's ms, the wrapper's ms (labels
   to the card, their sort, the two launches) and the launches.
4. main    — each main path runs once through the public entry points,
   with every launch counter set to 0 just before it and read just after;
   each counter must show its kernel ran exactly as often as that path
   launches it. The paths: ``solvers.horn_schunck`` at 1080x1920 (100
   iterations, 5x5, alpha 1) and again at window 65 (10 iterations, the
   wide form); ``optical_flow_pyramid_fast`` at 376x1240
   (5 levels, 512 sweeps per level, fuse 16); the four Farneback configs
   of bench.py (streaming, pair demo, multi-level demo on small and on
   large motion) through ``solvers.calc_optical_flow_farneback``; the
   streaming config again with ``use_blur_kernel=True``;
   ``pipeline.streaming.dense_flow_stream`` over SyntheticSource frames;
   and the flagship ``solvers.optical_flow_block_matching`` with its
   defaults (376x1240, search 61, mean-shift (20, 16/255), subpixel 2,
   2048 sweeps) over three frames in one ``BMFlowState``: pair 1 cold and
   unidirectional (two filter launches), pair 2 bidirectional (one),
   each with the gated kernel's launches as its refine counted them, and
   the same two pairs with ``profile="fast"`` and ``profile="turbo"``
   (BM_PROFILES; the coarse search, the analytic sup and the plateau
   stop; turbo segments the stride-2 frame); the
   resident HS pair's entry points at 1080x1920 (one launch each). The
   frames are bench.py's ``_frames_1080p``, ``_frames_kitti`` and
   ``_multioctave_frames``, and for the flagship a seeded pan over ~1,800
   shaded Voronoi cells (``voronoi_frames``).
5. hs, ba, fb, bm — the main-path results are finite, of the right shape,
   and agree with the same calls on float32 CPU copies (which take the
   plain versions); the BA block counts per level agree; end-to-end
   times on the card beside the chip host's CPU time, and one profiler
   frame each of the BA pyramid (its IRLS kernel time per frame, both
   stages) and of Farneback's demo3 at 1080x1920 (90 sepconv launches).
   The flagship
   reports its region count, the EPE of its block-matching field against
   the known pan, the compensation PSNR against the unmoved frame and ms
   per pair; its CPU check is the same three-frame run on a 96x160 crop
   (search 15, 256 sweeps): equal labels, region counts, BM winners and
   time directions, and u, v within PATH_TOL. The fast and turbo
   profiles report the same EPE, PSNR and ms per pair beside the
   default's, and take the same crop check. Each search evaluator
   (matcher.METHODS) runs single and fused bidirectional on pair 2's
   inputs at 376x1240, search 61 (ms per search, and the single search's
   EPE against the known pan beside its share of regions whose winner
   equals the exhaustive search's), and on BM_CROP at BM_CROP_SEARCH
   against the float32 CPU: equal winners, costs within EVAL_COST_TOL.
   The default pairs and each profile's launch ``bm_cost`` twice a pair
   (the sums, then the combine), and its row runs again on pair 2's own
   segmentation.
6. lk      — Lucas-Kanade, each path run once through its entry point
   with the counters zeroed just before and read just after (the launches
   join the main paths'): ``solvers.good_features_to_track(500, 0.01,
   10)`` on the KITTI frame (5 sepconv launches: the 3-tap gradients and
   Shi-Tomasi box sums) and ``solvers.track_points`` (window 21, 3
   levels, 30 iterations; no kernel) to the next frame, which shows the
   scene moved by LK_SHIFT; ``solvers.dense_lucas_kanade`` at 1080x1920
   (window 15, 3 levels, 3 iterations: 33 sepconv launches); and
   ``pipeline.streaming.feature_tracking_stream`` over TRACK_FRAMES
   SyntheticSource frames at 480x640 (5 launches a re-seed). Against the
   float32 CPU: the Shi-Tomasi response within an ulp of its square root
   (PyTorch's CPU float32 root is not always correctly rounded, the
   card's is), the same corner list, equal status and tracked points
   within LK_MEDIAN_TOL / LK_MAX_TOL px (the stream's within
   STREAM_MAX_TOL), dense LK on a 270x480 crop within PATH_TOL, the
   stream's accepted tracks equal; the median error against the known
   shift below LK_SHIFT_TOL; ms per call (host clock around a synced
   call); a profiler frame each of the tracking, dense LK and the stream.
7. affine  — ``solvers.multiple_motion_affine`` at 376x1240, 5 levels
   (no kernel), its flow at the frame centre along the known shift
   (AFFINE_ALONG, AFFINE_ACROSS) and a BM_CROP crop against the CPU
   within PATH_TOL; the flagship in mode AFFINE with its defaults over
   the Voronoi pan (pair 1 cold: two mean-shift launches, pair 2
   bidirectional: one; no gated sweep), EPE against the pan below
   AFFINE_EPE_TOL, the per-region fit ``affine_parametric_flow`` on a
   BM_CROP crop of pair 2's inputs against the CPU within PATH_TOL, ms
   per pair; ``pipeline.streaming.bm_flow_stream`` over the same three
   frames (default mode; its launches counted) bitwise equal to phase
   main's sequential pairs; a profiler frame each of the global fit and
   an AFFINE pair. Both phases and their counted main paths log their
   seconds.
8. demos   — the pair demos of ``tpuflow_torch.pipeline.demos`` from files
   to files (phase_demos): an 8-bit RGB scene at 375x1242 moved by
   DEMO_SHIFT, written as gray PGM, RGB PPM and RGB PNG; HS (5x5, 100
   iterations, alpha 1; ``hs_sweeps``), Farneback at FarnebackOF's
   config and, with its matrix dumps, at the HS demo's multi-level
   config (``sep_conv2d_valid``, ``fb_poly_expansion``), LK (500, 0.01,
   10, the 2-px accept rule; 5 sepconv launches), each counted as a main
   path, its files read back equal to what it returned (matrix dumps to
   u, v; each PNG to the same drawing made again from the returned
   arrays), against the same demo on the float32 CPU (u, v within
   PATH_TOL; LK's corners and accept mask equal), ms from file read to
   file written. Then the labeler row (``labeler_row``): the flagship's
   host labeling of its 376x1240 middle frame, the native C++ labeler
   against its scipy plain version, equal labels, ms each.
9. dist    — the sharded path (``tpuflow_torch.dist``) through
   ``run_on_mesh``. (a) One NCCL rank on the card, at world size 1 (the
   whole frame is one tile, the halos zeros):
   ``horn_schunck_sharded_fused`` and ``horn_schunck_sharded`` at
   2160x3840 (100 sweeps, 5x5, alpha 1, bench.py::bench_hs_4k's frames),
   ``optical_flow_pyramid_sharded`` (fuse 16) on the BA row's frames,
   ``weak_scaling_report`` at tile 512x1024 and the weak_scaling_1dev
   row's ``horn_schunck_sharded_fused_dynamic`` at 512x1024, fuse 10, 100
   and 300 sweeps (Mpix/s = 200 extra sweeps over the time difference),
   ``farneback_sharded`` at 1080x1920 (VideoDenseOF's config) and
   376x1240 (the HS demo's 3-level config; DIST_FB_CASES; the tiles on
   ``fb_poly_expansion`` and ``fb_blur_solve``), each with its launch
   counts and ms per frame, and one profiler frame each of the fused HS
   and the BA pyramid. ``farneback_sharded`` is held within PATH_TOL
   (bitwise expected) of the single-device call with
   ``use_blur_kernel=True`` (the same function), and its max|d| to the
   default single-device call and both single-device times logged. The fused HS equals the
   single-device ``horn_schunck`` bitwise, the unfused one is within
   PATH_TOL of it, and BA is within PATH_TOL of
   ``optical_flow_pyramid_fast`` with the same sweeps per level; all of
   them agree with the same calls on one float32 gloo CPU rank within
   PATH_TOL. (b) Four gloo ranks share the card as a 2x2 mesh (tiles at
   nonzero origins, real halos staged through the host): the same calls,
   HS bitwise equal to (a), BA within PATH_TOL with equal sweeps,
   ``farneback_sharded`` within PATH_TOL of (a); its times check the
   staged exchange and are no speed figure. Then the
   flagship with ``mesh=`` (``phase_dist_flagship``): (a) one NCCL rank,
   the three Voronoi frames at 376x1240 in the default mode, with
   ``profile="fast"`` and in mode AFFINE (DIST_BM_MODES), each pair's
   launches counted (the tile entries), ms per pair and a profiler frame
   of pair 2; labels and BM winners equal the single-device runs of the
   same calls, u, v bitwise theirs in the default mode and in AFFINE
   (Lab is converted on one CPU thread in every process, so a one-rank
   mesh runs the single-device arithmetic; the fast profile's refine
   stops by its plateau test at the
   fused-block cadence, sweeps 64, 128, ..., where the single-device one
   checks after sweeps 1, 65, ..., so its flow is only reported against
   it); (b) four gloo ranks sharing the card as a 2x2 mesh, the default
   mode: every rank's output equal, labels and winners equal (a)'s, u, v
   within PATH_TOL. The sharded L1 ops of ``dist/ops.py`` at 376x1240 on
   (a) and (b), each bitwise its single-device counterpart on the card
   (timed beside it): ``epsilon_filter_sharded`` (21x21, epsilon 20),
   ``horizontal_median_sharded``, ``gaussian_filter_sharded`` (21x21,
   sigma 5) against ``conv2d`` of its 2-D kernel, ``detect_scratch_sharded``
   on the integer-valued scratch frame, ``hog_matching_sharded`` (65x65)
   on the pan's dense HOG. Then ``run_pipeline`` with ``devices=1`` (one
   NCCL rank spawned once for the sequence) over phase pipeline's three
   flagship frames: its files byte for byte those of ``devices=0``.
10. pipeline — runs between demos and dist: the reference's main program
   through the port's CLI in-process on the card
   (``tpuflow_torch.cli.parser.main([..., "--device", "cuda:0"])``), from
   files of BM_SHAPE to files (PIPE_MODES): scratch detection with the
   alignments, ``--exclusive`` and ``--superimpose red``; ``--binary``,
   also with the 21x21 Gaussian prefilter; ``--filtered`` with the
   epsilon and the Gaussian filter; ``--HOG``; ``--HOG_matching_vector``
   over two frames; ``--multiple_affine``; ``--opticalflow_blockmatching``
   and ``--affine_blockmatching`` over three frames (the middle frame
   bidirectional). Inputs: gray PGM scratch frames, the Voronoi pan as
   gray PGM and RGB PPM. Each mode runs with the launch counts zeroed
   just before and read just after (they join the main paths'): #3 one a
   Gaussian frame, the flagship modes #11 and #8 as the same frames'
   direct calls of the flagship launch them (whose outputs they equal
   bitwise).
   Every file read back equals what ``process_frame`` returned for it.
   The port's telemetry spans give each stage's wall ms (the alignment
   ray scan, the exclusive principle, the Pr tables, HOG, its matching,
   the flagship).
   The same modes on BM_CROP against the float32 CPU (the flagship there
   at BM_CROP_SEARCH, mean-shift kernel PIPE_CROP_KERNEL, PIPE_CROP_ITERS
   sweeps): scratch maps and segment lists equal (a difference is
   reported pixel by pixel, or by the angles that differ, before it
   fails), filtered frames, HOG and the affine fit within PATH_TOL, HOG
   u, v equal, the flagship's labels, winners and t equal and u, v within
   PATH_TOL. Each mode logs ms per frame from file read to files written
   and one profiler frame (its last frame again): the card's busy and
   idle. Then #3 at the prefilter's
   21x21 taps on 376x1240 against its plain version, with its bound and
   one ``F.conv2d``.

Before the last line it prints the total seconds and the kernels as JSON;
the last line is ``{"ok": true, "device": {...}}``. A failed phase
raises: the script exits non-zero and prints no ``ok`` line. Without a
CUDA card it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

HS_SHAPE = (1080, 1920)
HS_ITERS, HS_WINDOW, HS_ALPHA = 100, 5, 1.0
BA_SHAPE = (376, 1240)
BA_LEVEL, BA_ITER_MAX, BA_FUSE = 5, 512, 16
RAGGED_SHAPE = (375, 1242)
# The sharded path: bench.py::bench_hs_4k's frame and sweeps, the fused
# solver's default fuse (tpuflow's), the weak-scaling row (bench.py:588-634)
# and the 2x2 mesh of gloo ranks sharing the card.
HS4K_SHAPE = (2160, 3840)
DIST_HS_FUSE = 5
WEAK_TILE, WEAK_FUSE, WEAK_ITERS = (512, 1024), 10, (100, 300)
DIST_GLOO_RANKS, DIST_CPU_THREADS, DIST_TIMEOUT_S = 4, 8, 900.0
# Farneback (pyr_scale, levels, winsize, iterations, poly_n, poly_sigma),
# bench.py:207-248, each with its frames.
FB_STREAM = (0.4, 1, 48, 2, 8, 1.2)   # DenseFlow.cpp:37
FB_DEMO = (0.5, 1, 64, 2, 8, 1.6)     # FarnebackOF.cpp:24
FB_DEMO3 = (0.5, 3, 15, 3, 5, 1.2)    # HornSchunckOF/main.cpp:111
FB_CASES = (("stream_1080p", FB_STREAM, "1080p"),
            ("demo_kitti", FB_DEMO, "kitti"),
            ("demo3_1080p", FB_DEMO3, "1080p"),
            ("demo3_largemotion_1080p", FB_DEMO3, "largemotion"))
# The config whose frame phase fb profiles: the most sepconv launches.
FB_PROFILED = "demo3_1080p"
# dense_flow_stream: SyntheticSource frames at the demo's working size.
STREAM_FRAMES, STREAM_WH = 4, (640, 480)
# The flagship (optical_flow_block_matching's defaults) on a pan of
# shaded Voronoi cells: cell count, pan per frame (dy, dx), noise per
# frame (the third noisier, so the middle frame's two directions never
# tie); the CPU check's crop, search range and sweeps; the kernel rows'
# sweeps and crop.
BM_SHAPE, BM_CELLS, BM_PAN = (376, 1240), 1800, (2, 5)
BM_NOISE = (1.0, 1.0, 2.5)
BM_CROP = (slice(100, 196), slice(400, 560))
BM_CROP_SEARCH, BM_CROP_ITERS = 15, 256
GATED_SWEEPS, GATED_FUSE = 256, 16
# The flagship's other profiles (bm_flow.PROFILES), run beside the default
# on the same frames, and the search evaluators (matcher.METHODS), each on
# pair 2's inputs at full size and held against the float32 CPU on BM_CROP
# (search BM_CROP_SEARCH): equal winners, costs within EVAL_COST_TOL x
# max(1, |cost|) (float64 sums of the same float32 fields in two devices'
# orders; the bf16 method rounds the same fields the same way on both).
BM_PROFILES = ("fast", "turbo")
EVAL_COST_TOL = 1e-9
# The pair demos (tpuflow_torch.pipeline.demos) from files to files at the
# KITTI size, at the reference's parameters: HS 5x5, 100 iterations, alpha
# 1 (HornSchunckOF "hs"); Farneback at FB_DEMO and, with its matrix dumps,
# at FB_DEMO3 (the HS demo's "fb" branch); LK (500, 0.01, 10) and the
# 2-px accept rule (LucasKanadeOF). An 8-bit RGB scene whose next frame
# is moved by DEMO_SHIFT (dx, dy) px, written as a gray PGM (hs), RGB PPM
# (fb) and RGB PNG (the fb matrices branch and lk). The labeler row: the
# flagship's host labeling (min_size 16) on its 376x1240 middle frame.
DEMO_SHAPE, DEMO_SHIFT = RAGGED_SHAPE, (2, 1)
DEMO_LK = (500, 0.01, 10.0, 2.0)
LABEL_MIN_SIZE = 16
# farneback_sharded on the meshes of phase dist: VideoDenseOF's config at
# 1080x1920 and the HS demo's multi-level config at 376x1240.
DIST_FB_CASES = (("stream_1080p", FB_STREAM, "1080p"),
                 ("demo3_kitti", FB_DEMO3, "kitti"))
# The sharded refine's fuse (tpuflow's default), the sweeps of the gated
# tile row on the 2x2 cut, the mean-shift tile row's iterations, and the
# iterations of the filter's drift and trajectory outputs at 376x1240
# (the plain version takes ~1.5 s an iteration there; by the third some
# queries have stopped, so the trajectory's repeated tail is held too).
DIST_GATED_FUSE = 8
MS_TILE_ITERS, MS_EXTRA_ITERS = 1, 3
# Lucas-Kanade with LucasKanadeOF's settings (LucasKanadeOF.cpp:50-114):
# goodFeaturesToTrack(500, 0.01, 10) and calcOpticalFlowPyrLK (window 21,
# 3 levels, 30 iterations) on the KITTI frames, whose next frame is the
# scene moved by LK_SHIFT (x, y); dense LK at 1080x1920 with its defaults
# (window 15, 3 levels, 3 iterations), held against the CPU on a crop;
# feature_tracking_stream over SyntheticSource frames at VideoFeaturesOF's
# working size (frames, (h, w), (dx, dy) per frame: |dx| + |dy| well past
# the acceptance rule's 2 px). Card vs float32 CPU: the same corners, the
# same status, tracked points within LK_MEDIAN_TOL (median) and LK_MAX_TOL
# (max) px, the stream's within STREAM_MAX_TOL: a point whose step^2 sits
# near eps^2 (0.01 px) can take one Newton step more or fewer when the two
# devices sum a window in other orders, and a coarse level's difference
# doubles per finer level. Measured on the H100: median 0 for both, max
# 6.3e-5 px (KITTI) and 1.1e-3 px (the stream); each limit is ~10x that.
# The tracks' median error against the known KITTI shift: below
# LK_SHIFT_TOL px (measured 6.5e-5).
LK_CORNERS = (500, 0.01, 10.0)
LK_TRACK = dict(win=21, max_level=3, iters=30)
LK_SHIFT, LK_SHIFT_TOL = (-2.0, -4.0), 1e-3  # median error, px
DENSE_LK = dict(win=15, levels=3, iters=3)
DENSE_LK_CROP = (slice(0, 270), slice(0, 480))
TRACK_FRAMES, TRACK_HW, TRACK_SHIFT = 5, (480, 640), (3.0, -2.0)
LK_MEDIAN_TOL, LK_MAX_TOL, STREAM_MAX_TOL = 1e-5, 1e-3, 1e-2
# multiple_motion_affine at the KITTI frames, 5 levels (MultipleMotionParam's
# default), held against the CPU on BM_CROP of them; the flagship in mode
# AFFINE with its defaults on the Voronoi pan, its per-region fit held
# against the CPU on BM_CROP of pair 2's inputs. The reference's omega =
# 1e-4 descent recovers only part of a translation in its iteration
# budget (tpuflow's tests/test_affine.py), so the global fit is held to
# the known shift's direction: its flow at the frame centre, projected on
# the shift, within AFFINE_ALONG of the shift's length, and at most
# AFFINE_ACROSS px across it (measured: 0.51 of it, 0.011 px across). The
# AFFINE flagship's composed flow: EPE against the pan below
# AFFINE_EPE_TOL px (measured 0.237 and 0.024 px).
AFFINE_LEVEL = 5
AFFINE_ALONG, AFFINE_ACROSS, AFFINE_EPE_TOL = (0.25, 1.0), 0.1, 0.5
AFFINE_PROFILED = 256
# The main program (phase pipeline): the CLI over files of BM_SHAPE; the
# scratch frames' scratches, vertical ones at PIPE_SCRATCH_COLS over rows
# PIPE_SCRATCH_ROWS and a slanted one over PIPE_SLANT_ROWS (shares of the
# frame; a full-height vertical scratch gives ~1,300 segments, and the
# exclusive principle's host pass takes ~25 s on them: the search's cost
# follows the segments); the HOG and
# flagship modes over the Voronoi pan (gray PGM and RGB PPM); each mode's
# frames. The same modes on BM_CROP against the float32 CPU.
PIPE_SCRATCH_COLS, PIPE_SCRATCH_ROWS = (0.25,), (0.4, 0.6)
PIPE_SLANT_ROWS = (0.1, 0.8)
PIPE_MODES = (  # name, inputs, (start, end), CLI options, output extension
    ("scratch", "scr", (0, 0), ["--exclusive", "--superimpose", "red"],
     ".ppm"),
    ("binary", "scr", (0, 1), ["--binary"], ".pgm"),
    ("binary_gaussian", "scr", (0, 1), ["--binary", "--filter_type",
                                        "gaussian"], ".pgm"),
    ("filtered_epsilon", "scr", (0, 0), ["--filtered", "--filter_type",
                                         "epsilon"], ".pgm"),
    ("filtered_gaussian", "scr", (0, 1), ["--filtered", "--filter_type",
                                          "gaussian"], ".pgm"),
    ("hog", "pan", (0, 0), ["--HOG"], ".bin"),
    ("hog_matching", "pan", (0, 1), ["--HOG_matching_vector"], ".bin"),
    ("multiple_affine", "pan", (0, 1), ["--multiple_affine"], ".txt"),
    ("opticalflow_bm", "rgb", (0, 2), ["--opticalflow_blockmatching"],
     ".dat"),
    ("affine_bm", "rgb", (0, 2), ["--affine_blockmatching"], ".dat"),
)
PIPE_GAUSS_TAPS = 21  # FilterParam.change_filter("gaussian"): 21x21
BM_CROP_SHAPE = (96, 160)  # BM_CROP's
# optical_flow_block_matching's default sweeps; see dist_pipeline.
DIST_PIPE_ITERS = 2048
# The flagship modes on the crop: mean-shift kernel and refine sweeps
# (the CPU's plain filter at kernel 20 takes ~30 s a mode there).
PIPE_CROP_KERNEL, PIPE_CROP_ITERS = 8, 64
# Blocks deeper than one launch of the kernel takes (HS at window 5: 15;
# the IRLS kernels: 35), which the wrappers split into launches.
DEEP_HS_FUSE, DEEP_IRLS_FUSE = 16, 40
# Windows whose halo leaves no core in hs_stencil's staged tile, which the
# wrappers run in the wide form (two launches a sweep): the kernel checks'
# sweeps and the solver's iterations at them.
WIDE_WINDOWS, WIDE_SWEEPS, WIDE_ITERS = (65, 129), 3, 10
# sepconv's rows (output shape, nky, nkx): Farneback's box (48 stream,
# 15 demo3's winsize, 64 demo; counts compiled in) and, through the
# instantiation that takes the count at run time, demo3's pyramid blur of
# the full frame (3 and 9 taps), the poly taps (17) and a mixed pair; then
# Lucas-Kanade's: the 3-tap gradients and Shi-Tomasi box at 376x1240, the
# tracking stream's at 480x640, dense LK's gradients at its three levels
# (1080x1920 above) and its 15-tap box at the two coarser ones.
SEP_TAPS = ((HS_SHAPE, 48, 48), (HS_SHAPE, 17, 17), (HS_SHAPE, 15, 15),
            (RAGGED_SHAPE, 64, 64), (HS_SHAPE, 9, 9), (HS_SHAPE, 3, 3),
            (HS_SHAPE, 48, 15), (BA_SHAPE, 3, 3), (TRACK_HW, 3, 3),
            ((540, 960), 3, 3), ((270, 480), 3, 3), ((540, 960), 15, 15),
            ((270, 480), 15, 15))
# ... and past the kernel's parameter struct (161 taps, from device
# memory) and past its staged tile (701 taps, the wide form, two launches),
# on small frames.
SEP_WIDE_TAPS = (((256, 320), 161, 161), ((64, 96), 701, 701))
# The resident pair's bitwise checks: windows, frames and sweeps.
RESIDENT_WINDOWS, RESIDENT_ITERS = (3, 5, 65), (HS_ITERS, HS_ITERS - 1)
# The flagship's mean-shift filter: R, colour radius and iterations
# (segmentation/meanshift.py's defaults).
MS_R, MS_KI, MS_ITERS = 20, 16.0 / 255.0, 8
# Mean-shift windows past the staged form (crop of the flagship's middle
# frame from BM_CROP's corner, R, iterations; the default margin): E = 60
# and E = 128 (past the staged form's packed row sums too).
MS_WIDE = (((64, 96), 30, 2), ((32, 48), 64, 1))
# Poly expansion's rows (output shape, poly_n, poly_sigma): poly_n 8 (17
# taps, compiled in) at the FB stream's 1080x1920, the demo's size (the
# ragged 375x1242) and dense_flow_stream's 480x640; poly_n 5 (11 taps,
# compiled in) at demo3's three pyramid levels of 1080x1920; poly_n 3
# (7 taps) through the instantiation with the count at run time.
POLY_CASES = ((HS_SHAPE, 8, 1.2), (HS_SHAPE, 5, 1.2), (RAGGED_SHAPE, 8, 1.6),
              ((480, 640), 8, 1.2), ((540, 960), 5, 1.2),
              ((270, 480), 5, 1.2), (HS_SHAPE, 3, 1.1))
# ... and past the parameter struct (n = 40, 81 taps from device memory)
# and past the staged tile (n = 500, 1,001 taps: the wide form), on small
# frames.
POLY_WIDE_CASES = (((256, 320), 40, 6.4), ((16, 32), 500, 75.0))
# Blur-solve's rows (output shape, winsize): the FB stream's 48 at
# 1080x1920 and the demo's 64 at 375x1242 (both compiled in), 15 at
# 1080x1920 (the run-time winsize), 200 (run time, past the parent
# kernel's shared-memory ceiling) and 640 (the wide form, two launches) on
# small frames. BLUR_AB: the rows the parent's kernel also takes.
BLUR_CASES = ((HS_SHAPE, 48), (RAGGED_SHAPE, 64), (HS_SHAPE, 15),
              ((256, 320), 200), ((48, 64), 640))
BLUR_AB = BLUR_CASES[:3]
# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
# The H100 SXM's SMs and boost clock, and what one SM does a clock
# (NVIDIA's CUDA programming guide, compute capability 9.0): 16
# float32-to-float64 conversions, 64 float64 adds. bm_cost_bound's terms.
SMS, BOOST_HZ = 132, 1.98e9
CVT_F64_PER_CLK, ADD_F64_PER_CLK = 16, 64
# The region matcher's sums (kernels/bm_cost) against their plain version
# on the card: float64 sums of the same float32 fields in two orders.
SUM_RTOL = 1e-12
# Tolerances, as max|d| <= TOL * max(1, max|reference|).
# Kernel vs its plain version on the card: both compute in float32 and
# round after every operation (the kernels are built with -fmad=false and
# sum in the plain versions' order), so they agree to the last bit on the
# H100 (measured max|d| = 0); the bound admits last-bit differences only.
KERNEL_TOL = 1e-6
# The card's main path vs the same call on float32 CPU copies: the plain
# PyTorch ops of the pyramid and the energy checks run on two devices'
# libraries. Measured on the H100: 0 for HS, 1.7e-6 for BA (|u| <= 0.25).
# Farneback has no reduction on its path, only elementwise ops, gathers
# and the kernels.
PATH_TOL = 1e-5


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def max_err(pairs) -> tuple[float, float]:
    """(max |a - b| over all pairs, max |b|)."""
    err = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in pairs)
    ref = max(float(b.abs().max()) for _, b in pairs)
    return err, ref


def check_close(name: str, pairs, tol: float) -> float:
    err, ref = max_err(pairs)
    bound = tol * max(1.0, ref)
    if not err <= bound:
        raise AssertionError(f"{name}: max|d|={err} > {bound} "
                             f"(max|ref|={ref})")
    return err


def cuda_ms(fn, reps: int = 5, device_only: bool = False) -> float:
    """Median time of fn() in ms between CUDA events, after one warm-up.

    By default the events bracket the call as its caller sees it, the
    host's launch overhead included (end-to-end times). With
    ``device_only`` the stream first spins (``torch.cuda._sleep``) for
    longer than the warm-up took on the host, so fn's launches are queued
    before the start event fires and the events time the device's work
    alone (kernel times: a single launch of ~0.1 ms is otherwise timed
    with the wrapper's Python in front of it).
    """
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Cycles of a spin that outlasts the host's enqueue (< 3 GHz clock).
    spin = int(3e9 * (time.perf_counter() - t0)) + 1_000_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 1) -> float:
    """Median host-clock time of fn() in ms (CPU reference runs)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: each input byte read and each
    output byte written once at the HBM rate, or the float32 operations
    at the peak rate, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Operation counts: the float32 adds, multiplies, divisions and square
# roots each kernel's plain version performs (each counted as one), for
# the call the row times.


def hs_bound(shape, sweeps, window):
    # Per pixel and sweep: two separable box sums ((W-1) + (W-1) adds and
    # the 1/W^2 multiply each), the update (5) and the two corrections (4).
    px = shape[0] * shape[1]
    per = 2 * (2 * (window - 1) + 1) + 9
    return bound(8 * 4 * px, px * sweeps * per)


def resident_bound(shape, sweeps, window, recip):
    # hs_bound's 27 per pixel and sweep; dividing every sweep adds the
    # denominator's 4, the reciprocal once costs 5 per pixel. Bytes: gx,
    # gy, gt read and u, v written once.
    px = shape[0] * shape[1]
    per = 2 * (2 * (window - 1) + 1) + 9 + (0 if recip else 4)
    return bound(5 * 4 * px, px * (sweeps * per + (5 if recip else 0)))


def irls_bound(shape, sweeps):
    # Per pixel: the data term (4) and its psi (5: x^2, s + x^2, d^2,
    # x * 2s and the division, 2s being one constant per launch),
    # lambda_d * psi once and its products with gx and gy (3), and for each
    # of u and v the smoothness product, the sum, the division by sup and
    # the subtraction (8). Per edge between two pixels in the frame, for
    # each of u and v: the difference, psi (5), the add at one end and the
    # subtraction at the other (8): the term is antisymmetric, so the
    # function needs it once per edge, not once per direction.
    h, w = shape
    edges = h * (w - 1) + (h - 1) * w
    return bound(7 * 4 * h * w, sweeps * (20 * h * w + 16 * edges))


def sep_bound(hp, wp, nky, nkx):
    ho, wo = hp - nky + 1, wp - nkx + 1
    ops = ho * wp * (2 * nky - 1) + ho * wo * (2 * nkx - 1)
    return bound(4 * (hp * wp + ho * wo), ops)


def poly_bound(hp, wp, k, ginv):
    # Three row passes, six column passes, then each output row of G^-1
    # over its nonzero coefficients.
    ho, wo = hp - k + 1, wp - k + 1
    combine = sum(2 * int(np.count_nonzero(r)) - 1 for r in ginv
                  if np.count_nonzero(r))
    ops = (3 * ho * wp + 6 * ho * wo) * (2 * k - 1) + ho * wo * combine
    return bound(4 * (hp * wp + 5 * ho * wo), ops)


def blur_bound(hp, wp, win):
    # Five box sums (rows, columns, the 1/win^2 multiply), then the 2x2
    # solve (det 3, u 4, v 4).
    ho, wo = hp - win + 1, wp - win + 1
    ops = 5 * (ho * wp * (win - 1) + ho * wo * win) + 11 * ho * wo
    return bound(4 * (5 * hp * wp + 2 * ho * wo), ops)


def gated_bound(labels: np.ndarray, sweeps, batch):
    # Per pixel: the data term and psi (10), its norm (4), the two updates
    # (12). Per edge between two pixels in the frame and in the same region
    # (as this label map has them): the cosine and weight once (9; the
    # norms are their pixels' own, already counted), and for each of u and
    # v the difference, psi and weight (8), the add at one end and the
    # subtraction at the other (2): the term is antisymmetric, so the
    # function needs it once per edge, not once per direction.
    px = labels.size
    edges = (int((labels[:, 1:] == labels[:, :-1]).sum())
             + int((labels[1:] == labels[:-1]).sum()))
    ops = sweeps * batch * (26 * px + 29 * edges)
    return bound(4 * px * (5 * batch + 3), ops)


def bm_cost_bound(n_pix, n_cand, n_ref, n_regions):
    # Per evaluation (pixel, candidate, reference): the L1 field (3
    # subtractions, 2 adds, 1 multiply; the absolute values are operand
    # modifiers) and b*b, a*b (2): 8 float32 operations; 4 conversions to
    # float64 and 4 float64 adds. Bytes: the planar frames (3 floats a
    # pixel and frame), the sort (8 a pixel) read once, the float64 table
    # written once. The conversions bind: 16 a clock per SM.
    evals = n_pix * n_cand * n_ref
    terms = {"conversions_ms": 4 * evals / (SMS * CVT_F64_PER_CLK * BOOST_HZ),
             "f64_adds_ms": 4 * evals / (SMS * ADD_F64_PER_CLK * BOOST_HZ),
             "f32_ops_ms": 8 * evals / PEAK_F32_PER_S,
             "bytes_ms": (4 * 3 * (n_ref + 1) * n_pix + 8 * n_pix
                          + 8 * n_regions * 4 * n_ref * n_cand)
             / PEAK_BYTES_PER_S}
    terms = {k: 1e3 * v for k, v in terms.items()}
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by[:-3], **terms}


def ms_bound(shape, R, query_iterations):
    # Only offsets within R of the query's drift can pass the spatial test:
    # the lattice points of a disc of radius R (1,257 at R = 20; around a
    # fractional drift the count differs by a few). Per query, iteration
    # and such offset: the spatial distance (3), the colour distance (8)
    # and the two tests (2); per disc row the dy term (2). The sums of the
    # points that pass depend on the data and are not counted, so this
    # bound is low by up to 6 per offset. ``query_iterations``: the
    # iterations the queries need, summed (ms_query_iterations): a query
    # whose state comes back unchanged needs no more.
    px = shape[0] * shape[1]
    disc = sum(2 * math.isqrt(R * R - dy * dy) + 1 for dy in range(-R, R + 1))
    return bound(4 * 8 * px,
                 query_iterations * (13 * disc + 2 * (2 * R + 1)))


def ms_query_iterations(lab, iters, R=MS_R) -> int:
    """The iterations the queries of ``lab`` need at radius R (the default
    margin), summed: a query needs those up to the first whose (pos, col)
    repeat the previous iteration's bit for bit, or ``iters``. The kernel
    stops a query once its state (drift, colour) repeats, which pos and
    col show or which rounding in pos hides, so it runs at least these."""
    import torch

    from tpuflow_torch.kernels import ms_filter

    prev = need = None
    for k in range(iters + 1):
        pos, col = ms_filter.mean_shift_filter(lab, R, MS_KI, k)
        bits = torch.cat([pos.reshape(-1, 2), col.reshape(-1, 3)],
                         1).contiguous().view(torch.int32)
        if prev is None:
            need = torch.full(bits.shape[:1], iters, device=bits.device)
        else:
            need = torch.where((bits == prev).all(1) & (need == iters), k,
                               need)
        prev = bits
    return int(need.sum())


def frames_1080p():
    """bench.py::_frames_1080p."""
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, HS_SHAPE)
    nxt = np.roll(prev, 2, axis=1) + rng.normal(0, 1, HS_SHAPE)
    return prev, nxt


def frames_4k():
    """bench.py::bench_hs_4k's pair."""
    rng = np.random.default_rng(4)
    prev = rng.uniform(0, 255, HS4K_SHAPE)
    return prev, np.roll(prev, 2, axis=1) + rng.normal(0, 1, HS4K_SHAPE)


def frames_kitti():
    """bench.py::_frames_kitti."""
    from scipy.ndimage import gaussian_filter

    kh, kw = BA_SHAPE
    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (kh + 8, kw + 8)), 2.0)
    return base[:kh, :kw].copy(), base[4 : 4 + kh, 2 : 2 + kw].copy()


def multioctave_frames(margin: int):
    """bench.py::_multioctave_frames: multi-octave smoothed noise."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(9)
    shape = (HS_SHAPE[0], HS_SHAPE[1] + margin + 40)

    def octave(sigma):
        g = gaussian_filter(rng.uniform(0, 1, shape), sigma)
        return (g - g.mean()) / g.std()

    base = octave(2) + octave(8) + octave(32)
    base -= base.min()
    return base * (255.0 / base.max())


def frames_largemotion():
    """bench.py::bench_farneback_demo3_largemotion's pair: a 16-px pan of
    multi-octave texture and a counter-moving block."""
    w = HS_SHAPE[1]
    base = multioctave_frames(16)
    prev = base[:, :w].copy()
    nxt = base[:, 16 : 16 + w].copy()
    nxt[400:700, 300:800] = prev[392:692, 310:810]
    return prev, nxt


def voronoi_frames(shape=BM_SHAPE,
                   cells_per_px=BM_CELLS / (BM_SHAPE[0] * BM_SHAPE[1]),
                   pan=BM_PAN, shade=1.0, seed=7):
    """Three RGB frames (float, 0-255) of a pan over shaded Voronoi cells
    (by default BM_CELLS of them at BM_SHAPE): each cell a random colour
    with a random linear shading (gradient std ``shade`` per px), noise of
    std ``BM_NOISE[k]`` on frame k, which shows the scene moved by k * pan.
    The scene is the frame plus a border of 4 * max|pan|. Returns (frames,
    cells) with the middle frame's cell map (int32), a stand-in for its
    labels. The CPU tests draw their small scenes from here too."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    h, w = shape
    pad = 4 * max(abs(p) for p in pan)
    H, W = h + 2 * pad, w + 2 * pad
    n_all = int(round(cells_per_px * H * W))
    pts = rng.uniform(0, 1, (n_all, 2)) * [H, W]
    cols = rng.uniform(40, 215, (n_all, 3))
    grad = rng.normal(0, 1.0, (n_all, 2)) * shade
    yy, xx = np.mgrid[0:H, 0:W]
    cell = cKDTree(pts).query(np.stack([yy.ravel(), xx.ravel()], -1))[1]
    cell = cell.reshape(H, W)
    img = cols[cell] + ((yy - pts[cell, 0]) * grad[cell, 0]
                        + (xx - pts[cell, 1]) * grad[cell, 1])[..., None]
    frames = []
    for k in range(3):
        dy, dx = pad + k * pan[0], pad + k * pan[1]
        f = img[dy : dy + h, dx : dx + w] + rng.normal(0, BM_NOISE[k],
                                                        (h, w, 3))
        frames.append(np.clip(f, 0, 255))
    dy, dx = pad + pan[0], pad + pan[1]
    return frames, cell[dy : dy + h, dx : dx + w].astype(np.int32)


FB_FRAMES = {"1080p": frames_1080p, "kitti": frames_kitti,
             "largemotion": frames_largemotion}


def f32(dev, *arrays):
    import torch

    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs on the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", name=json.dumps(name), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(smi, flush=True)
    return name


# ptxas's report per kernel entry (registers and spill bytes), read by
# phase_build from each source's build log.
PTXAS: dict[str, dict] = {}


def read_ptxas(report: str) -> dict[str, dict]:
    """{mangled entry name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's ``-Xptxas -v`` output."""
    usage, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            usage[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split()
                    if t.isdigit()]
            usage[entry]["spill_stores"], usage[entry]["spill_loads"] = \
                nums[1], nums[2]
        elif entry and "Used" in line and "registers" in line:
            words = line.split()
            usage[entry]["registers"] = int(words[words.index("Used") + 1])
    return usage


def kernel_usage(entry: str, blocks_per_sm: int, *more: str) -> dict:
    """The blocks per SM the occupancy calculator gives a kernel's launch,
    beside ptxas's registers and spills for the entry whose mangled name
    contains ``entry`` (and each of ``more``)."""
    found = [u for name, u in PTXAS.items()
             if all(e in name for e in (entry, *more))]
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} entries match "
                             f"{entry!r}")
    return {"blocks_per_sm": blocks_per_sm, **found[0]}


def irls_usage(entry: str, tile: bool) -> dict:
    """:func:`kernel_usage` of both stages of csrc/irls_stencil.cu (WIDE
    takes the frame of the row, NARROW the coarser pyramid levels)."""
    from tpuflow_torch.kernels import irls_stencil

    out = {}
    for stage, narrow, (sh, sw), threads in (
            ("wide", False, irls_stencil.STAGE, irls_stencil.THREADS),
            ("narrow", True, irls_stencil.NARROW_STAGE,
             irls_stencil.NARROW_THREADS)):
        # The mangled Stage<SH, CX, CY, ...> of the instantiation.
        args = f"StageILi{sh}ELi{sw // 32}ELi{32 * sh // threads}E"
        usage = kernel_usage(entry, irls_stencil.blocks_per_sm(tile, narrow),
                             args)
        out.update({f"{stage}_{k}": v for k, v in usage.items()})
    return out


def phase_build() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from tpuflow_torch.kernels import (_build, bm_cost, fb_kernels,
                                       hs_stencil, irls_stencil, ms_filter,
                                       sepconv)

    mods = {"hs_stencil": hs_stencil._lib,
            "hs_resident": hs_stencil._lib_resident,
            "irls_stencil": irls_stencil._lib,
            "irls_gated": irls_stencil._lib_gated, "sepconv": sepconv._lib,
            "fb_kernels": fb_kernels._lib, "ms_filter": ms_filter._lib,
            "bm_cost": bm_cost._lib}

    def build(name):
        t0 = time.perf_counter()
        mods[name]()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        seconds = dict(zip(mods, pool.map(build, mods)))
    for name, sec in seconds.items():
        log("build", kernel=name, seconds=round(sec, 3))
        report = _build.BUILD_DIR / f"{name}.log"
        if report.exists():
            PTXAS.update(read_ptxas(report.read_text()))
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("    " + line.strip(), flush=True)
    log("build", all_seconds=round(time.perf_counter() - t0, 3))


def hs_fields(shape, seed):
    rng = np.random.default_rng(seed)
    gx, gy = rng.normal(size=shape), rng.normal(size=shape)
    gt = 0.3 * rng.normal(size=shape)
    u, v = 0.5 * rng.normal(size=shape), 0.5 * rng.normal(size=shape)
    return u, v, gx, gy, gt, 1.0 / (1.0 + gx * gx + gy * gy)


def irls_fields(shape, seed):
    rng = np.random.default_rng(seed)
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy = 0.05 * rng.normal(size=shape), 0.05 * rng.normal(size=shape)
    it = 0.02 * rng.normal(size=shape)
    return u, v, gx, gy, it


def well_conditioned_m(shape, seed):
    """tests/test_kernels.py:285-295's normal-equation field."""
    r = np.random.default_rng(seed)
    a11, a22, db1, db2 = (r.normal(size=shape) for _ in range(4))
    a12 = 0.2 * r.normal(size=shape)
    return np.stack([a11 * a11 + a12 * a12, a12 * (a11 + a22),
                     a12 * a12 + a22 * a22, a11 * db1 + a12 * db2,
                     a12 * db1 + a22 * db2])


def kernel_row(out, name, shape, fn, plain, work, library=None,
               plain_reps=3, **what):
    """Check fn() against plain() on the card, time both (and the library
    call, where there is one), log beside the bound of ``work`` (a
    :func:`bound` dict), and keep the first (main-path) shape's numbers
    in out[name]. ``plain_reps=0`` times the plain version once, by the
    host clock around the check's own call (for plain versions of
    seconds, where a launch's host cost is noise)."""
    import torch

    got = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_once_ms = 1e3 * (time.perf_counter() - t0)
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    err = check_close(f"{name} {shape} {what}", list(zip(got, ref)),
                      KERNEL_TOL)
    del got, ref
    ms = cuda_ms(fn, device_only=True)
    plain_ms = (cuda_ms(plain, reps=plain_reps, device_only=True)
                if plain_reps else plain_once_ms)
    library_ms = None if library is None else cuda_ms(library,
                                                      device_only=True)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work,
           "library_ms": library_ms}
    log("kernels", kernel=name, shape=shape, **what, **row)
    out.setdefault(name, row)
    torch.cuda.synchronize()
    return err


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, at the main-path
    shapes and at the ragged KITTI size; both versions timed at each.
    Returns the numbers at the first (main-path) shape of each kernel."""
    import torch

    from tpuflow_torch.kernels import hs_stencil, irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    out = {}
    hs_fuse = hs_stencil.DEFAULT_FUSE
    for shape in (HS_SHAPE, RAGGED_SHAPE):
        fields = f32(dev, *hs_fields(shape, 3))
        plain = hs_stencil.hs_sweeps_plain(*fields, HS_WINDOW, HS_ITERS)
        err = 0.0
        for fuse in (hs_fuse, 7):
            got = hs_stencil.hs_iterate(*fields, HS_WINDOW, HS_ITERS, fuse)
            err = max(err, check_close(f"hs_sweeps {shape} fuse {fuse}",
                                       list(zip(got, plain)), KERNEL_TOL))
            log("kernels", kernel="hs_sweeps", shape=shape, sweeps=HS_ITERS,
                fuse=fuse, max_abs_err=err)
        ms = cuda_ms(lambda: hs_stencil.hs_iterate(
            *fields, HS_WINDOW, HS_ITERS, hs_fuse), device_only=True)
        plain_ms = cuda_ms(lambda: hs_stencil.hs_sweeps_plain(
            *fields, HS_WINDOW, HS_ITERS), reps=3, device_only=True)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **hs_bound(shape, HS_ITERS, HS_WINDOW), "library_ms": None}
        log("kernels", kernel="hs_sweeps", shape=shape, sweeps=HS_ITERS,
            fuse=hs_fuse, **row, **kernel_usage(
                f"hs_sweeps_kernelILi{HS_WINDOW // 2}E",
                hs_stencil.blocks_per_sm(False, HS_WINDOW)))
        out.setdefault("hs_sweeps", row)
        torch.cuda.synchronize()
    # The kernels take any odd window; all but 5x5 with the box radius read
    # at run time. Once at 3x3, on the ragged size.
    fields = f32(dev, *hs_fields(RAGGED_SHAPE, 5))
    err = check_close("hs_sweeps window 3", list(zip(
        hs_stencil.hs_iterate(*fields, 3, 10, hs_fuse),
        hs_stencil.hs_sweeps_plain(*fields, 3, 10))), KERNEL_TOL)
    log("kernels", kernel="hs_sweeps", shape=RAGGED_SHAPE, window=3,
        sweeps=10, fuse=hs_fuse, max_abs_err=err)

    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    for shape in (BA_SHAPE, RAGGED_SHAPE):
        u, v, gx, gy, it = f32(dev, *irls_fields(shape, 4))
        sup = irls_sup(gx, gy, *consts)

        def plain():
            return irls_stencil.irls_sweeps_plain(u, v, gx, gy, it, *sup,
                                                  BA_ITER_MAX, *consts)

        def run(fuse):
            n_full, rem = divmod(BA_ITER_MAX, fuse)
            a, b = u, v
            for k in [fuse] * n_full + ([rem] if rem else []):
                a, b = irls_stencil.irls_sweeps(a, b, gx, gy, it, *sup, k,
                                                *consts)
            return a, b

        ref = plain()
        err = 0.0
        for fuse in (BA_FUSE, 15):
            err = max(err, check_close(f"irls_sweeps {shape} fuse {fuse}",
                                       list(zip(run(fuse), ref)), KERNEL_TOL))
            log("kernels", kernel="irls_sweeps", shape=shape,
                sweeps=BA_ITER_MAX, fuse=fuse, max_abs_err=err)
        ms = cuda_ms(lambda: run(BA_FUSE), device_only=True)
        plain_ms = cuda_ms(plain, reps=3, device_only=True)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **irls_bound(shape, BA_ITER_MAX), "library_ms": None}
        log("kernels", kernel="irls_sweeps", shape=shape, sweeps=BA_ITER_MAX,
            fuse=BA_FUSE, **row, **irls_usage("irls_sweeps_kernel", False))
        out.setdefault("irls_sweeps", row)
        torch.cuda.synchronize()
    irls_levels(dev)

    sepconv_rows(dev, out)

    poly_rows(dev, out)
    blur_rows(dev, out)

    phase_kernels_flagship(dev, out)
    phase_kernels_dist(dev, out)
    t0 = time.perf_counter()
    phase_kernels_entries(dev, out)
    log("kernels", entries_seconds=time.perf_counter() - t0)
    phase_kernels_deep(dev)
    phase_kernels_wide(dev)
    return out


def sepconv_rows(dev, out, usage: bool = True,
                 cases=SEP_TAPS + SEP_WIDE_TAPS) -> None:
    """``sep_conv2d_valid`` at SEP_TAPS and SEP_WIDE_TAPS (a box of ky and a
    Gaussian of kx) against its plain version, timed beside one F.conv2d
    with the outer product ky x kx (the library call), with its launches
    (one, two in the wide form); ``usage`` adds blocks per SM and ptxas's
    registers and spills of the instantiation each row runs (the wide
    form: its pass kernel's, blocks per SM not taken). The first row is
    out's; every row also stands in its ``rows``."""
    import torch
    import torch.nn.functional as F

    from tpuflow_torch.kernels import sepconv

    rows = []
    for shape, nky, nkx in cases:
        rng = np.random.default_rng(nky if nky == nkx else 1000 * nky
                                    + nkx)
        padded, = f32(dev, rng.uniform(0, 255, (shape[0] + nky - 1,
                                                shape[1] + nkx - 1)))
        box = np.full(nky, 1.0 / nky)
        gauss = np.exp(-np.linspace(-2.0, 2.0, nkx) ** 2)
        gauss /= gauss.sum()
        ky, kx = (sepconv.host_taps(t, torch.float32) for t in (box, gauss))
        k2, = f32(dev, np.outer(ky, kx)[None, None])
        form = sepconv.form_for(nky, nkx)
        what = {"taps": (nky, nkx), "form": form,
                "launches_per_call": launched(
                    "sep_conv2d_valid",
                    lambda: sepconv.sep_conv2d_valid(padded, box, gauss),
                    1 if form == "staged" else 2, taps=(nky, nkx))}
        if usage and form == "staged":
            inst = sepconv.instantiation(nky, nkx)
            what.update(instantiation=list(inst), **kernel_usage(
                "sep_conv2d_valid_kernelILi{}ELi{}E".format(
                    *(str(i).replace("-", "n") for i in inst)),
                sepconv.blocks_per_sm(nky, nkx)))
        elif usage:
            what.update(instantiation=form, **kernel_usage(
                "sep_wide_pass_kernel", None))
        one = {}
        kernel_row(one, "sep_conv2d_valid", shape,
                   lambda: sepconv.sep_conv2d_valid(padded, box, gauss),
                   lambda: sepconv.sep_conv2d_valid_plain(padded, ky, kx),
                   sep_bound(*padded.shape, nky, nkx),
                   library=lambda: F.conv2d(padded[None, None], k2), **what)
        rows.append({"shape": list(shape), **what,
                     **one["sep_conv2d_valid"]})
    if usage and not any(r["instantiation"] == [0, 0] for r in rows):
        raise AssertionError("no sepconv row runs the run-time tap count")
    out.setdefault("sep_conv2d_valid", {**rows[0], "rows": rows})


def poly_rows(dev, out, usage: bool = True,
              cases=POLY_CASES + POLY_WIDE_CASES) -> None:
    """``fb_poly_expansion`` at POLY_CASES and POLY_WIDE_CASES on a 0-255
    image, CLAMP-padded, against its plain version, timed beside one
    F.conv2d with five output channels, each a G^-1 row folded into the
    three moment tap sets (the library call), with its launches (one, two
    in the wide form); ``usage`` adds blocks per SM and ptxas's registers
    and spills of the instantiation each row runs (the wide form: its two
    kernels', blocks per SM not taken). The first row is out's; every row
    also stands in its ``rows``."""
    import torch
    import torch.nn.functional as F

    from tpuflow_torch.core import borders as bd
    from tpuflow_torch.kernels import fb_kernels, sepconv
    from tpuflow_torch.solvers.farneback import _poly_exp_matrices

    rows = []
    for shape, n, sigma in cases:
        g, ginv = _poly_exp_matrices(n, sigma)
        xs = np.arange(-n, n + 1, dtype=np.float64)
        ginv_rows = ginv[1:6].copy()
        ginv_rows[4] *= 0.5
        taps = [sepconv.host_taps(t, torch.float32)
                for t in (g, g * xs, g * xs * xs, ginv_rows)]
        tg, tgx, tgxx = (t.astype(np.float64) for t in taps[:3])
        # Moments [1, x, y, x^2, y^2, xy] as (row taps, column taps).
        moments = ((tg, tg), (tg, tgx), (tgx, tg), (tg, tgxx), (tgxx, tg),
                   (tgx, tgx))
        weight, = f32(dev, np.stack([
            sum(c * np.outer(a, b) for c, (a, b) in zip(r, moments))
            for r in taps[3].reshape(5, 6).astype(np.float64)])[:, None])
        img, = f32(dev, np.random.default_rng(n).uniform(0, 255, shape))
        padded = bd.pad2d(img, n, bd.CLAMP)
        form = fb_kernels.poly_form(2 * n + 1)
        what = {"n": n, "form": form, "launches_per_call": launched(
            "fb_poly_expansion", lambda: fb_kernels.fb_poly_expansion(
                padded, g, g * xs, g * xs * xs, ginv_rows),
            1 if form == "staged" else 2, n=n)}
        if usage and form == "staged":
            inst = fb_kernels.poly_instantiation(2 * n + 1)
            what.update(instantiation=inst, **kernel_usage(
                "fb_poly_expansion_kernelILi{}E".format(
                    str(inst).replace("-", "n")),
                fb_kernels.poly_blocks_per_sm(2 * n + 1)))
        elif usage:
            what.update(instantiation=form, **{
                f"{part}_{k}": v for part in ("rows", "cols")
                for k, v in kernel_usage(f"fb_poly_wide_{part}_kernel",
                                         None).items()})
        one = {}
        kernel_row(one, "fb_poly_expansion", shape,
                   lambda: fb_kernels.fb_poly_expansion(
                       padded, g, g * xs, g * xs * xs, ginv_rows),
                   lambda: fb_kernels.fb_poly_expansion_plain(
                       padded, *taps[:3], taps[3].reshape(5, 6)),
                   poly_bound(*padded.shape, 2 * n + 1, taps[3].reshape(5, 6)),
                   library=lambda: F.conv2d(padded[None, None], weight),
                   **what)
        rows.append({"shape": list(shape), **what,
                     **one["fb_poly_expansion"]})
    if usage and not any(r["instantiation"] == 0 for r in rows):
        raise AssertionError("no poly row runs the run-time tap count")
    out.setdefault("fb_poly_expansion", {**rows[0], "rows": rows})


def blur_rows(dev, out, usage: bool = True, cases=BLUR_CASES) -> None:
    """``fb_blur_solve`` against its plain version at BLUR_CASES (each
    CLAMP-padded by winsize // 2), with its launches (one, two in the
    wide form); ``usage`` adds blocks per SM and ptxas's registers and
    spills of the instantiation each row runs (the wide form: its two
    kernels', blocks per SM not taken). The first row is out's; every row
    also stands in its ``rows``."""
    from tpuflow_torch.core import borders as bd
    from tpuflow_torch.kernels import fb_kernels

    rows = []
    for shape, winsize in cases:
        m = winsize // 2
        M, = f32(dev, well_conditioned_m(shape, winsize))
        Mp = bd.pad2d(M, m, bd.CLAMP)
        form = fb_kernels.blur_form(winsize)
        what = {"winsize": winsize, "form": form,
                "launches_per_call": launched(
                    "fb_blur_solve",
                    lambda: fb_kernels.fb_blur_solve(Mp, winsize),
                    1 if form == "staged" else 2, winsize=winsize)}
        if usage and form == "staged":
            inst = fb_kernels.blur_instantiation(winsize)
            what.update(instantiation=inst, **kernel_usage(
                f"fb_blur_solve_kernelILi{inst}E",
                fb_kernels.blur_blocks_per_sm(winsize)))
        elif usage:
            what.update(instantiation=form, **{
                f"{part}_{k}": v for part in ("rows", "solve")
                for k, v in kernel_usage(f"fb_blur_wide_{part}_kernel",
                                         None).items()})
        one = {}
        kernel_row(one, "fb_blur_solve", shape,
                   lambda: fb_kernels.fb_blur_solve(Mp, winsize),
                   lambda: fb_kernels.fb_blur_solve_plain(Mp, winsize),
                   blur_bound(*Mp.shape[1:], winsize), **what)
        rows.append({"shape": list(shape), **what, **one["fb_blur_solve"]})
    out.setdefault("fb_blur_solve", {**rows[0], "rows": rows})


def ms_rows(dev, out, usage: bool = True) -> None:
    """The mean-shift filter at R = MS_R on the flagship scene's middle
    frame in Lab: against its plain version at one iteration on the whole
    376x1240 frame and at MS_ITERS on the 96x160 crop (the plain version is
    ~150,000 eager ops per iteration), and the main path's MS_ITERS on the
    whole frame, timed; each bound counts the iterations the queries need
    (ms_query_iterations). ``usage`` adds the query rows of a block the
    launcher picks, blocks per SM and ptxas's registers and spills. The
    first row is out's; every row also stands in its ``rows``."""
    import torch

    from tpuflow_torch.kernels import ms_filter
    from tpuflow_torch.solvers import bm_flow

    lab = bm_flow._to_lab(voronoi_frames()[0][1], 255.0)[1].to(dev)
    crop = lab[BM_CROP].contiguous()
    what = {"R": MS_R}
    if usage:
        E = ms_filter.window(MS_R, None)
        th = ms_filter.tile_rows(E)
        what.update(tile_rows=th, **kernel_usage(
            "ms_filter_kernel", ms_filter.blocks_per_sm(E, th), "ILb0E"))

    rows = []
    for x, iters in ((lab, 1), (crop, MS_ITERS)):
        need = ms_query_iterations(x, iters)
        one = {}
        kernel_row(one, "mean_shift_filter", tuple(x.shape[:2]),
                   lambda x=x, iters=iters: ms_filter.mean_shift_filter(
                       x, MS_R, MS_KI, iters),
                   lambda x=x, iters=iters: ms_filter.mean_shift_filter_plain(
                       x, MS_R, MS_KI, iters),
                   ms_bound(x.shape[:2], MS_R, need), plain_reps=0,
                   iters=iters, query_iterations=need, **what)
        rows.append({"shape": list(x.shape[:2]), "iters": iters,
                     "query_iterations": need, **what,
                     **one["mean_shift_filter"]})
    for (h, w), R, iters in MS_WIDE:
        x = lab[BM_CROP[0].start : BM_CROP[0].start + h,
                BM_CROP[1].start : BM_CROP[1].start + w].contiguous()
        E = ms_filter.window(R, None)
        need = ms_query_iterations(x, iters, R)
        wide = {"R": R, "E": E, "form": ms_filter.form_for(E),
                "launches_per_call": launched(
                    "mean_shift_filter", lambda x=x, R=R, iters=iters:
                    ms_filter.mean_shift_filter(x, R, MS_KI, iters), 1, E=E)}
        if wide["form"] != "wide":
            raise AssertionError(f"mean_shift_filter E={E}: {wide['form']}")
        if usage:
            wide.update(tile_rows=ms_filter.tile_rows(E), **kernel_usage(
                "ms_filter_wide_kernel",
                ms_filter.blocks_per_sm(E, ms_filter.tile_rows(E)), "ILb0E"))
        one = {}
        kernel_row(one, "mean_shift_filter", (h, w),
                   lambda x=x, R=R, iters=iters: ms_filter.mean_shift_filter(
                       x, R, MS_KI, iters),
                   lambda x=x, R=R, iters=iters:
                   ms_filter.mean_shift_filter_plain(x, R, MS_KI, iters),
                   ms_bound((h, w), R, need), plain_reps=0, iters=iters,
                   query_iterations=need, **wide)
        rows.append({"shape": [h, w], "iters": iters,
                     "query_iterations": need, **wide,
                     **one["mean_shift_filter"]})
    need = ms_query_iterations(lab, MS_ITERS)
    row = {"iters": MS_ITERS, "query_iterations": need, **what,
           "ms": cuda_ms(lambda: ms_filter.mean_shift_filter(
               lab, MS_R, MS_KI, MS_ITERS), reps=3, device_only=True),
           "plain_ms": None, **ms_bound(BM_SHAPE, MS_R, need),
           "library_ms": None}
    log("kernels", kernel="mean_shift_filter", shape=BM_SHAPE, **row)
    rows.append({"shape": list(BM_SHAPE), **row})
    out.setdefault("mean_shift_filter", {**rows[0], "rows": rows})
    torch.cuda.synchronize()


def ba_level_shapes() -> list[tuple[int, int]]:
    """(h, w) of each level of BA's pyramid at BA_SHAPE, finest first."""
    from tpuflow_torch.pyramid.pyramid import pyramid_sizes

    return [(h, w) for w, h in pyramid_sizes(BA_SHAPE[1], BA_SHAPE[0],
                                             BA_LEVEL)]


def irls_levels(dev) -> list[float]:
    """``irls_sweeps`` at each level of BA's pyramid, BA_ITER_MAX sweeps in
    blocks of BA_FUSE as ``optical_flow_pyramid_fast`` launches them, each
    bitwise ``irls_sweeps_plain`` in its launch count; returns the levels'
    device ms. csrc/irls_stencil.cu's launcher picks its staged tile (WIDE
    or NARROW) by the frame, so this holds both at the main path's
    shapes."""
    from tpuflow_torch.kernels import irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    level_ms = []
    for shape in ba_level_shapes():
        u, v, gx, gy, it = f32(dev, *irls_fields(shape, 4))
        sup = irls_sup(gx, gy, *consts)

        def run():
            a, b = u, v
            for _ in range(BA_ITER_MAX // BA_FUSE):
                a, b = irls_stencil.irls_sweeps(a, b, gx, gy, it, *sup,
                                                BA_FUSE, *consts)
            return a, b

        exact_launches(
            "irls_sweeps", irls_stencil, "LAUNCHES",
            launches_of(BA_ITER_MAX, BA_FUSE), run,
            irls_stencil.irls_sweeps_plain(u, v, gx, gy, it, *sup,
                                           BA_ITER_MAX, *consts),
            level=shape, sweeps=BA_ITER_MAX, fuse=BA_FUSE)
        level_ms.append(cuda_ms(run, device_only=True))
        log("kernels", kernel="irls_sweeps", level=shape, ms=level_ms[-1])
    log("kernels", kernel="irls_sweeps", pyramid_levels=len(level_ms),
        pyramid_ms=sum(level_ms))
    return level_ms


def flagship_refine_inputs(dev, shape):
    """The gated refine's inputs on the flagship scene at ``shape``: gx, gy
    of the middle frame, its dt against both neighbours (B = 2), the cell
    map as labels, and the reference sups."""
    import torch

    from tpuflow_torch.solvers import bm_flow

    frames, cells = voronoi_frames(shape)
    lab_l = [bm_flow._to_lab(f, 255.0)[1][..., 0].to(dev) * bm_flow.LAB_SCALE
             for f in frames]
    gx, gy = bm_flow.gradient_method_grad(lab_l[1])
    its = torch.stack([bm_flow.gradient_method_dt_zero(lab_l[k], lab_l[1])
                       for k in (0, 2)])
    sup = bm_flow._gated_sup(gx, gy, bm_flow.LAMBDA_D, bm_flow.LAMBDA_S,
                             bm_flow.SIGMA_D_BM, bm_flow.SIGMA_S_BM)
    return frames, cells, gx, gy, its, sup


def phase_kernels_flagship(dev, out) -> None:
    """The flagship's two kernels against their plain versions: the gated
    IRLS (GATED_SWEEPS sweeps, fuse 16 and a remainder fuse, two
    directions and one) at the KITTI and the ragged size, on the scene's
    own refine inputs; the mean-shift filter (:func:`ms_rows`)."""
    import torch

    from tpuflow_torch.kernels import irls_stencil
    from tpuflow_torch.solvers import bm_flow

    consts = (bm_flow.LAMBDA_D, bm_flow.LAMBDA_S, bm_flow.SIGMA_D_BM,
              bm_flow.SIGMA_S_BM)
    usage = kernel_usage("irls_gated_kernel",
                         irls_stencil.blocks_per_sm_gated(), "ILb0E")
    for shape in (BM_SHAPE, RAGGED_SHAPE):
        frames, cells, gx, gy, its, sup = flagship_refine_inputs(dev, shape)
        labels = torch.from_numpy(cells).to(dev)
        for batch in (2, 1):
            it = its[:batch] if batch == 2 else its[0].contiguous()
            u0 = torch.zeros_like(it)

            def run(fuse, it=it, u0=u0):
                n_full, rem = divmod(GATED_SWEEPS, fuse)
                a, b = u0, u0
                for k in [fuse] * n_full + ([rem] if rem else []):
                    a, b = irls_stencil.irls_gated_sweeps(
                        a, b, gx, gy, it, labels, *sup, k, *consts)
                return a, b

            def plain(it=it, u0=u0):
                return irls_stencil.irls_gated_sweeps_plain(
                    u0, u0, gx, gy, it, labels, *sup, GATED_SWEEPS, *consts)

            for fuse in (GATED_FUSE, 15):
                kernel_row(out, "irls_gated_sweeps", shape,
                           lambda fuse=fuse: run(fuse), plain,
                           gated_bound(cells, GATED_SWEEPS, batch),
                           plain_reps=0, sweeps=GATED_SWEEPS, fuse=fuse,
                           batch=batch, **usage)
            if shape == BM_SHAPE and batch == 2:
                deep = DEEP_IRLS_FUSE
                exact_launches(
                    "irls_gated_sweeps", irls_stencil, "LAUNCHES_GATED",
                    launches_of(deep, irls_stencil.GATED_MAX_FUSE),
                    lambda: irls_stencil.irls_gated_sweeps(
                        u0, u0, gx, gy, it, labels, *sup, deep, *consts),
                    irls_stencil.irls_gated_sweeps_plain(
                        u0, u0, gx, gy, it, labels, *sup, deep, *consts),
                    shape=shape, batch=batch, fuse=deep)

    ms_rows(dev, out)
    bm_cost_rows(dev, out)


def bm_cost_rows(dev, out) -> None:
    """:func:`bm_cost_row` on the Voronoi pan, its middle frame's
    BM_CELLS cells as the labels."""
    from tpuflow_torch.solvers import bm_flow

    frames, cells = voronoi_frames()
    labels, n = crop_labels(cells)
    bm_cost_row(dev, out, "kernels", [bm_flow._to_lab(f, 255.0)[1]
                                      for f in frames], labels, n)


def bm_cost_row(dev, out, phase, labs, labels, n, search_range=61) -> None:
    """The region matcher's sums (kernels/bm_cost) at the flagship's
    search on the middle of three Lab frames against both neighbours: the
    kernel's two launches against the plain version on the card (every
    sum within SUM_RTOL, each direction's winners equal), the kernel's
    device ms beside bm_cost_bound and the plain version's ms (host clock
    around one synced call), the plan and the wrapper's ms (the labels to
    the card and sorted there by matcher.region_plan, then the launches;
    host clock), launches, and blocks per SM, registers and spills."""
    import torch

    from tpuflow_torch.blockmatching import matcher
    from tpuflow_torch.kernels import bm_cost

    cur, prev, nxt = [x.to(dev) for x in labs]
    cand_np = matcher.method_candidates("matmul", search_range)
    chunk = matcher.match_chunk("matmul", 16)
    cand = torch.as_tensor(matcher.padded_candidates(cand_np, chunk),
                           device=dev)
    plan = matcher.region_plan(labels, n, dev)
    seg = (plan.perm, plan.bounds, plan.seg_end)
    before = bm_cost.LAUNCHES
    got = bm_cost.region_sums(cur, [prev, nxt], labels, seg, n, cand, chunk,
                              search_range // 2)
    torch.cuda.synchronize()
    launches = bm_cost.LAUNCHES - before
    t0 = time.perf_counter()
    want = bm_cost._matmul_sums(cur, [prev, nxt], labels, n, cand, chunk,
                                search_range // 2)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())
              for a, b in zip(got, want))
    if not err <= SUM_RTOL:
        raise AssertionError(f"bm_cost {phase}: sums max rel |d| {err}")
    for k, (a, b) in enumerate(zip(matcher._sums_costs(*got, 1.0, 0.5),
                                   matcher._sums_costs(*want, 1.0, 0.5))):
        wa = torch.argmin(a[: len(cand_np)], 0)
        wb = torch.argmin(b[: len(cand_np)], 0)
        if not torch.equal(wa, wb):
            raise AssertionError(f"bm_cost {phase}: direction {k} winners "
                                 f"differ at {int((wa != wb).sum())} regions")
    del got, want
    ms = cuda_ms(lambda: bm_cost.launch(cur, [prev, nxt], seg, n, cand,
                                        False), device_only=True)

    def planned_sums():
        p = matcher.region_plan(labels, n, dev)
        return bm_cost.region_sums(cur, [prev, nxt], labels,
                                   (p.perm, p.bounds, p.seg_end), n, cand,
                                   chunk, search_range // 2)

    wrapper_ms = synced_ms(planned_sums)
    work = bm_cost_bound(labels.size, len(cand_np), 2, n)
    row = {"max_rel_err_sums": err, "winners_equal": True, "ms": ms,
           "plain_ms": plain_ms, **work,
           "share": work["bound_ms"] / ms, "library_ms": None}
    log(phase, kernel="bm_cost", shape=tuple(labels.shape),
        search_range=search_range, regions=n, candidates=len(cand_np),
        directions=2, launches=launches, wrapper_ms=wrapper_ms, **row,
        **kernel_usage("bm_cost_kernel", bm_cost.blocks_per_sm(2, False),
                       "ILi2ELb0E"))
    out.setdefault("bm_cost", {**row, "launches": launches})
    torch.cuda.synchronize()


def launched(kernel: str, fn, expected: int, **what) -> int:
    """fn() launches ``kernel`` exactly ``expected`` times (read_counts)."""
    import torch

    before = read_counts()[kernel]
    fn()
    torch.cuda.synchronize()
    n = read_counts()[kernel] - before
    if n != expected:
        raise AssertionError(f"{kernel} {what}: {n} launches, expected "
                             f"{expected}")
    return n


def exact(name: str, got, want) -> float:
    """max|d| of two results that must be equal to the last bit."""
    err, _ = max_err(list(zip(got, want)))
    must_be_exact(name, err)
    return err


def must_be_exact(name: str, err: float) -> None:
    """A kernel row's max|d| against its plain version must be 0."""
    if err != 0.0:
        raise AssertionError(f"{name}: max|d|={err}, expected 0")


def launches_of(sweeps: int, per_launch: int) -> int:
    """Launches of ``sweeps`` sweeps where one launch takes at most
    ``per_launch``."""
    return -(-sweeps // per_launch)


def exact_launches(name, module, counter, expected, fn, want,
                   **what) -> None:
    """fn() bitwise equal to ``want`` in ``expected`` launches
    (``module.<counter>``)."""
    import torch

    before = getattr(module, counter)
    got = fn()
    torch.cuda.synchronize()
    launches = getattr(module, counter) - before
    err = exact(f"{name} {what}", got, want)
    if launches != expected:
        raise AssertionError(f"{name} {what}: {launches} launches, "
                             f"expected {expected}")
    log("kernels", kernel=name, **what, launches=launches, max_abs_err=err)


def phase_kernels_deep(dev) -> None:
    """The four whole-frame and tile wrappers at depths beyond one launch
    (see the module docstring, phase 3; the gated kernel's check runs in
    phase_kernels_flagship, on the flagship's inputs)."""
    import torch
    import torch.nn.functional as F

    from tpuflow_torch.kernels import hs_stencil, irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    fuse = DEEP_HS_FUSE
    need = fuse * (HS_WINDOW // 2)
    n = launches_of(fuse, hs_stencil.max_fuse(HS_WINDOW))
    fields = f32(dev, *hs_fields(HS_SHAPE, 6))
    what = dict(shape=HS_SHAPE, window=HS_WINDOW, fuse=fuse)
    whole = hs_stencil.hs_sweeps_plain(*fields, HS_WINDOW, fuse)
    exact_launches("hs_sweeps", hs_stencil, "LAUNCHES", n,
               lambda: hs_stencil.hs_sweeps(*fields, HS_WINDOW, fuse), whole,
               **what)
    tile = [F.pad(f, (need,) * 4) for f in fields]
    tile_args = (-need, -need, *HS_SHAPE, HS_WINDOW, fuse)
    exact_launches("hs_tile_sweeps", hs_stencil, "LAUNCHES_TILE", n,
               lambda: hs_stencil.hs_tile_sweeps(*tile, *tile_args),
               hs_stencil.hs_tile_sweeps_plain(*tile, *tile_args), **what)
    exact_launches("hs_tile_sweeps", hs_stencil, "LAUNCHES_TILE", 4 * n,
               lambda: tile_chain(hs_stencil.hs_tile_sweeps, *fields[:2],
                                  fields[2:], HS_SHAPE, fuse, fuse,
                                  HS_WINDOW // 2, True, (),
                                  lambda k: (HS_WINDOW, k)),
               whole, cut="2x2 vs hs_sweeps", **what)
    del fields, tile, whole
    torch.cuda.synchronize()

    fuse = DEEP_IRLS_FUSE
    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    n = launches_of(fuse, irls_stencil.MAX_FUSE)
    fields = f32(dev, *irls_fields(BA_SHAPE, 7))
    sup = irls_sup(fields[2], fields[3], *consts)
    what = dict(shape=BA_SHAPE, fuse=fuse)
    exact_launches("irls_sweeps", irls_stencil, "LAUNCHES", n,
               lambda: irls_stencil.irls_sweeps(*fields, *sup, fuse, *consts),
               irls_stencil.irls_sweeps_plain(*fields, *sup, fuse, *consts),
               **what)
    tile = [F.pad(f, (fuse,) * 4) for f in fields]
    tile_args = (*sup, -fuse, -fuse, *BA_SHAPE, fuse, *consts)
    exact_launches("irls_tile_sweeps", irls_stencil, "LAUNCHES_TILE", n,
               lambda: irls_stencil.irls_tile_sweeps(*tile, *tile_args),
               irls_stencil.irls_tile_sweeps_plain(*tile, *tile_args),
               **what)
    torch.cuda.synchronize()


def cut_2x2(fields, halo):
    """The 2x2 tiles of full (H, W) fields, each with ``halo`` cells of the
    zero-padded frame: ((i, k), tiles, (row0, col0)) per tile, (row0,
    col0) the frame coordinates of the tiles' (0, 0)."""
    import torch
    import torch.nn.functional as F

    h, w = fields[0].shape
    th, tw = h // 2, w // 2
    padded = F.pad(torch.stack(list(fields)), (halo,) * 4)
    for i in range(2):
        for k in range(2):
            tiles = padded[:, i * th : i * th + th + 2 * halo,
                           k * tw : k * tw + tw + 2 * halo].contiguous()
            yield (i, k), tiles, (i * th - halo, k * tw - halo)


def stitch(tiles: dict):
    """The frame from an n x n cut's tiles, keyed (i, k)."""
    import torch

    n = 1 + max(i for i, _ in tiles)
    return torch.cat([torch.cat([tiles[i, k] for k in range(n)], dim=-1)
                      for i in range(n)], dim=-2)


def tiles_of(fields, halo, cut):
    """:func:`cut_2x2` (``cut``), or the whole frame as one tile at
    (-halo, -halo) with a zero pad of ``halo``."""
    import torch
    import torch.nn.functional as F

    if cut:
        return list(cut_2x2(fields, halo))
    return [((0, 0), F.pad(torch.stack(list(fields)), (halo,) * 4),
             (-halo, -halo))]


def tile_chain(sweep, u, v, fixed, shape, n_iters, fuse, step, cut, pre,
               post):
    """``n_iters`` sweeps through a tile-sweep function in blocks of
    ``fuse`` and one of the remainder, on the whole frame as one tile
    (``cut`` False) or on its 2x2 cut, stitched after each block. A block
    of k sweeps gives (u, v) a zero pad of k * ``step`` cells (the fixed
    fields get theirs once per pad width) and calls ``sweep(u, v, *fixed,
    *pre, row0, col0, *shape, *post(k))``."""
    n_full, rem = divmod(n_iters, fuse)
    fixed_t = {}
    for k in [fuse] * n_full + ([rem] if rem else []):
        halo = k * step
        if halo not in fixed_t:
            fixed_t[halo] = {key: t for key, t, _ in
                             tiles_of(fixed, halo, cut)}
        us, vs = {}, {}
        for key, uv, (row0, col0) in tiles_of((u, v), halo, cut):
            us[key], vs[key] = sweep(uv[0], uv[1], *fixed_t[halo][key],
                                     *pre, row0, col0, *shape, *post(k))
        u, v = (stitch(us), stitch(vs)) if cut else (us[0, 0],
                                                            vs[0, 0])
    return u, v


def phase_kernels_dist(dev, out) -> None:
    """The sharded solvers' two tile kernels and the resident HS pair
    against their plain versions (see the module docstring, phase 3)."""
    import torch

    from tpuflow_torch.kernels import hs_stencil, irls_stencil
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0, irls_sup)

    fuse = DIST_HS_FUSE
    need = fuse * (HS_WINDOW // 2)
    u, v, *fixed = f32(dev, *hs_fields(HS4K_SHAPE, 3))
    what = dict(sweeps=HS_ITERS, fuse=fuse, origin=(-need, -need))

    def hs_run(sweep, cut=False):
        return tile_chain(sweep, u, v, fixed, HS4K_SHAPE, HS_ITERS, fuse,
                          HS_WINDOW // 2, cut, (), lambda k: (HS_WINDOW, k))

    kernel_row(out, "hs_tile_sweeps", HS4K_SHAPE,
               lambda: hs_run(hs_stencil.hs_tile_sweeps),
               lambda: hs_run(hs_stencil.hs_tile_sweeps_plain),
               hs_bound(HS4K_SHAPE, HS_ITERS, HS_WINDOW), **what,
               **kernel_usage(f"hs_tile_kernelILi{HS_WINDOW // 2}E",
                              hs_stencil.blocks_per_sm(True, HS_WINDOW)))
    whole = hs_stencil.hs_iterate(u, v, *fixed, HS_WINDOW, HS_ITERS, fuse)
    err = exact("hs_tile_sweeps 2x2 cut vs hs_sweeps",
                hs_run(hs_stencil.hs_tile_sweeps, cut=True), whole)
    log("kernels", kernel="hs_tile_sweeps", shape=HS4K_SHAPE, cut="2x2",
        sweeps=HS_ITERS, fuse=fuse, max_abs_err_vs_hs_sweeps=err)
    del u, v, fixed, whole
    torch.cuda.synchronize()

    consts = (LAMBDA_D, LAMBDA_S, SIGMA_D_L0, SIGMA_S_L0)
    u, v, gx, gy, it = f32(dev, *irls_fields(BA_SHAPE, 4))
    sup = irls_sup(gx, gy, *consts)

    def irls_run(sweep, cut=False):
        return tile_chain(sweep, u, v, (gx, gy, it), BA_SHAPE, BA_ITER_MAX,
                          BA_FUSE, 1, cut, sup, lambda k: (k, *consts))

    kernel_row(out, "irls_tile_sweeps", BA_SHAPE,
               lambda: irls_run(irls_stencil.irls_tile_sweeps),
               lambda: irls_run(irls_stencil.irls_tile_sweeps_plain),
               irls_bound(BA_SHAPE, BA_ITER_MAX), sweeps=BA_ITER_MAX,
               fuse=BA_FUSE, origin=(-BA_FUSE, -BA_FUSE),
               **irls_usage("irls_tile_kernel", True))
    a, b = u, v
    for _ in range(BA_ITER_MAX // BA_FUSE):
        a, b = irls_stencil.irls_sweeps(a, b, gx, gy, it, *sup, BA_FUSE,
                                        *consts)
    err = exact("irls_tile_sweeps 2x2 cut vs irls_sweeps",
                irls_run(irls_stencil.irls_tile_sweeps, cut=True), (a, b))
    log("kernels", kernel="irls_tile_sweeps", shape=BA_SHAPE, cut="2x2",
        sweeps=BA_ITER_MAX, fuse=BA_FUSE, max_abs_err_vs_irls_sweeps=err)
    del u, v, gx, gy, it, a, b
    # The remainder fuse and the ragged KITTI size, bitwise.
    for shape, fuse in ((BA_SHAPE, 15), (RAGGED_SHAPE, BA_FUSE),
                        (RAGGED_SHAPE, 15)):
        u, v, *fixed = f32(dev, *irls_fields(shape, 4))
        sup = irls_sup(fixed[0], fixed[1], *consts)

        def chain(sweep, shape=shape, fuse=fuse, u=u, v=v, fixed=fixed,
                  sup=sup):
            return tile_chain(sweep, u, v, fixed, shape, BA_ITER_MAX, fuse,
                              1, False, sup, lambda k: (k, *consts))

        exact_launches("irls_tile_sweeps", irls_stencil, "LAUNCHES_TILE",
                       launches_of(BA_ITER_MAX, fuse),
                       lambda: chain(irls_stencil.irls_tile_sweeps),
                       chain(irls_stencil.irls_tile_sweeps_plain),
                       shape=shape, sweeps=BA_ITER_MAX, fuse=fuse)
    torch.cuda.synchronize()

    resident_rows(dev, out)
    resident_checks(dev)


def gated_tiles_run(sweep, u0, gx, gy, its, labels, sup, sweeps, fuse,
                    n=2):
    """``sweeps`` gated sweeps in blocks of ``fuse`` on the n x n cut, as an
    n x n mesh runs them (dist/bm_refine.py; n = 1: one tile at (-fuse,
    -fuse), a one-rank mesh): each block pads (u, v) with the frame's
    zeros, cuts the tiles halo'd by ``fuse`` with real neighbour values and
    labels, runs ``sweep`` (the tile entry or its plain version) on each,
    two directions at once, and stitches the cores."""
    import torch.nn.functional as F

    from tpuflow_torch.solvers import bm_flow

    consts = (bm_flow.LAMBDA_D, bm_flow.LAMBDA_S, bm_flow.SIGMA_D_BM,
              bm_flow.SIGMA_S_BM)
    h, w = gx.shape
    th, tw = h // n, w // n

    def pad(a):
        return F.pad(a, (fuse,) * 4)

    fixed = [pad(a) for a in (gx, gy, its, labels)]
    u = v = u0
    for _ in range(sweeps // fuse):
        up, vp = pad(u), pad(v)
        us, vs = {}, {}
        for i in range(n):
            for k in range(n):
                win = (..., slice(i * th, i * th + th + 2 * fuse),
                       slice(k * tw, k * tw + tw + 2 * fuse))
                us[i, k], vs[i, k] = sweep(
                    up[win].contiguous(), vp[win].contiguous(),
                    *(f[win].contiguous() for f in fixed), *sup,
                    i * th - fuse, k * tw - fuse, h, w, fuse, *consts)
        u, v = stitch(us), stitch(vs)
    return u, v


def ms_tiles_run(fn, lab, iters, n=2):
    """The mean-shift filter on the n x n cut of ``lab`` (n = 1: one tile
    at (0, 0), a one-rank mesh), each tile halo'd by E = 2 MS_R with the
    sentinel outside the frame (as mean_shift_filter_sharded cuts it),
    through ``fn`` (the tile entry or its plain version); stitched (pos,
    col)."""
    from tpuflow_torch.kernels import ms_filter
    from tpuflow_torch.segmentation.meanshift import _color_sentinel

    h, w = lab.shape[:2]
    th, tw = h // n, w // n
    E = ms_filter.window(MS_R, None)
    sentinel = _color_sentinel(lab, MS_KI).reshape(1)
    padded = ms_filter._padded_planes(lab, E, sentinel).permute(1, 2, 0)
    pos, col = {}, {}
    for i in range(n):
        for k in range(n):
            tile = padded[i * th : i * th + th + 2 * E,
                          k * tw : k * tw + tw + 2 * E].contiguous()
            pos[i, k], col[i, k] = fn(tile, i * th, k * tw, E, MS_R, MS_KI,
                                      iters)
    return tuple(stitch({key: t[key].permute(2, 0, 1) for key in t})
                 .permute(1, 2, 0) for t in (pos, col))


def phase_kernels_entries(dev, out) -> None:
    """The two Hopper entry points of the sharded flagship, and the
    mean-shift filter's drift and trajectory outputs, each bitwise its
    plain version (see the module docstring, phase 3). Each entry's first
    row (the kernels line's) is the one tile of a one-rank mesh, the
    shape phase dist (a) launches it at; the 2x2 cut's rows add tiles at
    nonzero origins and are held, stitched, against the whole-frame
    kernel."""
    import torch

    from tpuflow_torch.kernels import irls_stencil, ms_filter
    from tpuflow_torch.solvers import bm_flow

    # The gated tile entry on the flagship's refine inputs: one tile of
    # the whole frame, then the 2x2 cut.
    frames, cells, gx, gy, its, sup = flagship_refine_inputs(dev, BM_SHAPE)
    labels = torch.from_numpy(cells).to(dev)
    u0 = torch.zeros_like(its)
    fuse = DIST_GATED_FUSE
    args = (u0, gx, gy, its, labels, sup, GATED_SWEEPS, fuse)
    n_blocks = GATED_SWEEPS // fuse
    usage = kernel_usage("irls_gated_kernel",
                         irls_stencil.blocks_per_sm_gated(), "ILb1E")
    errs = {}
    for n in (1, 2):
        errs[n] = kernel_row(
            out, "irls_gated_tile_sweeps", BM_SHAPE,
            lambda n=n: gated_tiles_run(irls_stencil.irls_gated_tile_sweeps,
                                        *args, n=n),
            lambda n=n: gated_tiles_run(
                irls_stencil.irls_gated_tile_sweeps_plain, *args, n=n),
            gated_bound(cells, GATED_SWEEPS, 2), plain_reps=0,
            sweeps=GATED_SWEEPS, fuse=fuse, batch=2, cut=f"{n}x{n}",
            **({"origin": (-fuse, -fuse)} if n == 1 else {}),
            launches_per_call=launched(
                "irls_gated_tile_sweeps", lambda n=n: gated_tiles_run(
                    irls_stencil.irls_gated_tile_sweeps, *args, n=n),
                n * n * n_blocks), **usage)
        must_be_exact(f"irls_gated_tile_sweeps {n}x{n} vs its plain version",
                      errs[n])
    consts = (bm_flow.LAMBDA_D, bm_flow.LAMBDA_S, bm_flow.SIGMA_D_BM,
              bm_flow.SIGMA_S_BM)
    a, b = u0, u0
    for _ in range(n_blocks):
        a, b = irls_stencil.irls_gated_sweeps(a, b, gx, gy, its, labels,
                                              *sup, fuse, *consts)
    err = exact("irls_gated_tile_sweeps 2x2 cut vs irls_gated_sweeps",
                gated_tiles_run(irls_stencil.irls_gated_tile_sweeps, *args),
                (a, b))
    log("kernels", kernel="irls_gated_tile_sweeps", shape=BM_SHAPE,
        cut="2x2", sweeps=GATED_SWEEPS, fuse=fuse,
        max_abs_err_vs_plain=errs[2], max_abs_err_vs_irls_gated=err)
    del frames, gx, gy, its, labels, u0, a, b
    torch.cuda.synchronize()

    # The mean-shift tile entry at E = 2 MS_R: one tile of the whole frame
    # at MS_ITERS (the one-rank mesh's), then the 2x2 cut at MS_TILE_ITERS
    # and, stitched at MS_ITERS, against the whole-frame filter (timed).
    lab = bm_flow._to_lab(voronoi_frames()[0][1], 255.0)[1].to(dev)
    E = ms_filter.window(MS_R, None)
    usage = kernel_usage("ms_filter_kernel",
                         ms_filter.blocks_per_sm(E, ms_filter.tile_rows(E)),
                         "ILb0E")
    rows = []
    for n, iters in ((1, MS_ITERS), (2, MS_TILE_ITERS)):
        need = ms_query_iterations(lab, iters)
        one = {}
        err = kernel_row(
            one, "mean_shift_filter_tile", BM_SHAPE,
            lambda n=n, iters=iters: ms_tiles_run(
                ms_filter.mean_shift_filter_tile, lab, iters, n),
            lambda n=n, iters=iters: ms_tiles_run(
                ms_filter.mean_shift_filter_tile_plain, lab, iters, n),
            ms_bound(BM_SHAPE, MS_R, need), plain_reps=0, iters=iters, E=E,
            cut=f"{n}x{n}", query_iterations=need,
            launches_per_call=launched(
                "mean_shift_filter_tile", lambda n=n, iters=iters:
                ms_tiles_run(ms_filter.mean_shift_filter_tile, lab, iters,
                             n), n * n), **usage)
        must_be_exact(f"mean_shift_filter_tile {n}x{n} vs its plain "
                      "version", err)
        out.setdefault("mean_shift_filter_tile", one["mean_shift_filter_tile"])
        rows.append({"shape": list(BM_SHAPE), "iters": iters,
                     "cut": f"{n}x{n}", "query_iterations": need,
                     **one["mean_shift_filter_tile"]})
    need = ms_query_iterations(lab, MS_ITERS)
    whole = ms_filter.mean_shift_filter(lab, MS_R, MS_KI, MS_ITERS)
    row = {"iters": MS_ITERS, "cut": "2x2", "E": E,
           "query_iterations": need,
           "max_abs_err_vs_mean_shift_filter": exact(
               "mean_shift_filter_tile 2x2 cut vs mean_shift_filter",
               ms_tiles_run(ms_filter.mean_shift_filter_tile, lab, MS_ITERS),
               whole),
           "ms": cuda_ms(lambda: ms_tiles_run(
               ms_filter.mean_shift_filter_tile, lab, MS_ITERS), reps=3,
               device_only=True),
           **ms_bound(BM_SHAPE, MS_R, need)}
    log("kernels", kernel="mean_shift_filter_tile", shape=BM_SHAPE, **row)
    out["mean_shift_filter_tile"]["rows"] = [*rows,
                                             {"shape": list(BM_SHAPE), **row}]

    # The filter's drift and trajectory outputs (the second instantiation
    # of each form), bitwise their plain version, and pos, col bitwise the
    # first instantiation's.
    extra = kernel_usage("ms_filter_kernel",
                         ms_filter.blocks_per_sm(E, ms_filter.tile_rows(E)),
                         "ILb1E")
    for x, iters in ((lab, MS_EXTRA_ITERS),):
        one = {}
        need = ms_query_iterations(x, iters)
        opts = dict(with_drift=True, return_trajectory=True)
        err = kernel_row(one, "mean_shift_filter", tuple(x.shape[:2]),
                   lambda x=x, iters=iters: ms_filter.mean_shift_filter(
                       x, MS_R, MS_KI, iters, **opts),
                   lambda x=x, iters=iters: ms_filter.mean_shift_filter_plain(
                       x, MS_R, MS_KI, iters, **opts),
                   ms_bound(x.shape[:2], MS_R, need), plain_reps=0,
                   iters=iters, outputs="drift,trajectory",
                   query_iterations=need, launches_per_call=launched(
                       "mean_shift_filter", lambda x=x, iters=iters:
                       ms_filter.mean_shift_filter(x, MS_R, MS_KI, iters,
                                                   **opts), 1), **extra)
        must_be_exact(f"mean_shift_filter drift, trajectory "
                      f"{tuple(x.shape)}", err)
        got = ms_filter.mean_shift_filter(x, MS_R, MS_KI, iters, **opts)
        exact("mean_shift_filter pos, col with and without the outputs",
              got[:2], ms_filter.mean_shift_filter(x, MS_R, MS_KI, iters))
        log("kernels", kernel="mean_shift_filter", shape=tuple(x.shape[:2]),
            iters=iters, largest_drift=float(got[2]))
        out.setdefault("mean_shift_filter", {}).setdefault("rows", []).append(
            {"shape": list(x.shape[:2]), "iters": iters,
             "outputs": "drift,trajectory", "query_iterations": need,
             **extra, **one["mean_shift_filter"]})
    torch.cuda.synchronize()


def resident_rows(dev, out, usage: bool = True) -> None:
    """The resident HS pair at 1080x1920, window 5, HS_ITERS sweeps (and
    one fewer, which ends in the other buffer), against their plain
    versions and timed, resident2 beside ``horn_schunck_fused``; ``usage``
    adds blocks per SM and ptxas's registers and spills."""
    import torch

    from tpuflow_torch.kernels import hs_stencil

    prev, nxt = f32(dev, *frames_1080p())
    for name, fn, plain, recip in (
            ("horn_schunck_resident", hs_stencil.horn_schunck_resident,
             hs_stencil.horn_schunck_resident_plain, False),
            ("horn_schunck_resident2", hs_stencil.horn_schunck_resident2,
             hs_stencil.horn_schunck_resident2_plain, True)):
        what = kernel_usage(
            f"hs_resident_kernelILi{HS_WINDOW // 2}ELb{int(not recip)}E",
            hs_stencil.blocks_per_sm_resident(HS_WINDOW, recip)) \
            if usage else {}
        for iters in (HS_ITERS, HS_ITERS - 1):
            kernel_row(out, name, HS_SHAPE,
                       lambda fn=fn, iters=iters: fn(prev, nxt, HS_WINDOW,
                                                     iters, HS_ALPHA),
                       lambda plain=plain, iters=iters: plain(
                           prev, nxt, HS_WINDOW, iters, HS_ALPHA),
                       resident_bound(HS_SHAPE, iters, HS_WINDOW, recip),
                       sweeps=iters, **what)
    fused = hs_stencil.horn_schunck_fused(prev, nxt, HS_WINDOW, HS_ITERS,
                                          HS_ALPHA)
    res2 = hs_stencil.horn_schunck_resident2(prev, nxt, HS_WINDOW, HS_ITERS,
                                             HS_ALPHA)
    err = check_close("horn_schunck_resident2 vs horn_schunck_fused",
                      list(zip(res2, fused)), KERNEL_TOL)
    log("kernels", kernel="horn_schunck_resident2", shape=HS_SHAPE,
        sweeps=HS_ITERS, max_abs_err_vs_horn_schunck_fused=err)
    torch.cuda.synchronize()


def resident_checks(dev) -> None:
    """The resident pair bitwise its plain versions in one launch each, at
    RESIDENT_WINDOWS (window 65 in the wide form), at 1080x1920 and
    375x1242, RESIDENT_ITERS sweeps."""
    import torch

    from tpuflow_torch.kernels import hs_stencil

    for shape in (HS_SHAPE, RAGGED_SHAPE):
        rng = np.random.default_rng(shape[0])
        prev = rng.uniform(0, 255, shape)
        frames = f32(dev, prev, np.roll(prev, 2, axis=1)
                     + rng.normal(0, 1, shape))
        for window in RESIDENT_WINDOWS:
            for iters in RESIDENT_ITERS:
                for fn, plain, counter in (
                        (hs_stencil.horn_schunck_resident,
                         hs_stencil.horn_schunck_resident_plain,
                         "LAUNCHES_RESIDENT"),
                        (hs_stencil.horn_schunck_resident2,
                         hs_stencil.horn_schunck_resident2_plain,
                         "LAUNCHES_RESIDENT2")):
                    exact_launches(
                        fn.__name__, hs_stencil, counter, 1,
                        lambda fn=fn: fn(*frames, window, iters, HS_ALPHA),
                        plain(*frames, window, iters, HS_ALPHA),
                        shape=shape, window=window, sweeps=iters,
                        plan=hs_stencil.resident_plan(window, iters))
        torch.cuda.synchronize()


def phase_kernels_wide(dev) -> None:
    """Windows whose halo leaves no core in the staged tile, in the wide
    form: ``hs_sweeps`` at WIDE_WINDOWS and ``hs_tile_sweeps`` on a 2x2 cut
    at the first, WIDE_SWEEPS sweeps at 1080x1920, each bitwise the plain
    whole-frame sweeps in two launches a sweep (per tile), with the device
    ms per sweep of the whole-frame form."""
    import torch

    from tpuflow_torch.kernels import hs_stencil

    u, v, *fixed = f32(dev, *hs_fields(HS_SHAPE, 8))
    for window in WIDE_WINDOWS:
        whole = hs_stencil.hs_sweeps_plain(u, v, *fixed, window, WIDE_SWEEPS)
        what = dict(shape=HS_SHAPE, window=window, sweeps=WIDE_SWEEPS)

        def run(window=window):
            return hs_stencil.hs_sweeps(u, v, *fixed, window, WIDE_SWEEPS)

        exact_launches("hs_sweeps", hs_stencil, "LAUNCHES", 2 * WIDE_SWEEPS,
                       run, whole, **what)
        log("kernels", kernel="hs_sweeps", **what,
            ms_per_sweep=cuda_ms(run, device_only=True) / WIDE_SWEEPS)
        if window == WIDE_WINDOWS[0]:
            exact_launches(
                "hs_tile_sweeps", hs_stencil, "LAUNCHES_TILE",
                4 * 2 * WIDE_SWEEPS,
                lambda: tile_chain(hs_stencil.hs_tile_sweeps, u, v, fixed,
                                   HS_SHAPE, WIDE_SWEEPS, WIDE_SWEEPS,
                                   window // 2, True, (),
                                   lambda k: (window, k)),
                whole, cut="2x2 vs hs_sweeps_plain", **what)
        del whole
        torch.cuda.synchronize()


# -- the main paths, each with its launch counts ------------------------------

KERNELS = ("hs_sweeps", "irls_sweeps", "sep_conv2d_valid",
           "fb_poly_expansion", "fb_blur_solve", "irls_gated_sweeps",
           "mean_shift_filter", "hs_tile_sweeps", "irls_tile_sweeps",
           "horn_schunck_resident", "horn_schunck_resident2",
           "irls_gated_tile_sweeps", "mean_shift_filter_tile")


def reset_counts() -> None:
    from tpuflow_torch.kernels import (fb_kernels, hs_stencil, irls_stencil,
                                       ms_filter, sepconv)

    hs_stencil.LAUNCHES = 0
    hs_stencil.LAUNCHES_TILE = 0
    hs_stencil.LAUNCHES_RESIDENT = 0
    hs_stencil.LAUNCHES_RESIDENT2 = 0
    irls_stencil.LAUNCHES = 0
    irls_stencil.LAUNCHES_TILE = 0
    irls_stencil.LAUNCHES_GATED = 0
    irls_stencil.LAUNCHES_GATED_TILE = 0
    sepconv.LAUNCHES = 0
    ms_filter.LAUNCHES = 0
    ms_filter.LAUNCHES_TILE = 0
    for k in fb_kernels.LAUNCHES:
        fb_kernels.LAUNCHES[k] = 0


def read_counts() -> dict:
    from tpuflow_torch.kernels import (fb_kernels, hs_stencil, irls_stencil,
                                       ms_filter, sepconv)

    return {"hs_sweeps": hs_stencil.LAUNCHES,
            "irls_sweeps": irls_stencil.LAUNCHES,
            "sep_conv2d_valid": sepconv.LAUNCHES, **fb_kernels.LAUNCHES,
            "irls_gated_sweeps": irls_stencil.LAUNCHES_GATED,
            "mean_shift_filter": ms_filter.LAUNCHES,
            "hs_tile_sweeps": hs_stencil.LAUNCHES_TILE,
            "irls_tile_sweeps": irls_stencil.LAUNCHES_TILE,
            "horn_schunck_resident": hs_stencil.LAUNCHES_RESIDENT,
            "horn_schunck_resident2": hs_stencil.LAUNCHES_RESIDENT2,
            "irls_gated_tile_sweeps": irls_stencil.LAUNCHES_GATED_TILE,
            "mean_shift_filter_tile": ms_filter.LAUNCHES_TILE}


def counted(path: str, fn, expected, totals: dict):
    """Run fn() with the counters zeroed just before and read just after;
    ``expected`` maps kernel -> launches (missing kernels: 0), or is a
    function of fn's result that returns that map."""
    import torch

    reset_counts()
    result = fn()
    torch.cuda.synchronize()
    got = read_counts()
    want = expected(result) if callable(expected) else expected
    want = {k: want.get(k, 0) for k in KERNELS}
    log("main", path=path, launches=json.dumps(got))
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")
    for k, n in got.items():
        totals[k] = totals.get(k, 0) + n
    return result


def fb_expected(cfg, blur_kernel=False, pairs=1) -> dict:
    """Launches of one Farneback call: the pyramid blur (two sepconvs per
    level above 0), two expansions per level, and per iteration either
    the five-channel box (five sepconvs) or one blur-solve."""
    _, levels, _, iterations, _, _ = cfg
    solves = iterations * levels
    return {"sep_conv2d_valid": pairs * (2 * (levels - 1)
                                         + (0 if blur_kernel else 5 * solves)),
            "fb_poly_expansion": pairs * 2 * levels,
            "fb_blur_solve": pairs * (solves if blur_kernel else 0)}


def ba_call(prev, nxt, blocks=None):
    from tpuflow_torch.core.config import MultipleMotionParam
    from tpuflow_torch.solvers.black_anandan_fast import (
        optical_flow_pyramid_fast)

    param = MultipleMotionParam(level=BA_LEVEL, error_min_threshold=0.0)
    return optical_flow_pyramid_fast(prev, nxt, 255.0, param,
                                     iter_max=BA_ITER_MAX, fuse=BA_FUSE,
                                     blocks=blocks)


def fb_call(frames, cfg, **kw):
    from tpuflow_torch.solvers import calc_optical_flow_farneback

    return calc_optical_flow_farneback(*frames, None, *cfg, **kw)


def stream_frames():
    from tpuflow_torch.pipeline.streaming import SyntheticSource

    w, h = STREAM_WH
    return list(SyntheticSource(n_frames=STREAM_FRAMES, h=h, w=w, dx=2.0,
                                dy=1.0))


def stream_call(frames, device):
    from tpuflow_torch.pipeline.streaming import dense_flow_stream

    return list(dense_flow_stream(frames, STREAM_WH, device=device))


def phase_main(dev):
    """Each main path once, counters zeroed just before and read just
    after. Returns the totals per kernel and each path's inputs/outputs."""
    from tpuflow_torch import solvers
    from tpuflow_torch.kernels import hs_stencil

    totals = {}
    hs_frames = f32(dev, *frames_1080p())
    hs_flow = counted(
        "horn_schunck", lambda: solvers.horn_schunck(
            *hs_frames, HS_WINDOW, HS_ITERS, HS_ALPHA),
        {"hs_sweeps": math.ceil(HS_ITERS / hs_stencil.DEFAULT_FUSE)}, totals)
    wide = WIDE_WINDOWS[0]
    hs_wide = counted(
        f"horn_schunck_window{wide}", lambda: solvers.horn_schunck(
            *hs_frames, wide, WIDE_ITERS, HS_ALPHA),
        {"hs_sweeps": 2 * WIDE_ITERS}, totals)
    resident = [counted(name, lambda fn=fn: fn(*hs_frames, HS_WINDOW, HS_ITERS,
                                               HS_ALPHA), {name: 1}, totals)
                for name, fn in (
                    ("horn_schunck_resident", hs_stencil.horn_schunck_resident),
                    ("horn_schunck_resident2",
                     hs_stencil.horn_schunck_resident2))]

    ba_frames = f32(dev, *frames_kitti())
    blocks = []

    def ba_expected(_):
        if not blocks:
            raise AssertionError("BA ran no block")
        return {"irls_sweeps": sum(blocks)}

    ba_flow = counted("optical_flow_pyramid_fast",
                      lambda: ba_call(*ba_frames, blocks=blocks),
                      ba_expected, totals)
    log("main", ba_blocks=blocks)

    fb_runs = []
    fb_frames = {k: f32(dev, *make()) for k, make in FB_FRAMES.items()}
    for name, cfg, frames in FB_CASES:
        flow = counted(f"farneback_{name}",
                       lambda: fb_call(fb_frames[frames], cfg),
                       fb_expected(cfg), totals)
        fb_runs.append((name, cfg, {}, fb_frames[frames], flow))
    flow = counted("farneback_stream_1080p_blur_kernel",
                   lambda: fb_call(fb_frames["1080p"], FB_STREAM,
                                   use_blur_kernel=True),
                   fb_expected(FB_STREAM, blur_kernel=True), totals)
    fb_runs.append(("stream_1080p_blur_kernel", FB_STREAM,
                    {"use_blur_kernel": True}, fb_frames["1080p"], flow))

    frames = stream_frames()
    stream = counted("dense_flow_stream", lambda: stream_call(frames, dev),
                     fb_expected(FB_STREAM, pairs=STREAM_FRAMES - 1), totals)

    from tpuflow_torch.solvers.bm_flow import BMFlowState

    bm_frames, _ = voronoi_frames()
    bm_blocks = []
    state = BMFlowState()
    out1, state = counted(
        "flagship_pair1_cold", lambda: bm_pair(bm_frames, 0, state, dev,
                                               bm_blocks),
        lambda _: {"mean_shift_filter": 2,
                   "irls_gated_sweeps": bm_blocks[0]}, totals)
    out2, state = counted(
        "flagship_pair2_bidirectional", lambda: bm_pair(bm_frames, 1, state,
                                                        dev, bm_blocks),
        lambda _: {"mean_shift_filter": 1,
                   "irls_gated_sweeps": bm_blocks[1]}, totals)
    log("main", bm_blocks=bm_blocks)
    profiles = {}
    for profile in BM_PROFILES:
        p_blocks = []
        p_outs, p_state = [], BMFlowState()
        for k in (0, 1):
            out, p_state = counted(
                f"flagship_{profile}_pair{k + 1}",
                lambda k=k, st=p_state, profile=profile, p_blocks=p_blocks:
                bm_pair(bm_frames, k, st, dev, p_blocks, profile=profile),
                lambda _, k=k, p_blocks=p_blocks: {
                    "mean_shift_filter": 2 if k == 0 else 1,
                    "irls_gated_sweeps": p_blocks[k]}, totals)
            p_outs.append(out)
        log("main", profile=profile, bm_blocks=p_blocks)
        profiles[profile] = (p_outs, p_state)
    return (totals, (hs_frames, hs_flow, resident, hs_wide),
            (ba_frames, ba_flow, blocks),
            fb_runs, (frames, stream),
            (bm_frames, (out1, out2), state, profiles))


def bm_pair(frames, k, state, device, blocks=None, **kw):
    """Pair k of the flagship sequence (frames k, k + 1) on ``device``."""
    from tpuflow_torch.solvers import optical_flow_block_matching

    return optical_flow_block_matching(frames[k], frames[k + 1], state=state,
                                       device=device, blocks=blocks, **kw)


def bm_sequence(frames, device, **kw):
    """Both pairs from an empty state; returns the two outputs and state."""
    from tpuflow_torch.solvers.bm_flow import BMFlowState

    out1, state = bm_pair(frames, 0, BMFlowState(), device, **kw)
    out2, state = bm_pair(frames, 1, state, device, **kw)
    return (out1, out2), state


def phase_hs(frames, flow, resident, wide) -> None:
    import torch

    from tpuflow_torch import solvers

    if flow[0].shape != HS_SHAPE or not all(
            bool(torch.isfinite(f).all()) for f in flow):
        raise AssertionError("HS flow is not finite of shape "
                             f"{HS_SHAPE}: {tuple(flow[0].shape)}")
    cpu = [f.cpu() for f in frames]
    ref = []
    cpu_ms = host_ms(lambda: ref.extend(
        solvers.horn_schunck(*cpu, HS_WINDOW, HS_ITERS, HS_ALPHA)))
    err = check_close("horn_schunck card vs CPU", list(zip(flow, ref)),
                      PATH_TOL)
    ms = cuda_ms(lambda: solvers.horn_schunck(*frames, HS_WINDOW, HS_ITERS,
                                              HS_ALPHA))
    torch.cuda.synchronize()
    log("hs", shape=HS_SHAPE, max_abs_err_vs_cpu=err, max_abs_u=float(
        flow[0].abs().max()), card_ms_per_frame=ms,
        card_fps=1e3 / ms, cpu_f32_ms_per_frame=cpu_ms)
    from tpuflow_torch.kernels import hs_stencil

    for name, out in zip(("horn_schunck_resident", "horn_schunck_resident2"),
                         resident):
        err = check_close(f"{name} vs horn_schunck", list(zip(out, flow)),
                          PATH_TOL)
        fn = getattr(hs_stencil, name)
        ms = cuda_ms(lambda: fn(*frames, HS_WINDOW, HS_ITERS, HS_ALPHA))
        log("hs", path=name, shape=HS_SHAPE, max_abs_err_vs_horn_schunck=err,
            card_ms_per_frame=ms)
    window = WIDE_WINDOWS[0]
    ref = solvers.horn_schunck(*cpu, window, WIDE_ITERS, HS_ALPHA)
    if not all(bool(torch.isfinite(f).all()) and f.shape == HS_SHAPE
               for f in wide):
        raise AssertionError(f"HS window {window}: flow is not finite of "
                             f"shape {HS_SHAPE}")
    err = check_close(f"horn_schunck window {window} card vs CPU",
                      list(zip(wide, ref)), PATH_TOL)
    log("hs", shape=HS_SHAPE, window=window, iterations=WIDE_ITERS,
        max_abs_err_vs_cpu=err, max_abs_u=float(wide[0].abs().max()),
        card_ms_per_frame=cuda_ms(lambda: solvers.horn_schunck(
            *frames, window, WIDE_ITERS, HS_ALPHA)))


def phase_ba(frames, flow, blocks) -> None:
    import torch

    if flow[0].shape != BA_SHAPE or not all(
            bool(torch.isfinite(f).all()) for f in flow):
        raise AssertionError("BA flow is not finite of shape "
                             f"{BA_SHAPE}: {tuple(flow[0].shape)}")
    cpu = [f.cpu() for f in frames]
    ref, cpu_blocks = [], []
    cpu_ms = host_ms(lambda: ref.extend(ba_call(*cpu, blocks=cpu_blocks)))
    if cpu_blocks != blocks:
        raise AssertionError(f"BA blocks per level: card {blocks}, "
                             f"CPU {cpu_blocks}")
    err = check_close("optical_flow_pyramid_fast card vs CPU",
                      list(zip(flow, ref)), PATH_TOL)

    def run():
        ba_call(*frames)
        torch.cuda.synchronize()

    ms = host_ms(run, reps=5)  # syncs at every energy check anyway
    log("ba", shape=BA_SHAPE, blocks=blocks, max_abs_err_vs_cpu=err,
        max_abs_u=float(flow[0].abs().max()), card_ms_per_frame=ms,
        card_fps=1e3 / ms, cpu_f32_ms_per_frame=cpu_ms)
    profile_frame("ba", lambda: ba_call(*frames))


def check_flow_vs_cpu(name: str, flow, ref) -> float:
    """Card flow vs the float32 CPU run within PATH_TOL; past it, say
    where the largest difference is before failing."""
    err, mag = max_err(list(zip(flow, ref)))
    if not err <= PATH_TOL * max(1.0, mag):
        for comp, a, b in zip("uv", flow, ref):
            d = (a.cpu() - b).abs()
            y, x = divmod(int(d.argmax()), d.shape[1])
            print(f"    {name}: {comp} max|d|={float(d.max())} at (y={y}, "
                  f"x={x}) of {tuple(d.shape)}; card {float(a[y, x])}, CPU "
                  f"{float(b[y, x])}; pixels with |d| > 1e-3: "
                  f"{int((d > 1e-3).sum())}", flush=True)
    return check_close(f"{name} card vs CPU", list(zip(flow, ref)), PATH_TOL)


def phase_fb(runs, stream) -> None:
    """Each Farneback run: finite, of the frame's shape, equal to the same
    call on float32 CPU copies within PATH_TOL; card and CPU times."""
    import torch

    for name, cfg, kw, frames, flow in runs:
        shape = tuple(frames[0].shape)
        if tuple(flow[0].shape) != shape or not all(
                bool(torch.isfinite(f).all()) for f in flow):
            raise AssertionError(f"farneback {name}: flow is not finite of "
                                 f"shape {shape}")
        cpu = [f.cpu() for f in frames]
        ref = []
        cpu_ms = host_ms(lambda: ref.extend(fb_call(cpu, cfg, **kw)))
        err = check_flow_vs_cpu(f"farneback {name}", flow, ref)
        ms = cuda_ms(lambda: fb_call(frames, cfg, **kw))
        torch.cuda.synchronize()
        log("fb", config=name, params=cfg, shape=shape,
            max_abs_err_vs_cpu=err, max_abs_u=float(flow[0].abs().max()),
            card_ms_per_frame=ms, card_fps=1e3 / ms,
            chip_host_cpu_f32_ms_per_frame=cpu_ms)
        if name == FB_PROFILED:
            profile_frame("fb", lambda: fb_call(frames, cfg, **kw),
                          config=name)

    frames, out = stream
    if len(out) != STREAM_FRAMES - 1:
        raise AssertionError(f"dense_flow_stream yielded {len(out)} pairs")
    cpu_out = stream_call(frames, torch.device("cpu"))
    err = 0.0
    for (g, u, v), (gc, uc, vc) in zip(out, cpu_out):
        if u.shape != STREAM_WH[::-1] or not (np.isfinite(u).all()
                                             and np.isfinite(v).all()):
            raise AssertionError("dense_flow_stream: flow is not finite of "
                                 f"shape {STREAM_WH[::-1]}")
        err = max(err, check_flow_vs_cpu(
            "dense_flow_stream", [torch.from_numpy(u), torch.from_numpy(v)],
            [torch.from_numpy(uc), torch.from_numpy(vc)]))
    log("fb", config="dense_flow_stream", pairs=len(out),
        shape=STREAM_WH[::-1], max_abs_err_vs_cpu=err,
        mean_u=float(np.mean([o[1].mean() for o in out])))


def psnr(a, b) -> float:
    """PSNR in dB of two 0-255 images, over the frame less a 16-px border
    (where a compensated read falls outside the frame)."""
    d = (a - b)[16:-16, 16:-16].double()
    return float(10.0 * np.log10(255.0 ** 2 / float((d * d).mean())))


def bm_quality(dev, frames, out, bidirectional: bool) -> dict:
    """EPE of the BM field and of the composed flow against the known pan
    (inverse flow: +pan toward the previous frame, -pan toward the next),
    and the compensation PSNR of the interest frame against leaving it
    unmoved."""
    import torch

    from tpuflow_torch.core.color import rgb_to_gray
    from tpuflow_torch.pipeline.metrics import epe
    from tpuflow_torch.pipeline.motion_compensation import compensate

    gray = [rgb_to_gray(t) for t in f32(dev, *frames)]
    t = torch.from_numpy(out.t.astype(np.float32)).to(dev)
    true_u, true_v = -t * BM_PAN[1], -t * BM_PAN[0]
    u, v, bm_u, bm_v = f32(dev, out.u, out.v, out.bm_u, out.bm_v)
    prev_i, interest, next_i = (0, 1, 2) if bidirectional else (0, 1, 0)
    back = t < 0
    pred = torch.where(back, compensate(gray[prev_i], u, v, "bilinear"),
                       compensate(gray[next_i], u, v, "bilinear"))
    still = torch.where(back, gray[prev_i], gray[next_i])
    return {"epe_bm": float(epe(bm_u, bm_v, true_u, true_v)),
            "epe_uv": float(epe(u, v, true_u, true_v)),
            "psnr_compensated": psnr(pred, gray[interest]),
            "psnr_unmoved": psnr(still, gray[interest]),
            "share_t_next": float((~back).float().mean())}


def check_bm_vs_cpu(name, card, cpu) -> float:
    """Card vs CPU flagship outputs: equal segmentation, BM winners and
    time directions; u, v within PATH_TOL. Returns max |d| of u, v."""
    import torch

    seg, seg_cpu = card.segmentation, cpu.segmentation
    if seg.n_regions != seg_cpu.n_regions or not np.array_equal(
            seg.labels, seg_cpu.labels):
        raise AssertionError(f"{name}: segmentation differs: "
                             f"{seg.n_regions} vs {seg_cpu.n_regions} regions")
    for f in ("bm_u", "bm_v", "t"):
        a, b = getattr(card, f), getattr(cpu, f)
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: {f} differs at "
                                 f"{int((a != b).sum())} pixels")
    return check_flow_vs_cpu(name, [torch.from_numpy(card.u),
                                    torch.from_numpy(card.v)],
                             [torch.from_numpy(cpu.u),
                              torch.from_numpy(cpu.v)])


def phase_bm(dev, frames, outs, state, profiles) -> None:
    """The flagship: finite flow of the frame's shape, its quality against
    the known pan, card vs CPU on a crop, and the card's ms per pair; the
    same quality and times for BM_PROFILES; the search evaluators
    (:func:`phase_bm_methods`)."""
    import torch

    runs = {"default": outs, **{p: o for p, (o, _) in profiles.items()}}
    for profile, pair_outs in runs.items():
        for k, out in enumerate(pair_outs):
            fields = (out.u, out.v, out.bm_u, out.bm_v)
            if any(f.shape != BM_SHAPE or not np.isfinite(f).all()
                   for f in fields) or not set(np.unique(out.t)) <= {-1, 1}:
                raise AssertionError(f"flagship {profile} pair {k + 1}: flow "
                                     f"is not finite of shape {BM_SHAPE}")
            log("bm", profile=profile, pair=k + 1,
                bidirectional=out.bidirectional,
                n_regions=out.segmentation.n_regions,
                **bm_quality(dev, frames, out, out.bidirectional))
    log("bm", n_regions_frame3=state.segmentations[0].n_regions)

    crop = [f[BM_CROP] for f in frames]
    for profile in (None, *BM_PROFILES):
        kw = dict(search_range=BM_CROP_SEARCH, iter_max=BM_CROP_ITERS,
                  profile=profile)
        card, _ = bm_sequence(crop, dev, **kw)
        cpu = []
        cpu_ms = host_ms(lambda: cpu.extend(bm_sequence(crop, "cpu",
                                                        **kw)[0]))
        name = profile or "default"
        err = max(check_bm_vs_cpu(f"flagship {name} crop pair {k + 1}", a, b)
                  for k, (a, b) in enumerate(zip(card, cpu)))
        log("bm", profile=name, crop=tuple(crop[0].shape[:2]),
            search_range=BM_CROP_SEARCH, iter_max=BM_CROP_ITERS,
            n_regions=card[1].segmentation.n_regions,
            labels_winners_t_equal=True, max_abs_err_vs_cpu=err,
            chip_host_cpu_f32_ms_two_pairs=cpu_ms)

    from tpuflow_torch.kernels import bm_cost
    from tpuflow_torch.solvers import bm_flow
    from tpuflow_torch.solvers.bm_flow import BMFlowState

    for profile in (None, *BM_PROFILES):
        times = []
        for _ in range(2):
            st = BMFlowState()
            pair_ms, launches = [], []
            for k in (0, 1):
                before = bm_cost.LAUNCHES
                t0 = time.perf_counter()
                bm_pair(frames, k, st, dev, profile=profile)
                torch.cuda.synchronize()
                pair_ms.append(1e3 * (time.perf_counter() - t0))
                launches.append(bm_cost.LAUNCHES - before)
            times.append(pair_ms)
        if launches != [2, 2]:
            raise AssertionError(f"flagship {profile}: bm_cost launches "
                                 f"{launches} a pair, expected [2, 2]")
        log("bm", shape=BM_SHAPE, profile=profile or "default",
            card_ms_pair1_cold=[t[0] for t in times],
            card_ms_pair2_bidirectional=[t[1] for t in times],
            bm_cost_launches_pair=launches)
        if profile is None:
            profile_pair(frames, st, dev)
    seg = state.segmentations[1]
    bm_cost_row(dev, {}, "bm", [bm_flow._to_lab(f, 255.0)[1]
                                for f in frames], seg.labels, seg.n_regions)
    t0 = time.perf_counter()
    phase_bm_methods(dev, frames, state)
    log("bm", evaluators_seconds=time.perf_counter() - t0)


def crop_labels(labels: np.ndarray):
    """A crop's labels renumbered 0..n-1 in order, and n."""
    uniq, lab = np.unique(labels, return_inverse=True)
    return lab.reshape(labels.shape).astype(np.int32), len(uniq)


def phase_bm_methods(dev, frames, state) -> None:
    """Each search evaluator (matcher.METHODS) through
    ``block_matching_labels`` and the fused bidirectional search on pair
    2's inputs (the middle frame's Lab and segmentation, its neighbours),
    at full size with the flagship's search, ms per search; and on
    BM_CROP at BM_CROP_SEARCH against the float32 CPU: equal winners, costs
    within EVAL_COST_TOL."""
    import torch

    from tpuflow_torch.blockmatching import matcher
    from tpuflow_torch.solvers import bm_flow

    labs = [bm_flow._to_lab(f, 255.0)[1] for f in frames]
    seg = state.segmentations[1]
    sr = bm_flow.MultipleMotionParam().bm_search_range
    full = [x.to(dev) for x in labs]
    crop_lab, crop_n = crop_labels(seg.labels[BM_CROP])
    crops = [x[BM_CROP].contiguous() for x in labs]

    def searches(xs, labels, n, search_range, method):
        single = matcher.block_matching_labels(
            xs[1], xs[0], labels, n, search_range=search_range,
            method=method)
        pair = matcher.block_matching_bidirectional(
            xs[1], xs[0], xs[2], labels, n, search_range=search_range,
            method=method)
        return [single, *pair[:2]]

    # The single search's winners (middle frame toward the previous, t =
    # -1) against the known pan, pixel-weighted, and beside the
    # exhaustive search's: a search's own share of the flagship's BM-field
    # EPE (the refine never moves the BM field).
    pixels = np.bincount(seg.labels.ravel(), minlength=seg.n_regions)
    pan_uv = np.array([BM_PAN[1], BM_PAN[0]], np.float64)
    winners = {}
    for method in matcher.METHODS:
        single = []
        ms_single = synced_ms(lambda: single.append(
            matcher.block_matching_labels(
                full[1], full[0], seg.labels, seg.n_regions,
                search_range=sr, method=method)), reps=2)
        uv = winners[method] = single[-1].region_uv.astype(np.float64)
        quality = {
            "epe_vs_pan": float((np.hypot(*(uv - pan_uv).T) * pixels).sum()
                                / pixels.sum()),
            "share_regions_as_matmul": float(
                (uv == winners["matmul"]).all(1).mean()),
            "share_regions_over_1px_from_matmul": float(
                (np.abs(uv - winners["matmul"]).max(1) > 1.0).mean())}
        ms_bidi = synced_ms(lambda: matcher.block_matching_bidirectional(
            full[1], full[0], full[2], seg.labels, seg.n_regions,
            search_range=sr, method=method), reps=2)
        card = searches([x.to(dev) for x in crops], crop_lab, crop_n,
                        BM_CROP_SEARCH, method)
        cpu = searches(crops, crop_lab, crop_n, BM_CROP_SEARCH, method)
        cost_err = 0.0
        for a, b in zip(card, cpu):
            if not np.array_equal(a.region_uv, b.region_uv):
                raise AssertionError(
                    f"{method} crop: winners differ at "
                    f"{int((a.region_uv != b.region_uv).any(1).sum())} "
                    "regions")
            d = np.abs(a.region_cost - b.region_cost)
            lim = EVAL_COST_TOL * np.maximum(1.0, np.abs(b.region_cost))
            if not (d <= lim).all():
                raise AssertionError(f"{method} crop: cost max|d| "
                                     f"{float(d.max())}")
            cost_err = max(cost_err, float(d.max()))
        log("bm", method=method, shape=BM_SHAPE, search_range=sr,
            n_regions=seg.n_regions, card_ms_search=ms_single,
            card_ms_bidirectional=ms_bidi, **quality,
            crop=tuple(crops[0].shape[:2]),
            crop_search_range=BM_CROP_SEARCH, crop_regions=crop_n,
            crop_winners_equal=True, crop_cost_max_abs_err_vs_cpu=cost_err)
    torch.cuda.synchronize()


def profile_pair(frames, state, dev, top: int = 8) -> None:
    """One steady-state pair under torch.profiler."""
    profile_frame("bm", lambda: bm_pair(frames, 1, state, dev), top)


def profile_frame(phase: str, fn, top: int = 8, **what) -> None:
    """One call of fn under torch.profiler: the device's busy time against
    the host clock, and the device ops that take the most time. Only the
    device's activity is traced: host op events add nothing to these
    numbers and cost the profiler up to a minute on a frame of ~10^5
    eager ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(phase, **what, profile_wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        profile_seconds=time.perf_counter() - t0)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(phase, **what, profile_op=json.dumps(e.key[:60]),
            ms=e.self_device_time_total / 1e3, calls=e.count)


# -- Lucas-Kanade and the affine fits ----------------------------------------


def synced_ms(fn, reps: int = 3) -> list[float]:
    """Host-clock ms of each of ``reps`` calls of fn(), each ending in a
    synchronize (the caller's view: a path's host syncs included)."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def corners(frame):
    from tpuflow_torch.solvers import good_features_to_track

    return good_features_to_track(frame, *LK_CORNERS)


def track(prev, nxt, pts):
    from tpuflow_torch.solvers import track_points

    return track_points(prev, nxt, pts, **LK_TRACK)


def dense_lk(prev, nxt):
    from tpuflow_torch.solvers import dense_lucas_kanade

    return dense_lucas_kanade(prev, nxt, **DENSE_LK)


def track_frames():
    from tpuflow_torch.pipeline.streaming import SyntheticSource

    h, w = TRACK_HW
    dx, dy = TRACK_SHIFT
    return list(SyntheticSource(n_frames=TRACK_FRAMES, h=h, w=w, dx=dx,
                                dy=dy))


def tracking_stream(frames, device):
    """feature_tracking_stream over ``frames``; returns its outputs and
    the number of re-seeds it logged."""
    import io

    from tpuflow_torch.pipeline.streaming import feature_tracking_stream
    from tpuflow_torch.utils import telemetry

    sink = io.StringIO()
    old = telemetry.get_telemetry()
    telemetry.set_telemetry(telemetry.Telemetry(sink))
    try:
        outs = list(feature_tracking_stream(frames, *LK_CORNERS,
                                            device=device))
    finally:
        telemetry.set_telemetry(old)
    reseeds = sum(json.loads(line)["event"] == "stream.reseed"
                  for line in sink.getvalue().splitlines())
    return outs, reseeds


def main_lk(dev, totals: dict):
    """The Lucas-Kanade paths once each, counted: the corners (5 sepconv
    launches), the tracking (no kernel), dense LK at 1080x1920 (33) and
    the tracking stream (5 a re-seed)."""
    prev, nxt = f32(dev, *frames_kitti())
    pts = counted("good_features_to_track", lambda: corners(prev),
                  {"sep_conv2d_valid": 5}, totals)
    tracked = counted("track_points", lambda: track(prev, nxt, pts), {},
                      totals)
    hd = f32(dev, *frames_1080p())
    levels, iters = DENSE_LK["levels"], DENSE_LK["iters"]
    dense = counted("dense_lucas_kanade", lambda: dense_lk(*hd),
                    {"sep_conv2d_valid": levels * (2 + 3 + 2 * iters)},
                    totals)
    frames = track_frames()
    stream = counted("feature_tracking_stream",
                     lambda: tracking_stream(frames, dev),
                     lambda r: {"sep_conv2d_valid": 5 * r[1]}, totals)
    return (prev, nxt, pts, tracked), (hd, dense), (frames, stream)


def check_tracks(name, card, cpu, max_tol=LK_MAX_TOL) -> dict:
    """Card vs CPU tracked points: equal status, the displacement's
    median and max |d| within LK_MEDIAN_TOL and ``max_tol`` px."""
    (p, st), (pc, stc) = card, cpu
    p, st = p.cpu().numpy().astype(np.float64), st.cpu().numpy()
    pc, stc = np.asarray(pc, np.float64), np.asarray(stc)
    if not np.array_equal(st, stc):
        raise AssertionError(f"{name}: status differs at "
                             f"{int((st != stc).sum())} of {len(st)} points")
    d = np.hypot(*(p - pc).T)
    med, mx = float(np.median(d)), float(d.max())
    if not (med <= LK_MEDIAN_TOL and mx <= max_tol):
        raise AssertionError(f"{name}: card vs CPU |d| median {med}, max "
                             f"{mx} px (tolerance {LK_MEDIAN_TOL}, "
                             f"{max_tol})")
    return {"points": len(st), "status_ok": int(st.sum()),
            "median_abs_d_px": med, "max_abs_d_px": mx,
            "points_moved": int((d > 0).sum())}


def phase_lk(dev, sparse, dense, stream) -> None:
    """Lucas-Kanade on the card against the float32 CPU: the Shi-Tomasi
    response (within an ulp of its square root) and the corner list
    (equal), the tracking (status, displacement), the known KITTI shift,
    dense LK on a crop within PATH_TOL, the stream; ms per call, a
    profiler frame each of sparse tracking, dense LK at 1080x1920 and the
    stream."""
    import torch

    from tpuflow_torch.solvers import lucas_kanade

    t0 = time.perf_counter()
    prev, nxt, pts, (new_pts, status) = sparse
    cprev, cnxt = prev.cpu(), nxt.cpu()
    resp = lucas_kanade.min_eigenvalue_response(prev).cpu()
    resp_cpu = lucas_kanade.min_eigenvalue_response(cprev)
    # The sepconv kernel is bitwise its plain version and the rest is IEEE
    # elementwise arithmetic, except the square root: the card's is
    # correctly rounded, PyTorch's CPU float32 one is an ulp off at ~0.7%
    # of elements. So the two responses may differ by one ulp of the root
    # (at most tr/2) and the subtraction's rounding (one ulp of the
    # response), and nowhere more.
    sxx, syy, _ = lucas_kanade.structure_tensor(cprev)
    ulp = (np.spacing(np.abs((sxx + syy).numpy() / np.float32(2)))
           + np.spacing(np.abs(resp_cpu.numpy())))
    d = (resp - resp_cpu).abs().numpy()
    if not (d <= ulp).all():
        raise AssertionError("the Shi-Tomasi response differs from the CPU's "
                             f"by more than an ulp of its square root at "
                             f"{int((d > ulp).sum())} pixels")
    pts_cpu = corners(cprev)
    if not np.array_equal(pts, pts_cpu):
        raise AssertionError(f"good_features_to_track: card {len(pts)} "
                             f"corners, CPU {len(pts_cpu)}, not the same "
                             "list")
    found = pts.shape[0]
    tracks = check_tracks("track_points", (new_pts, status),
                          track(cprev, cnxt, pts))
    ok = status.cpu().numpy()
    moved = new_pts.cpu().numpy()[ok] - pts[ok]
    err = np.hypot(moved[:, 0] - LK_SHIFT[0], moved[:, 1] - LK_SHIFT[1])
    if not np.median(err) < LK_SHIFT_TOL:
        raise AssertionError(f"track_points: median error {np.median(err)}"
                             f" px against the known shift {LK_SHIFT}")
    log("lk", path="sparse", shape=tuple(prev.shape), corners=found,
        shi_tomasi_max_abs_d_vs_cpu=float(d.max()),
        shi_tomasi_px_differing=int((d > 0).sum()),
        median_err_vs_known_shift_px=float(np.median(err)),
        max_err_vs_known_shift_px=float(err.max()), **tracks,
        card_ms_corners=synced_ms(lambda: corners(prev)),
        card_ms_track=synced_ms(lambda: track(prev, nxt, pts), 5),
        chip_host_cpu_f32_ms_track=host_ms(lambda: track(cprev, cnxt, pts)))
    profile_frame("lk", lambda: track(prev, nxt, pts), path="track_points")

    hd, (u, v) = dense
    if tuple(u.shape) != HS_SHAPE or not all(
            bool(torch.isfinite(f).all()) for f in (u, v)):
        raise AssertionError(f"dense LK: flow is not finite of {HS_SHAPE}")
    crop = [f[DENSE_LK_CROP].contiguous() for f in hd]
    err = check_flow_vs_cpu("dense LK crop", dense_lk(*crop),
                            dense_lk(*(f.cpu() for f in crop)))
    log("lk", path="dense", shape=HS_SHAPE, **DENSE_LK,
        median_u=float(u.median()), median_v=float(v.median()),
        crop=tuple(crop[0].shape), max_abs_err_vs_cpu=err,
        card_ms=synced_ms(lambda: dense_lk(*hd)))
    profile_frame("lk", lambda: dense_lk(*hd), path="dense_lucas_kanade")

    frames, (outs, reseeds) = stream
    if len(outs) != TRACK_FRAMES - 1:
        raise AssertionError(f"feature_tracking_stream: {len(outs)} outputs")
    cpu_outs, cpu_reseeds = tracking_stream(frames, "cpu")
    med = mx = 0.0
    for k, ((g, p, pp, acc), (gc, pc, ppc, accc)) in enumerate(
            zip(outs, cpu_outs)):
        if not np.array_equal(acc, accc):
            raise AssertionError(f"stream frame {k + 1}: accepted tracks "
                                 "differ from the CPU's")
        both = check_tracks(f"stream frame {k + 1}",
                            (torch.from_numpy(p), torch.from_numpy(acc[acc])),
                            (pc, accc[accc]), STREAM_MAX_TOL)
        med, mx = max(med, both["median_abs_d_px"]), max(
            mx, both["max_abs_d_px"])
    d = outs[-1][1] - outs[-1][2]
    log("lk", path="feature_tracking_stream", shape=TRACK_HW,
        frames=TRACK_FRAMES, reseeds=reseeds, cpu_reseeds=cpu_reseeds,
        kept=[len(o[1]) for o in outs],
        median_step_px=(float(np.median(d[:, 0])),
                        float(np.median(d[:, 1]))),
        median_abs_d_vs_cpu_px=med, max_abs_d_vs_cpu_px=mx,
        card_ms_stream=synced_ms(lambda: tracking_stream(frames, dev), 2))
    profile_frame("lk", lambda: tracking_stream(frames, dev),
                  path="feature_tracking_stream")
    log("lk", seconds=time.perf_counter() - t0)


def affine_call(frames, device):
    from tpuflow_torch.core.config import MultipleMotionParam
    from tpuflow_torch.solvers import multiple_motion_affine

    return multiple_motion_affine(*frames, 255.0,
                                  MultipleMotionParam(level=AFFINE_LEVEL))


def main_affine(dev, totals: dict, bm_outs):
    """The affine paths once each, counted: the global fit (no kernel),
    the flagship in mode AFFINE over the Voronoi pan (two filter launches,
    then one; no gated sweep) and bm_flow_stream (default mode) over the
    same three frames, checked against phase main's sequential pairs."""
    from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
    from tpuflow_torch.pipeline.streaming import bm_flow_stream
    from tpuflow_torch.solvers.bm_flow import BMFlowState

    kitti = f32(dev, *frames_kitti())
    t0 = time.perf_counter()
    a = counted("multiple_motion_affine", lambda: affine_call(kitti, dev),
                {}, totals)
    a_ms = 1e3 * (time.perf_counter() - t0)
    frames, _ = voronoi_frames()
    blocks, pair_ms = [], []
    state = BMFlowState()
    kw = dict(mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING, blocks=blocks)
    t0 = time.perf_counter()
    out1, state = counted("flagship_affine_pair1_cold",
                          lambda: bm_pair(frames, 0, state, dev, **kw),
                          {"mean_shift_filter": 2}, totals)
    pair_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    out2, state = counted("flagship_affine_pair2_bidirectional",
                          lambda: bm_pair(frames, 1, state, dev, **kw),
                          {"mean_shift_filter": 1}, totals)
    pair_ms.append(1e3 * (time.perf_counter() - t0))
    if blocks != [0, 0]:
        raise AssertionError(f"mode AFFINE ran gated sweeps: {blocks}")
    sblocks = []
    stream = counted(
        "bm_flow_stream", lambda: list(bm_flow_stream(
            frames, device=dev, blocks=sblocks)),
        lambda _: {"mean_shift_filter": 3,
                   "irls_gated_sweeps": sum(sblocks)}, totals)
    for k, (o_s, o_q) in enumerate(zip(stream, bm_outs)):
        for f in ("u", "v", "t", "bm_u", "bm_v"):
            if not np.array_equal(getattr(o_s, f), getattr(o_q, f)):
                raise AssertionError(f"bm_flow_stream pair {k + 1}: {f} "
                                     "differs from the sequential driver")
    if len(stream) != 2:
        raise AssertionError(f"bm_flow_stream yielded {len(stream)} pairs")
    return (kitti, a, a_ms), (frames, (out1, out2), state, pair_ms)


def affine_crop_inputs(dev, state, out, crop=None):
    """Pair 2's per-region fit inputs toward the previous frame, cut to
    ``crop`` (default BM_CROP) and relabelled 0..n-1: (reference Lab,
    interest Lab, mv_u, mv_v) on ``dev``, the labels and the region
    count."""
    import torch

    crop = BM_CROP if crop is None else crop
    labels = state.segmentations[1].labels[crop]
    uniq, inv = np.unique(labels, return_inverse=True)
    fields = [state.lab_frames[2][crop], state.lab_frames[1][crop],
              torch.from_numpy(out.bm_u[crop]),
              torch.from_numpy(out.bm_v[crop])]
    return ([f.to(dev).contiguous() for f in fields],
            inv.reshape(labels.shape).astype(np.int32), len(uniq))


def phase_affine(dev, glob, flagship) -> None:
    """The global fit: the recovered translation against the known KITTI
    shift, card vs float32 CPU on BM_CROP of the frames (within
    PATH_TOL), ms per call; the flagship in mode AFFINE: finite flow of
    the frame's shape, EPE against the pan, ms per pair, its per-region
    fit card vs CPU on a crop of pair 2's inputs (within PATH_TOL); a
    profiler frame each of the global fit and pair 2."""
    from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
    from tpuflow_torch.pyramid import dt_level, grad_level
    from tpuflow_torch.solvers import affine_parametric_flow
    from tpuflow_torch.solvers.affine import (SIGMA_D_AFFINE,
                                              irls_affine_level)
    from tpuflow_torch.solvers.bm_flow import BMFlowState
    from tpuflow_torch.utils.numerics import true_div

    t0 = time.perf_counter()
    kitti, a, a_ms = glob
    norm = [true_div(f, 255.0) for f in kitti]
    h, w = kitti[0].shape
    a_np = a.cpu().numpy().astype(np.float64)
    centre = (float(a_np[0] + a_np[1] * w / 2 + a_np[2] * h / 2),
              float(a_np[3] + a_np[4] * w / 2 + a_np[5] * h / 2))
    shift = np.asarray(LK_SHIFT)
    along = float(np.dot(centre, shift) / np.dot(shift, shift))
    across = float(abs(centre[0] * shift[1] - centre[1] * shift[0])
                   / np.hypot(*shift))
    lo, hi = AFFINE_ALONG
    if not (np.isfinite(a_np).all() and lo <= along <= hi
            and across <= AFFINE_ACROSS):
        raise AssertionError(f"multiple_motion_affine: a = {a_np}, flow at "
                             f"the centre {centre}: {along} of the known "
                             f"shift {LK_SHIFT}, {across} px across it")
    crop = [f[BM_CROP].contiguous() for f in kitti]
    err = check_close("multiple_motion_affine crop card vs CPU",
                      [(affine_call(crop, dev), affine_call(
                          [f.cpu() for f in crop], "cpu"))], PATH_TOL)
    log("affine", path="multiple_motion_affine", shape=(h, w),
        level=AFFINE_LEVEL, a=a_np.tolist(), flow_at_centre=centre,
        known_shift=LK_SHIFT, share_along_shift=along,
        px_across_shift=across, crop=tuple(crop[0].shape),
        max_abs_err_vs_cpu=err,
        card_ms=[a_ms] + synced_ms(lambda: affine_call(kitti, dev), 1))
    # The loop's busy share from AFFINE_PROFILED iterations of the finest
    # level (the whole fit is ~4,900 and its trace takes longer to read
    # than to run).
    gx, gy = grad_level(*norm)  # the two-frame sum, as the fit takes it
    profile_frame("affine", lambda: irls_affine_level(
        a, gx, gy, dt_level(*norm), SIGMA_D_AFFINE, AFFINE_PROFILED, 0.0),
        path="irls_affine_level", iterations=AFFINE_PROFILED)

    frames, outs, state, pair_ms = flagship
    for k, out in enumerate(outs):
        fields = (out.u, out.v, out.bm_u, out.bm_v)
        if any(f.shape != BM_SHAPE or not np.isfinite(f).all()
               for f in fields):
            raise AssertionError(f"flagship AFFINE pair {k + 1}: flow is "
                                 f"not finite of shape {BM_SHAPE}")
        quality = bm_quality(dev, frames, out, out.bidirectional)
        if not quality["epe_uv"] < AFFINE_EPE_TOL:
            raise AssertionError(f"flagship AFFINE pair {k + 1}: EPE "
                                 f"{quality['epe_uv']} px against the pan")
        log("affine", path="flagship_affine", pair=k + 1,
            n_regions=out.segmentation.n_regions, **quality)
    fields, labels, n = affine_crop_inputs(dev, state, outs[1])
    kw = dict(iter_max=256, normalize_steps=True)
    card = affine_parametric_flow(*fields, labels, n, **kw)
    cpu = affine_parametric_flow(*(f.cpu() for f in fields), labels, n, **kw)
    err = check_close("affine_parametric_flow crop card vs CPU",
                      list(zip(card, cpu)), PATH_TOL)
    st = BMFlowState()
    times = [pair_ms, [synced_ms(lambda k=k: bm_pair(
        frames, k, st, dev, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING),
        1)[0] for k in (0, 1)]]
    log("affine", path="flagship_affine", shape=BM_SHAPE,
        crop=tuple(labels.shape), crop_regions=n, max_abs_err_vs_cpu=err,
        card_ms_region_fit_crop=synced_ms(
            lambda: affine_parametric_flow(*fields, labels, n, **kw)),
        card_ms_pair1_cold=[t[0] for t in times],
        card_ms_pair2_bidirectional=[t[1] for t in times])
    profile_frame("affine", lambda: bm_pair(
        frames, 1, st, dev, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING),
        path="flagship_affine_pair2")
    log("affine", seconds=time.perf_counter() - t0)


# -- the sharded path ---------------------------------------------------------


# -- The pair demos and the host labeler ---------------------------------------


def demo_frames():
    """DEMO_SHAPE 8-bit RGB pair: smoothed noise per channel stretched to
    0-255, the next frame the scene moved by DEMO_SHIFT."""
    from scipy.ndimage import gaussian_filter

    h, w = DEMO_SHAPE
    dx, dy = DEMO_SHIFT
    rng = np.random.default_rng(12)
    base = gaussian_filter(rng.uniform(0, 255, (h + 8, w + 8, 3)),
                           (2.0, 2.0, 0))
    base = (base - base.min()) * (255.0 / (base.max() - base.min()))
    prev = np.rint(base[4 : 4 + h, 4 : 4 + w]).astype(np.uint8)
    nxt = np.rint(base[4 - dy : 4 - dy + h, 4 - dx : 4 - dx + w])
    return prev, nxt.astype(np.uint8)


def write_demo_files(folder: Path) -> dict:
    """The demo pair as gray PGM, RGB PPM and RGB PNG files."""
    from tpuflow_torch.core.io import write_image, write_pnm
    from tpuflow_torch.pipeline.demos import _cvt_gray_fixed

    prev, nxt = demo_frames()
    files = {}
    for ext in (".pgm", ".ppm", ".png"):
        pair = []
        for name, img in (("prev", prev), ("next", nxt)):
            path = folder / f"{name}{ext}"
            if ext == ".pgm":
                write_pnm(path, _cvt_gray_fixed(img).astype(np.uint8))
            elif ext == ".ppm":
                write_pnm(path, img)
            else:
                write_image(path, img)
            pair.append(str(path))
        files[ext] = pair
    return files


def read_matrix_txt(path) -> np.ndarray:
    """A write_matrix_txt dump (cv::FileStorage YAML) back as float64."""
    import re

    text = Path(path).read_text()
    rows = int(re.search(r"rows: (\d+)", text).group(1))
    cols = int(re.search(r"cols: (\d+)", text).group(1))
    body = text[text.index("data: [") + 7 : text.rindex("]")]
    special = {".Nan": math.nan, ".Inf": math.inf, "-.Inf": -math.inf}
    vals = [special[t] if t in special else float(t)
            for t in (x.strip() for x in body.split(","))]
    return np.array(vals, dtype=np.float64).reshape(rows, cols)


def demo_runs(files: dict, out: Path, device):
    """The four demo calls on ``device`` (float32), each writing under
    ``out``: name -> (call, the launches it makes on the card)."""
    from tpuflow_torch.kernels import hs_stencil
    from tpuflow_torch.pipeline import demos

    lk_count, lk_quality, lk_dist, lk_motion = DEMO_LK
    return {
        "hs": (lambda: demos.demo_horn_schunck(
            *files[".pgm"], f"{out}/hs_", HS_WINDOW, HS_ITERS, HS_ALPHA,
            device=device),
            {"hs_sweeps": math.ceil(HS_ITERS / hs_stencil.DEFAULT_FUSE)}),
        "fb": (lambda: demos.demo_farneback_pair(
            *files[".ppm"], f"{out}/fb_", *FB_DEMO, device=device),
            fb_expected(FB_DEMO)),
        "fb_matrices": (lambda: demos.demo_farneback_pair(
            *files[".png"], f"{out}/fbm_", *FB_DEMO3, write_matrices=True,
            device=device), fb_expected(FB_DEMO3)),
        "lk": (lambda: demos.demo_lucas_kanade(
            *files[".png"], f"{out}/lk_tracks.png", lk_count, lk_quality,
            lk_dist, lk_motion, device=device), {"sep_conv2d_valid": 5}),
    }


def check_demo_files(name: str, files: dict, out: Path, result) -> None:
    """The files a demo wrote read back equal to what it returned: the
    matrix dumps to u, v exactly, each PNG to the same drawing made again
    on the host from the returned arrays."""
    from tpuflow_torch.core.io import read_image
    from tpuflow_torch.viz.quiver import (draw_tracks_cv, plot_quiver,
                                          plot_quiver_cv)

    def same(path, want):
        got = read_image(path)[0]
        if not np.array_equal(got, want):
            raise AssertionError(f"demo {name}: {path} differs from the "
                                 "returned result's drawing")

    if name == "lk":
        pts, new, acc = result
        nxt = read_image(files[".png"][1])[0]
        same(out / "lk_tracks.png", draw_tracks_cv(
            nxt, pts[acc], new[acc], line_color=(255, 0, 0),
            dot_color=(0, 255, 0), dot_radius=3))
        return
    u, v = result
    if name == "hs":
        prev = read_image(files[".pgm"][0])[0]
        for comp, arr in (("u", u), ("v", v)):
            if not np.array_equal(read_matrix_txt(
                    out / f"hs_{comp}MatrixHS.txt"), arr.astype(np.float64)):
                raise AssertionError(f"demo hs: {comp}MatrixHS.txt differs")
        same(out / "hs_hsbresenhamLineFlow.png",
             plot_quiver(prev, u, v, delta=20, scale=20.0, outlier=5))
        return
    ext, prefix = (".ppm", "fb_") if name == "fb" else (".png", "fbm_")
    winsize = (FB_DEMO if name == "fb" else FB_DEMO3)[2]
    prev, nxt = (read_image(f)[0] for f in files[ext])
    same(out / f"{prefix}Farneback-{winsize}.png", plot_quiver_cv(
        nxt, u, v, delta=10, scale=10.0, line_color=(0, 0, 255),
        dot_color=(255, 0, 0), dot_radius=0))
    if name == "fb_matrices":
        for comp, arr in (("u", u), ("v", v)):
            if not np.array_equal(read_matrix_txt(
                    out / f"fbm_{comp}MatrixFB.txt"), arr.astype(np.float64)):
                raise AssertionError(f"demo fb: {comp}MatrixFB.txt differs")
        same(out / "fbm_fbbresenhamLineFlow.png",
             plot_quiver(prev, u, v, delta=20, scale=300.0, outlier=5))


def phase_demos(dev, totals: dict) -> None:
    """The three pair demos from files to files: each on the card once
    with the launch counts zeroed just before and read just after (the
    launches join the main paths'), its files checked against what it
    returned, then the same demo on the float32 CPU (u, v within
    PATH_TOL; LK: the same corners and accept mask, points within
    LK_MEDIAN_TOL / LK_MAX_TOL px), then ms from file read to file
    written on the card (median of 3, after the counted run)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpuflow_demos_") as tmp:
        tmp = Path(tmp)
        files = write_demo_files(tmp)
        (tmp / "card").mkdir()
        (tmp / "cpu").mkdir()
        card = demo_runs(files, tmp / "card", dev)
        cpu = demo_runs(files, tmp / "cpu", torch.device("cpu"))
        for name, (fn, expected) in card.items():
            got = counted(f"demo_{name}", fn, expected, totals)
            check_demo_files(name, files, tmp / "card", got)
            t = time.perf_counter()
            ref = cpu[name][0]()
            cpu_ms = 1e3 * (time.perf_counter() - t)
            if name == "lk":
                pts, new, acc = got
                cpts, cnew, cacc = ref
                if not np.array_equal(pts, cpts):
                    raise AssertionError(f"demo lk: card {len(pts)} corners, "
                                         f"CPU {len(cpts)}, not the same list")
                if not np.array_equal(acc, cacc):
                    raise AssertionError("demo lk: accept masks differ at "
                                         f"{int((acc != cacc).sum())} points")
                d = np.hypot(*(new.astype(np.float64) - cnew).T)
                if not (np.median(d) <= LK_MEDIAN_TOL and d.max() <= LK_MAX_TOL):
                    raise AssertionError(f"demo lk: card vs CPU |d| median "
                                         f"{np.median(d)}, max {d.max()} px")
                moved = np.median(new[acc] - pts[acc], axis=0)
                numbers = {"corners": len(pts), "accepted": int(acc.sum()),
                           "median_abs_d_px": float(np.median(d)),
                           "max_abs_d_px": float(d.max()),
                           "median_motion_px": moved.tolist()}
            else:
                flow = [torch.from_numpy(a) for a in got]
                if tuple(flow[0].shape) != DEMO_SHAPE or not all(
                        bool(torch.isfinite(f).all()) for f in flow):
                    raise AssertionError(f"demo {name}: flow is not finite "
                                         f"of shape {DEMO_SHAPE}")
                numbers = {"max_abs_err_vs_cpu": check_flow_vs_cpu(
                    f"demo {name}", flow, [torch.from_numpy(a) for a in ref]),
                    "max_abs_u": float(flow[0].abs().max())}
            ms = host_ms(fn, reps=3)
            log("demos", demo=name, shape=DEMO_SHAPE, **numbers,
                card_ms_file_to_file=ms,
                chip_host_cpu_f32_ms_file_to_file=cpu_ms)
    log("demos", seconds=time.perf_counter() - t0)


def labeler_row(dev) -> None:
    """The flagship's host labeling on its 376x1240 middle frame (the
    card's mean-shift filter output): the native labeler against its
    plain version (scipy), equal labels and region counts, ms each."""
    from tpuflow_torch import native
    from tpuflow_torch.segmentation import meanshift
    from tpuflow_torch.solvers import bm_flow

    lab = bm_flow._to_lab(voronoi_frames()[0][1], 255.0)[1].to(dev)
    pos, col = (x.cpu().numpy() for x in meanshift.mean_shift_filter(
        lab, MS_R, MS_KI, MS_ITERS))
    args = (pos, col, float(MS_R), float(MS_KI), LABEL_MIN_SIZE)
    labels, n = native.label_regions(*args)
    plain, n_plain = meanshift._merge_labels_plain(*args)
    if n != n_plain or not np.array_equal(labels, plain):
        raise AssertionError(f"label_regions: {n} regions, the plain "
                             f"version {n_plain}; labels differ at "
                             f"{int((labels != plain).sum())} pixels")
    native_ms = host_ms(lambda: native.label_regions(*args), reps=5)
    plain_ms = host_ms(lambda: meanshift._merge_labels_plain(*args), reps=3)
    log("bm", labeler="label_regions", shape=tuple(pos.shape[:2]), regions=n,
        labels_equal=True, native_ms=native_ms, plain_ms=plain_ms,
        plain_over_native=plain_ms / native_ms)


def ba_sharded_call(prev, nxt, mesh, sweeps=None):
    from tpuflow_torch.core.config import MultipleMotionParam
    from tpuflow_torch.dist import optical_flow_pyramid_sharded

    param = MultipleMotionParam(level=BA_LEVEL, error_min_threshold=0.0)
    return optical_flow_pyramid_sharded(prev, nxt, mesh, 255.0, param,
                                        iter_max=BA_ITER_MAX, fuse=BA_FUSE,
                                        sweeps=sweeps)


def fused_level(shape, mesh_shape) -> bool:
    """Whether the sharded pyramid runs a level of this (h, w) fused on a
    (ty, tx) mesh (dist/pyramid.py's first branch)."""
    (h, w), (ty, tx) = shape, mesh_shape
    return (h % ty == 0 and w % tx == 0 and h // ty > BA_FUSE
            and w // tx > BA_FUSE)


def ba_mesh_reference(prev, nxt, mesh_shape, sweeps):
    """The single-device port of what the sharded pyramid computes on a
    mesh of this shape: a level whose tiles take the fused branch relaxes
    as ``irls_level_fast`` (stop checks every BA_FUSE sweeps above level
    0), any other as ``irls_optical_flow_level`` (after every sweep, as the
    unfused and the replicated branch check). ``sweeps`` gets each level's
    sweeps, coarsest first."""
    from tpuflow_torch.core.config import MultipleMotionParam
    from tpuflow_torch.solvers.black_anandan import (
        LAMBDA_D, LAMBDA_S, coarse_to_fine, irls_optical_flow_level)
    from tpuflow_torch.solvers.black_anandan_fast import irls_level_fast

    param = MultipleMotionParam(level=BA_LEVEL, error_min_threshold=0.0)

    def solve_level(level, u0, v0, gx, gy, it_l, sigma_d, sigma_s, iters):
        if fused_level(it_l.shape, mesh_shape):
            u, v, _, b, _ = irls_level_fast(u0, v0, gx, gy, it_l, sigma_d,
                                            sigma_s, iters, 0.0, level == 0,
                                            BA_FUSE)
            sweeps.append(b * BA_FUSE)
        else:
            u, v, _, n, _ = irls_optical_flow_level(
                u0, v0, gx, gy, it_l, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
                iters, 0.0, level == 0)
            sweeps.append(n)
        return u, v

    return coarse_to_fine(prev, nxt, 255.0, param, BA_ITER_MAX, 1.0,
                          solve_level)


def ba_sharded_expected(mesh, sweeps) -> dict:
    """Launches of the sharded pyramid from the sweeps each level ran: a
    fused level launches the tile kernel once per block, a replicated one
    irls_sweeps once per sweep, an unfused sharded one no kernel (the
    branch of dist/pyramid.py)."""
    from tpuflow_torch.pyramid.pyramid import pyramid_sizes

    ty, tx = mesh.shape
    sizes = pyramid_sizes(BA_SHAPE[1], BA_SHAPE[0], BA_LEVEL)[::-1]
    if len(sizes) != len(sweeps):
        raise AssertionError(f"BA sharded: {len(sweeps)} levels, expected "
                             f"{len(sizes)}")
    want = {"irls_tile_sweeps": 0, "irls_sweeps": 0}
    for (w, h), n in zip(sizes, sweeps):
        if fused_level((h, w), (ty, tx)):
            want["irls_tile_sweeps"] += n // BA_FUSE
        elif not (h % ty == 0 and w % tx == 0 and h // ty >= 2
                  and w // tx >= 2):
            want["irls_sweeps"] += n
    return want


def on_card(dev) -> bool:
    return dev.type == "cuda"


def dist_ops_inputs(dev) -> dict:
    """The sharded L1 ops' inputs at BM_SHAPE on ``dev``: phase
    pipeline's first scratch frame (integer-valued) and the dense HOG
    descriptors of the pan's first two gray frames (scaled to [0, 1])."""
    from tpuflow_torch.features import hog_descriptor

    _, gray = pan_frames_np()
    scr, g0, g1 = (torch_on(dev, a) for a in (scratch_frames_np(1)[0],
                                              *gray[:2]))
    feats = [hog_descriptor(g / 255.0, 16, True, True)[1] for g in (g0, g1)]
    return {"scr": scr, "feats": feats}


def dist_ops_calls(mesh, inp: dict) -> dict:
    """key -> the sharded call on ``mesh`` (or, with mesh None, its
    single-device counterpart: gaussian_filter_sharded's is conv2d of its
    2-D kernel)."""
    import torch

    from tpuflow_torch import dist as D
    from tpuflow_torch import ops
    from tpuflow_torch.detection import detect_scratch
    from tpuflow_torch.features import hog_matching

    scr, (f0, f1) = inp["scr"], inp["feats"]
    taps = (PIPE_GAUSS_TAPS, PIPE_GAUSS_TAPS)
    if mesh is None:
        return {
            "ops_epsilon": lambda: ops.epsilon_filter(scr, taps, 20.0),
            "ops_median": lambda: ops.horizontal_median(scr, 3),
            "ops_gaussian": lambda: ops.conv2d(scr, ops.gaussian_kernel(
                taps, 5.0, torch.float32)),
            "ops_scratch": lambda: torch.stack(detect_scratch(scr)),
            "ops_hog_matching": lambda: torch.stack(hog_matching(f0, f1))}
    return {
        "ops_epsilon": lambda: D.epsilon_filter_sharded(scr, taps, 20.0,
                                                        mesh),
        "ops_median": lambda: D.horizontal_median_sharded(scr, 3, mesh),
        "ops_gaussian": lambda: D.gaussian_filter_sharded(scr, taps, 5.0,
                                                          mesh),
        "ops_scratch": lambda: torch.stack(D.detect_scratch_sharded(scr,
                                                                    mesh)),
        "ops_hog_matching": lambda: torch.stack(D.hog_matching_sharded(
            f0, f1, mesh))}


DIST_OPS = ("ops_epsilon", "ops_median", "ops_gaussian", "ops_scratch",
            "ops_hog_matching")


def dist_rank(mesh, full: bool):
    """The sharded path's calls on this rank's mesh (see the module
    docstring, phase 6). On a card each call runs with the launch counts
    zeroed just before and read just after, and is timed; ``full`` adds the
    weak-scaling row and the profiler frames. Rank 0's results return as
    CPU tensors with the counts and times."""
    import torch

    from tpuflow_torch import dist as D

    dev = mesh.device
    card = on_card(dev)
    hs_frames = f32(dev, *frames_4k())
    ba_frames = f32(dev, *frames_kitti())
    totals, times, res = {}, {}, {}
    weak_frames = f32(dev, *weak_frames_np())

    def run(path, fn, expected):
        return counted(path, fn, expected, totals) if card else fn()

    def timed(key, fn, reps):
        if card:
            def synced():
                fn()
                torch.cuda.synchronize()
            times[key] = host_ms(synced, reps=reps)
        else:
            times[key] = host_ms(fn)

    hs_blocks = math.ceil(HS_ITERS / DIST_HS_FUSE)
    calls = {
        "hs_fused": (lambda: D.horn_schunck_sharded_fused(
            *hs_frames, mesh, HS_WINDOW, HS_ITERS, HS_ALPHA, DIST_HS_FUSE),
            {"hs_tile_sweeps": hs_blocks}),
        "hs_unfused": (lambda: D.horn_schunck_sharded(
            *hs_frames, mesh, HS_WINDOW, HS_ITERS, HS_ALPHA), {}),
    }
    for key, (fn, expected) in calls.items():
        res[key] = [t.cpu() for t in run(f"dist_{key}", fn, expected)]
        timed(key, fn, 5 if card else 1)
    sweeps = []
    res["ba"] = [t.cpu() for t in run(
        "dist_ba_pyramid", lambda: ba_sharded_call(*ba_frames, mesh, sweeps),
        lambda _: ba_sharded_expected(mesh, sweeps))]
    res["ba_sweeps"] = sweeps
    timed("ba", lambda: ba_sharded_call(*ba_frames, mesh), 3 if card else 1)

    def dynamic(iters):
        return D.horn_schunck_sharded_fused_dynamic(
            *weak_frames, mesh, HS_WINDOW, iters, 1.0, WEAK_FUSE)

    res["dynamic"] = [t.cpu() for t in run(
        "dist_dynamic", lambda: dynamic(WEAK_ITERS[0]),
        {"hs_tile_sweeps": WEAK_ITERS[0] // WEAK_FUSE})]
    if card:
        for key, cfg, which in DIST_FB_CASES:
            fb_frames = f32(dev, *FB_FRAMES[which]())

            def fb(fb_frames=fb_frames, cfg=cfg):
                return D.farneback_sharded(*fb_frames, mesh, *cfg)

            res[f"fb_{key}"] = [t.cpu() for t in run(
                f"dist_farneback_{key}", fb,
                fb_expected(cfg, blur_kernel=True))]
            timed(f"fb_{key}", fb, 5)
    if card:
        res["weak"] = run(
            "dist_weak_scaling", lambda: D.weak_scaling_report(
                WEAK_TILE, WEAK_ITERS[0], HS_WINDOW, WEAK_FUSE, 3, dev),
            # Four calls on each sub-mesh this rank belongs to.
            lambda rep: {"hs_tile_sweeps": 4 * (WEAK_ITERS[0] // WEAK_FUSE)
                         * sum(row["devices"] > mesh.iy * mesh.tx + mesh.ix
                               for row in rep["runs"])})
    if card:
        for key, fn in dist_ops_calls(mesh, dist_ops_inputs(dev)).items():
            res[key] = run(f"dist_{key}", fn, {}).cpu()
            timed(key, fn, 1)
    if full and card:
        # bench.py::bench_weak_scaling_row: best of three means of four.
        for iters in WEAK_ITERS:
            def four(iters=iters):
                for _ in range(4):
                    dynamic(iters)
            four()
            torch.cuda.synchronize()
            best = min(host_ms(lambda: (four(), torch.cuda.synchronize()))
                       for _ in range(3)) / 4
            times[f"dynamic_{iters}"] = best
        th, tw = WEAK_TILE
        res["weak_1dev_mpix_per_s"] = (
            th * tw * (WEAK_ITERS[1] - WEAK_ITERS[0])
            / ((times[f"dynamic_{WEAK_ITERS[1]}"]
                - times[f"dynamic_{WEAK_ITERS[0]}"]) / 1e3) / 1e6)
        profile_frame("dist", calls["hs_fused"][0], call="hs_fused")
        profile_frame("dist", lambda: ba_sharded_call(*ba_frames, mesh),
                      call="ba_pyramid")
    return {"mesh": mesh.shape, "backend": mesh.backend, "device": str(dev),
            "results": res, "launches": totals, "ms": times}


# The flagship on a mesh: modes of phase dist (a) (the driver's keywords)
# and the one (b) repeats on 2x2.
DIST_BM_MODES = {"default": {}, "fast": {"profile": "fast"},
                 "affine": {"mode": 0x0100}}  # MODE_OUTPUT_AFFINE_...


def bm_fields(out) -> dict:
    """A flagship output's fields as host arrays (picklable)."""
    return {"u": out.u, "v": out.v, "t": out.t, "bm_u": out.bm_u,
            "bm_v": out.bm_v, "labels": out.segmentation.labels,
            "n_regions": out.segmentation.n_regions}


def dist_flagship_rank(mesh, modes, profiled: bool):
    """The flagship with ``mesh=`` over the Voronoi pan, one sequence per
    mode of ``modes``: on a card each pair runs with the launch counts
    zeroed just before and read just after (pair 1 segments its first
    frame on one rank, then both pairs filter the new frame tiled), and
    a second sequence is timed; ``profiled`` adds a profiler frame of
    pair 2 in the default mode. Every rank's labels are checked equal to
    rank 0's. Rank 0's outputs return as host arrays."""
    import torch
    import torch.distributed as dist

    from tpuflow_torch.solvers.bm_flow import BMFlowState

    dev = mesh.device
    frames, _ = voronoi_frames()
    totals, res, times = {}, {}, {}
    for mode in modes:
        kw = dict(DIST_BM_MODES[mode], mesh=mesh)
        blocks, outs, st = [], [], BMFlowState()
        for k in (0, 1):
            out, st = counted(
                f"dist_flagship_{mode}_pair{k + 1}",
                lambda k=k, st=st: bm_pair(frames, k, st, dev, blocks, **kw),
                lambda _, k=k: {
                    "mean_shift_filter": 1 if k == 0 else 0,
                    "mean_shift_filter_tile": 1,
                    "irls_gated_tile_sweeps": blocks[k]}, totals)
            outs.append(bm_fields(out))
        res[mode] = outs
        res[f"{mode}_blocks"] = blocks
        pair_ms, st = [], BMFlowState()
        for k in (0, 1):
            t0 = time.perf_counter()
            _, st = bm_pair(frames, k, st, dev, **kw)
            torch.cuda.synchronize()
            pair_ms.append(1e3 * (time.perf_counter() - t0))
        times[mode] = pair_ms
        if profiled and mode == "default":
            profile_frame("dist", lambda: bm_pair(frames, 1, st, dev, **kw),
                          call="flagship_pair2")
    mine = torch.tensor([float(np.sum(res[m][k]["labels"] * (k + 1)))
                         + float(np.sum(res[m][k]["u"]))
                         for m in modes for k in (0, 1)],
                        dtype=torch.float64)
    buf = mine.to(dev) if mesh.backend == "nccl" else mine
    every = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(every, buf, group=mesh.group)
    return {"mesh": mesh.shape, "backend": mesh.backend, "results": res,
            "launches": totals, "ms": times,
            "ranks_agree": all(torch.equal(e.cpu(), mine) for e in every)}


def check_mesh_flagship(name, got, want, tol=PATH_TOL) -> dict:
    """A mesh run's two pairs against a reference's: equal labels, region
    counts, BM winners and time directions; u, v within ``tol`` (0: to the
    last bit), or, with ``tol`` None, their max|d| only."""
    import torch

    errs = []
    for k, (g, w) in enumerate(zip(got, want)):
        if g["n_regions"] != w["n_regions"] or not np.array_equal(
                g["labels"], w["labels"]):
            raise AssertionError(f"{name} pair {k + 1}: labels differ")
        for f in ("bm_u", "bm_v", "t"):
            if not np.array_equal(g[f], w[f]):
                raise AssertionError(f"{name} pair {k + 1}: {f} differs at "
                                     f"{int((g[f] != w[f]).sum())} pixels")
        pairs = [(torch.from_numpy(g[f]), torch.from_numpy(w[f]))
                 for f in ("u", "v")]
        errs.append(max_err(pairs)[0] if tol is None
                    else check_close(f"{name} pair {k + 1}", pairs, tol))
    return {"labels_winners_equal": True, "max_abs_err_uv": errs}


def weak_frames_np():
    """bench.py::bench_weak_scaling_row's pair at WEAK_TILE."""
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, WEAK_TILE).astype(np.float32)
    return prev, np.roll(prev, 2, axis=1)


def check_ba(name, got, frames, mesh_shape) -> float:
    """The sharded pyramid's result against :func:`ba_mesh_reference` on
    the card: the same sweeps per level and u, v within PATH_TOL."""
    sweeps = []
    ref = ba_mesh_reference(*frames, tuple(mesh_shape), sweeps)
    if got["ba_sweeps"] != sweeps:
        raise AssertionError(f"{name} BA sweeps {got['ba_sweeps']}, the "
                             f"single-device reference {sweeps}")
    return check_close(f"{name} BA vs the single-device reference",
                       list(zip(got["ba"], ref)), PATH_TOL)


def phase_dist(dev, ba, single, pipeline_runs) -> dict:
    """The sharded path, (a) on one NCCL rank and (b) on a 2x2 mesh of gloo
    ranks sharing the card, against the single-device port on the card
    and one float32 gloo CPU rank; then the flagship on a mesh
    (:func:`phase_dist_flagship`, against ``single``). Returns (a)'s launch
    counts."""
    import torch

    from tpuflow_torch import solvers
    from tpuflow_torch.dist import run_on_mesh

    a = run_on_mesh(dist_rank, 1, "nccl", "cuda", kwargs={"full": True},
                    timeout=DIST_TIMEOUT_S)
    ba_frames, ba_flow, ba_blocks = ba
    hs4k = f32(dev, *frames_4k())
    hs_ref = solvers.horn_schunck(*hs4k, HS_WINDOW, HS_ITERS, HS_ALPHA)
    single_ms = cuda_ms(lambda: solvers.horn_schunck(*hs4k, HS_WINDOW,
                                                     HS_ITERS, HS_ALPHA))
    got = a["results"]
    fused_err = exact("dist (a) horn_schunck_sharded_fused vs horn_schunck",
                      got["hs_fused"], hs_ref)
    unfused_err = check_close("dist (a) horn_schunck_sharded vs horn_schunck",
                              list(zip(got["hs_unfused"], hs_ref)), PATH_TOL)
    ba_err = check_ba("dist (a)", got, ba_frames, a["mesh"])
    fast_sweeps = [b * BA_FUSE for b in ba_blocks]
    if got["ba_sweeps"] != fast_sweeps:
        raise AssertionError(f"dist (a) BA sweeps {got['ba_sweeps']}, "
                             f"optical_flow_pyramid_fast's {fast_sweeps}")
    fast_err = check_close("dist (a) BA vs optical_flow_pyramid_fast",
                           list(zip(got["ba"], ba_flow)), PATH_TOL)
    log("dist", run="a", mesh=a["mesh"], backend=a["backend"],
        launches=json.dumps(a["launches"]), ba_sweeps=got["ba_sweeps"],
        fast_sweeps=fast_sweeps,
        hs_fused_vs_horn_schunck=fused_err,
        hs_unfused_vs_horn_schunck=unfused_err,
        ba_vs_mesh_reference=ba_err, ba_vs_fast=fast_err,
        single_device_horn_schunck_4k_ms=single_ms,
        **{f"{k}_ms": v for k, v in a["ms"].items()})
    for row in got["weak"]["runs"]:
        log("dist", run="a", weak_scaling=json.dumps(row))
    log("dist", run="a", weak_1dev_mpix_per_s=got["weak_1dev_mpix_per_s"])
    for key, cfg, which in DIST_FB_CASES:
        fb_frames = f32(dev, *FB_FRAMES[which]())
        single_fb = {}
        for kind, kw in (("blur_kernel", {"use_blur_kernel": True}),
                         ("default", {})):
            # The tiles run the blur-solve kernel: the single-device run
            # with it is the same function (bitwise expected); the default
            # one (separable box) is reported beside it.
            pairs = list(zip(got[f"fb_{key}"], fb_call(fb_frames, cfg, **kw)))
            single_fb[f"max_abs_err_vs_single_{kind}"] = (
                check_close(f"dist (a) farneback_sharded {key} vs the "
                            "single-device run", pairs, PATH_TOL)
                if kw else max_err(pairs)[0])

            def synced(kw=kw):
                fb_call(fb_frames, cfg, **kw)
                torch.cuda.synchronize()
            synced()
            single_fb[f"single_{kind}_ms"] = host_ms(synced, reps=5)
        log("dist", run="a", farneback=key, params=cfg,
            shape=tuple(fb_frames[0].shape), mesh=a["mesh"],
            sharded_ms=a["ms"][f"fb_{key}"], **single_fb)
    del hs_ref, hs4k
    single_ops = {}
    for key, fn in dist_ops_calls(None, dist_ops_inputs(dev)).items():
        single_ops[key] = fn().cpu()
        torch.cuda.synchronize()
        single_ops[f"{key}_ms"] = host_ms(lambda fn=fn: (
            fn(), torch.cuda.synchronize()))
    log("dist", run="a", **{f"{k}_vs_single": exact(
        f"dist (a) {k} vs the single-device op", got[k], single_ops[k])
        for k in DIST_OPS}, **{f"single_{k}_ms": single_ops[f"{k}_ms"]
                               for k in DIST_OPS})
    torch.cuda.synchronize()

    cpu = run_on_mesh(dist_rank, 1, "gloo", "cpu", kwargs={"full": False},
                      timeout=DIST_TIMEOUT_S, threads=DIST_CPU_THREADS)
    errs = {key: check_close(f"dist (a) {key} card vs CPU",
                             list(zip(got[key], cpu["results"][key])),
                             PATH_TOL)
            for key in ("hs_fused", "hs_unfused", "ba", "dynamic")}
    if cpu["results"]["ba_sweeps"] != got["ba_sweeps"]:
        raise AssertionError(f"dist BA sweeps: card {got['ba_sweeps']}, CPU "
                             f"{cpu['results']['ba_sweeps']}")
    log("dist", run="a_vs_cpu", **{f"{k}_max_abs_err": v
                                   for k, v in errs.items()},
        **{f"chip_host_cpu_f32_{k}_ms": v for k, v in cpu["ms"].items()})

    b = run_on_mesh(dist_rank, DIST_GLOO_RANKS, "gloo", "cuda",
                    kwargs={"full": False}, timeout=DIST_TIMEOUT_S)
    got_b = b["results"]
    errs = {key: exact(f"dist (b) {key} vs (a)", got_b[key], got[key])
            for key in ("hs_fused", "hs_unfused", "dynamic")}
    errs.update({key: exact(f"dist (b) {key} vs the single-device op",
                            got_b[key], single_ops[key]) for key in DIST_OPS})
    for key, _, _ in DIST_FB_CASES:
        errs[f"fb_{key}"] = check_close(
            f"dist (b) farneback_sharded {key} vs (a)",
            list(zip(got_b[f"fb_{key}"], got[f"fb_{key}"])), PATH_TOL)
    errs["ba_vs_mesh_reference"] = check_ba("dist (b)", got_b, ba_frames,
                                            b["mesh"])
    # A level whose tiles take another branch on 2x2 than on 1x1 checks
    # its stop rule at another cadence, so (a) and (b) may run other sweeps
    # there; where they run the same, they must agree.
    errs["ba"], _ = max_err(list(zip(got_b["ba"], got["ba"])))
    if got_b["ba_sweeps"] == got["ba_sweeps"]:
        check_close("dist (b) BA vs (a)", list(zip(got_b["ba"], got["ba"])),
                    PATH_TOL)
    log("dist", run="b", mesh=b["mesh"], backend=b["backend"],
        ba_sweeps=got_b["ba_sweeps"],
        launches_rank0=json.dumps(b["launches"]),
        weak_scaling=json.dumps(got_b["weak"]["runs"]),
        **{f"{k}_vs_a": v for k, v in errs.items()},
        **{f"staged_check_{k}_ms": v for k, v in b["ms"].items()})
    launches = dict(a["launches"])
    t0 = time.perf_counter()
    for k, n in phase_dist_flagship(dev, single).items():
        launches[k] = launches.get(k, 0) + n
    log("dist", flagship_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    dist_pipeline(pipeline_runs)
    log("dist", pipeline_seconds=time.perf_counter() - t0)
    return launches


def dist_pipeline(pipeline_runs: dict, device="cuda") -> None:
    """``run_pipeline`` with ``devices=1`` (one NCCL rank, spawned once)
    over phase pipeline's flagship frames: its files are those of the
    ``devices=0`` run byte for byte. Both run DIST_PIPE_ITERS refine
    sweeps: the sharded refine runs whole fused blocks (tpuflow's too),
    so it equals the single-device one where the sweeps divide into them,
    and the CLI's 300 do not."""
    from tpuflow_torch.pipeline.orchestrator import run_pipeline

    for name in ("opticalflow_bm",):
        inputs, pattern, out_dir = pipeline_runs[name]
        argv, span = next((m[3], m[2]) for m in PIPE_MODES if m[0] == name)
        folders, ms = {}, {}
        for devices in (0, 1):
            opts = pipeline_options(argv, crop=False)
            opts.multiple_motion_param.irls_iter_max = DIST_PIPE_ITERS
            opts.devices = devices
            folders[devices] = out_dir.parent / f"{name}_devices{devices}"
            folders[devices].mkdir()
            t0 = time.perf_counter()
            run_pipeline(inputs, str(folders[devices] / Path(pattern).name),
                         span[0], span[1], opts, device=device)
            ms[devices] = 1e3 * (time.perf_counter() - t0)
        names = sorted(p.name for p in folders[0].iterdir())
        if names != sorted(p.name for p in folders[1].iterdir()):
            raise AssertionError(f"dist pipeline {name}: devices=1 wrote "
                                 "other files than devices=0")
        for fname in names:
            if (folders[1] / fname).read_bytes() != (folders[0] / fname
                                                     ).read_bytes():
                raise AssertionError(f"dist pipeline {name}: {fname} of "
                                     "devices=1 differs from devices=0")
        log("dist", pipeline=name, iter_max=DIST_PIPE_ITERS,
            files_equal=len(names), ms_three_frames_devices0=ms[0],
            ms_three_frames_devices1_with_spawn=ms[1])


def phase_dist_flagship(dev, single) -> dict:
    """The flagship with ``mesh=``: (a) on one NCCL rank in every mode of
    DIST_BM_MODES against the single-device runs of the same calls
    (``single``: mode -> the two pairs' fields): labels and BM winners
    equal, u, v within PATH_TOL where both refines stop at the same
    sweeps (the sharded refine checks its energy at the fused-block
    cadence, tpuflow's); (b) four gloo ranks sharing the card as a 2x2
    mesh, the default mode, against (a): labels and winners equal, u, v
    within PATH_TOL. Returns (a)'s launch counts."""
    from tpuflow_torch.dist import run_on_mesh

    a = run_on_mesh(dist_flagship_rank, 1, "nccl", "cuda",
                    args=(tuple(DIST_BM_MODES), True),
                    timeout=DIST_TIMEOUT_S)
    for mode in DIST_BM_MODES:
        got = a["results"][mode]
        # One rank runs the single-device arithmetic, Lab included (its
        # bits do not depend on the thread count), so the flows are
        # bitwise the same; the fast profile's refine stops at other
        # sweeps.
        tol = None if mode == "fast" else 0.0
        log("dist", run="a", flagship=mode, mesh=a["mesh"],
            backend=a["backend"], refine_blocks=a["results"][f"{mode}_blocks"],
            card_ms_pair1_cold=a["ms"][mode][0],
            card_ms_pair2_bidirectional=a["ms"][mode][1],
            **check_mesh_flagship(f"dist (a) flagship {mode}", got,
                                  single[mode], tol=tol))
    log("dist", run="a", flagship_launches=json.dumps(a["launches"]),
        ranks_agree=a["ranks_agree"])
    b = run_on_mesh(dist_flagship_rank, DIST_GLOO_RANKS, "gloo", "cuda",
                    args=(("default",), False), timeout=DIST_TIMEOUT_S)
    if not b["ranks_agree"]:
        raise AssertionError("dist (b) flagship: the ranks' outputs differ")
    log("dist", run="b", flagship="default", mesh=b["mesh"],
        backend=b["backend"], refine_blocks=b["results"]["default_blocks"],
        launches_rank0=json.dumps(b["launches"]), ranks_agree=True,
        staged_check_ms_pair1=b["ms"]["default"][0],
        staged_check_ms_pair2=b["ms"]["default"][1],
        **check_mesh_flagship("dist (b) flagship vs (a)",
                              b["results"]["default"],
                              a["results"]["default"]))
    return a["launches"]


# -- the main program: the CLI from files to files ----------------------------


def scratch_frames_np(n=2):
    """Integer-valued gray BM_SHAPE frames: a flat background with noise
    of std 0.6, a bright vertical scratch at each of PIPE_SCRATCH_COLS over
    PIPE_SCRATCH_ROWS (frame k's moved k px) and a dark slanted one over
    PIPE_SLANT_ROWS, one px right every 8 rows (shares of the frame)."""
    h, w = BM_SHAPE
    rng = np.random.default_rng(21)
    out = []
    for k in range(n):
        img = np.round(rng.normal(110.0, 0.6, (h, w)))
        v0, v1 = (int(r * h) for r in PIPE_SCRATCH_ROWS)
        for c in PIPE_SCRATCH_COLS:
            img[v0:v1, int(c * w) + k] += 45.0
        r0, r1 = (int(r * h) for r in PIPE_SLANT_ROWS)
        for y in range(r0, r1):
            img[y, w // 2 + y // 8] -= 50.0
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def pan_frames_np():
    """The Voronoi pan (phase main's flagship frames) as 8-bit RGB, and
    its BT.601 gray rounded to 8 bits."""
    frames, _ = voronoi_frames(BM_SHAPE)
    rgb = [np.rint(f).astype(np.uint8) for f in frames]
    gray = [np.rint(0.299 * f[..., 0] + 0.587 * f[..., 1]
                    + 0.114 * f[..., 2]).astype(np.uint8) for f in rgb]
    return rgb, gray


def write_pipeline_files(folder: Path, crop=None) -> dict:
    """The phase's input files: scr_%04d.pgm, pan_%04d.pgm, rgb_%04d.ppm
    (cut to ``crop`` if given). Returns inputs -> pattern."""
    from tpuflow_torch.core.io import write_pnm

    rgb, gray = pan_frames_np()
    sets = {"scr": (scratch_frames_np(), ".pgm"), "pan": (gray, ".pgm"),
            "rgb": (rgb, ".ppm")}
    folder.mkdir(parents=True, exist_ok=True)
    for name, (frames, ext) in sets.items():
        for k, f in enumerate(frames):
            write_pnm(folder / f"{name}_{k:04d}{ext}",
                      f if crop is None else f[crop])
    return {name: str(folder / f"{name}_%04d{ext}")
            for name, (_, ext) in sets.items()}


class FrameRecorder:
    """Wraps the orchestrator's process_frame while active: keeps each
    frame's output name, results and ms (to the card's last op), its
    inputs and a copy of the state it met."""

    def __init__(self):
        self.frames = []

    def __enter__(self):
        from tpuflow_torch.pipeline import orchestrator

        self.module = orchestrator
        self.inner = orchestrator.process_frame

        def recorded(frame, maxint, opts, out_name, state, *a, **kw):
            import copy

            import torch

            before = copy.deepcopy(state)
            t0 = time.perf_counter()
            res, st = self.inner(frame, maxint, opts, out_name, state, *a,
                                 **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.frames.append({"out_name": out_name, "results": res,
                                "ms": 1e3 * (time.perf_counter() - t0),
                                "frame": frame, "maxint": maxint,
                                "opts": opts, "kw": kw,
                                "state_before": before})
            return res, st

        orchestrator.process_frame = recorded
        return self

    def __exit__(self, *exc):
        self.module.process_frame = self.inner


@contextlib.contextmanager
def telemetry_spans():
    """The port's telemetry into memory while active; yields a dict that
    then maps each span name to its wall ms per occurrence."""
    import io

    from tpuflow_torch.utils.telemetry import (Telemetry, get_telemetry,
                                               set_telemetry)

    sink, prev, spans = io.StringIO(), get_telemetry(), {}
    set_telemetry(Telemetry(sink))
    try:
        yield spans
    finally:
        set_telemetry(prev)
        for line in sink.getvalue().splitlines():
            ev = json.loads(line)
            if ev["event"].endswith(".done"):
                spans.setdefault(ev["event"][:-5], []).append(
                    round(1e3 * ev["wall_s"], 3))


def pnm_of(values, maxval=255):
    """What write_pnm stores for ``values`` (clipped, truncated)."""
    return np.clip(np.asarray(values), 0, maxval).astype(
        np.uint16 if maxval > 255 else np.uint8)


def check_pipeline_files(name: str, rec: FrameRecorder) -> int:
    """Every file a mode wrote, read back, equals what process_frame
    returned for it. Returns the number of files checked."""
    from tpuflow_torch.core import io as tio
    from tpuflow_torch.pipeline.orchestrator import _insert_tag

    def same(path, want, what):
        # PNM bytes whatever the extension (the HOG-compensated frame).
        got = tio.read_pnm(path)[0]
        if not np.array_equal(got, want):
            raise AssertionError(f"pipeline {name}: {path} differs from "
                                 f"the returned {what}")

    checked = 0
    flows = {}
    for k, fr in enumerate(rec.frames):
        res, out = fr["results"], fr["out_name"]
        if "superimposed" in res:
            same(out, pnm_of(res["superimposed"]), "superimposed plot")
        elif "scratch_map" in res:
            same(out, pnm_of(res["scratch_map"]), "scratch map")
        elif "filtered" in res:
            same(out, pnm_of(res["filtered"]), "filtered frame")
        elif "hog_vector" in res:
            u, v, score = res["hog_vector"]
            got = tio.read_flow(out, components=3)
            if not all(np.array_equal(g, w.astype(np.float64))
                       for g, w in zip(got, (u, v, score))):
                raise AssertionError(f"pipeline {name}: {out} differs")
            stem = Path(out)
            same(str(stem.with_name(stem.stem + "compensated" + stem.suffix)),
                 pnm_of(res["hog_compensated"]), "HOG-compensated frame")
            checked += 1
        elif "hog" in res and not fr["opts"].mode & 0x4000:
            # (A first frame of the matching mode writes nothing.)
            got, _ = tio.read_hog(out)
            if not np.array_equal(got, res["hog"].astype(np.float64)):
                raise AssertionError(f"pipeline {name}: {out} differs")
        elif "affine" in res:
            if not np.array_equal(tio.read_affine(out),
                                  res["affine"].astype(np.float64)):
                raise AssertionError(f"pipeline {name}: {out} differs")
        elif "flow" in res:
            o = res["flow"]
            seg = o.segmentation
            same(_insert_tag(out, "segmentation_") + ".pgm",
                 pnm_of(seg.labels, max(seg.n_regions - 1, 1)),
                 "segmentation")
            same(_insert_tag(out, "color-quantized_") + ".ppm",
                 o.quantized_rgb, "colour-quantized frame")
            sv = tio.read_flow(_insert_tag(out, "shift-vector_"))
            if not all(np.array_equal(g, o.shift_vector[..., i])
                       for i, g in enumerate(sv)):
                raise AssertionError(f"pipeline {name}: shift vectors differ")
            # The middle frame's flow goes under the previous name.
            flows[rec.frames[k - 1]["out_name"] if o.bidirectional
                  else out] = (o.u, o.v)
            checked += 2
        else:
            continue  # a first frame with nothing to write
        checked += 1
    for path, (u, v) in flows.items():
        got = tio.read_flow(path)
        if not (np.array_equal(got[0], u) and np.array_equal(got[1], v)):
            raise AssertionError(f"pipeline {name}: {path} differs from the "
                                 "last flow written under it")
        checked += 1
    return checked


def pipeline_options(argv, crop: bool):
    from tpuflow_torch.cli.parser import build_parser, parse_args_to_options

    opts = parse_args_to_options(build_parser().parse_args(
        ["-i", "x", "-o", "y", *argv]))
    if crop:
        mm = opts.multiple_motion_param
        mm.bm_search_range = BM_CROP_SEARCH
        mm.bm_kernel_spatial = PIPE_CROP_KERNEL
        mm.irls_iter_max = PIPE_CROP_ITERS
    return opts


def segment_tuples(segs):
    return [(s.n, s.m, s.x, s.y, s.pr) for s in segs]


def report_scratch_diff(name, card, cpu, frame_res) -> None:
    """Where the card's and the CPU's scratch maps differ: each pixel's
    |il - ir| - s_avg and |I - Im| - s_med on the CPU's frame."""
    import torch

    from tpuflow_torch.detection.scratch import side_counts
    from tpuflow_torch.ops import horizontal_median

    diff = np.argwhere(card != cpu)
    log("pipeline", mode=name, scratch_pixels_differing=len(diff))
    fr = frame_res["frame"]
    img = torch.from_numpy(np.asarray(fr, np.float64))
    med = horizontal_median(img, 3)
    h, w = img.shape
    for y, x in diff[:20]:
        l_cnt, r_cnt, (la, lb, ra, rb) = side_counts(torch.tensor(x), w)
        il = float(img[y, int(la):int(lb) + 1].sum()) / max(int(l_cnt), 1)
        ir = float(img[y, int(ra):int(rb) + 1].sum()) / max(int(r_cnt), 1)
        log("pipeline", mode=name, pixel=(int(y), int(x)),
            side_margin=abs(il - ir) - frame_res["opts"].s_avg,
            median_margin=float((img[y, x] - med[y, x]).abs())
            - frame_res["opts"].s_med)


def check_pipeline_crop(name, card: FrameRecorder, cpu: FrameRecorder):
    """The crop run on the card against the float32 CPU run, frame by
    frame: scratch maps and segment lists equal, filtered frames and HOG
    within PATH_TOL, HOG u, v equal, the flagship's labels, winners and t
    equal and u, v within PATH_TOL, the affine fit within PATH_TOL.
    Returns the largest |d| checked against a tolerance."""
    import torch

    from tpuflow_torch.ops import derivative_angler

    worst = 0.0
    for a, b in zip(card.frames, cpu.frames):
        ra, rb = a["results"], b["results"]
        if sorted(ra) != sorted(rb):
            raise AssertionError(f"pipeline crop {name}: results differ")
        if "scratch_map" in ra and not np.array_equal(ra["scratch_map"],
                                                      rb["scratch_map"]):
            report_scratch_diff(name, ra["scratch_map"], rb["scratch_map"], b)
            raise AssertionError(f"pipeline crop {name}: scratch maps differ")
        if "segments" in ra and segment_tuples(ra["segments"]) != \
                segment_tuples(rb["segments"]):
            ang = [derivative_angler(torch.from_numpy(r["scratch_map"]).to(
                d)).cpu().numpy() for r, d in ((ra, "cuda"), (rb, "cpu"))]
            log("pipeline", mode=name, angles_differing=int(
                (ang[0] != ang[1]).sum()), segments_card=len(ra["segments"]),
                segments_cpu=len(rb["segments"]))
            raise AssertionError(f"pipeline crop {name}: segments differ")
        for key in ("filtered", "hog", "hog_raw", "affine",
                    "hog_compensated"):
            if key in ra:
                worst = max(worst, check_close(
                    f"pipeline crop {name} {key}",
                    [(torch.from_numpy(np.asarray(ra[key], np.float64)),
                      torch.from_numpy(np.asarray(rb[key], np.float64)))],
                    PATH_TOL))
        if "hog_vector" in ra:
            (u, v, s), (cu, cv, cs) = ra["hog_vector"], rb["hog_vector"]
            if not (np.array_equal(u, cu) and np.array_equal(v, cv)):
                raise AssertionError(f"pipeline crop {name}: HOG vectors "
                                     f"differ at {int((u != cu).sum())} "
                                     "sites")
            worst = max(worst, check_close(
                f"pipeline crop {name} score", [(torch.from_numpy(s),
                                                 torch.from_numpy(cs))],
                PATH_TOL))
        if "flow" in ra:
            worst = max(worst, check_bm_vs_cpu(f"pipeline crop {name}",
                                               ra["flow"], rb["flow"]))
    return worst


def run_cli(argv) -> None:
    from tpuflow_torch.cli.parser import main as cli_main

    rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv} returned {rc}")


def pipeline_direct(name, inputs, span, dev, blocks):
    """The kernels' direct calls on the frames of one mode, as the
    orchestrator makes them: the Gaussian prefilter per frame, or the
    flagship over the frames (the CLI's defaults). Returns their
    outputs."""
    from tpuflow_torch.core.io import read_image
    from tpuflow_torch.ops import gaussian_filter
    from tpuflow_torch.solvers.bm_flow import BMFlowState

    frames = [read_image(inputs.replace("%04d", f"{k:04d}"))[0]
              for k in range(span[0], span[1] + 1)]
    if "gaussian" in name:
        return [gaussian_filter(torch_on(dev, f), (PIPE_GAUSS_TAPS,) * 2, 5.0)
                for f in frames]
    opts = pipeline_options(dict((m[0], m[3]) for m in PIPE_MODES)[name],
                            False)
    mm = opts.multiple_motion_param
    state, outs = BMFlowState(), []
    for k in range(1, len(frames)):
        out, state = bm_pair(
            [f.astype(np.float64) for f in frames], k - 1, state, dev,
            blocks, mode=0x0100 if name == "affine_bm" else 0,
            iter_max=mm.irls_iter_max)
        outs.append(out)
    return outs


def torch_on(dev, a):
    import torch

    return torch.tensor(np.asarray(a, np.float64), dtype=torch.float32,
                        device=dev)


def pipeline_expected(name, span, dev):
    """A mode's launches, from the direct calls on the same frames."""
    if "gaussian" in name:
        return lambda _: {"sep_conv2d_valid": span[1] - span[0] + 1}
    if not name.endswith("_bm"):
        return {}
    blocks = []
    return blocks, lambda _: {
        "mean_shift_filter": span[1] - span[0] + 1,
        "irls_gated_sweeps": sum(blocks) if name == "opticalflow_bm" else 0}


def phase_pipeline(dev, totals: dict, folder: Path) -> dict:
    """The reference's main program through the port's CLI on the card
    (module docstring, phase 10). Returns the flagship runs' folders for
    phase dist."""
    import copy

    import torch
    import torch.nn.functional as F

    from tpuflow_torch.kernels import sepconv

    t0 = time.perf_counter()
    inputs = write_pipeline_files(folder / "in")
    crop_in = write_pipeline_files(folder / "crop_in", BM_CROP)
    kept = {}
    for name, kind, span, argv, ext in PIPE_MODES:
        out_dir = folder / name
        out_dir.mkdir()
        pattern = str(out_dir / f"{name}_%04d{ext}")
        cli = ["-i", inputs[kind], "-o", pattern, "-s", str(span[0]), "-e",
               str(span[1]), *argv, "--device", str(dev)]
        direct = None
        expected = pipeline_expected(name, span, dev)
        if isinstance(expected, tuple):  # the flagship: count the direct run
            blocks, expected = expected
            direct = counted(f"pipeline_direct_{name}", lambda: pipeline_direct(
                name, inputs[kind], span, dev, blocks), expected, {})
            want = expected(None)
        elif expected:
            want = expected(None)
            direct = pipeline_direct(name, inputs[kind], span, dev, None)
        else:
            want = {}
        with FrameRecorder() as rec, telemetry_spans() as spans:
            t1 = time.perf_counter()
            counted(f"pipeline_{name}", lambda: run_cli(cli), want, totals)
            cli_ms = 1e3 * (time.perf_counter() - t1)
        n_files = check_pipeline_files(name, rec)
        if direct is not None:
            # The orchestrator's results are the direct calls' bitwise.
            for k, d in enumerate(direct):
                if "gaussian" in name:
                    continue
                o = rec.frames[k + 1]["results"]["flow"]
                if not (np.array_equal(o.u, d.u) and np.array_equal(o.v, d.v)
                        and np.array_equal(o.segmentation.labels,
                                           d.segmentation.labels)):
                    raise AssertionError(f"pipeline {name}: pair {k + 1} "
                                         "differs from the direct call")
        n = span[1] - span[0] + 1
        numbers = {}
        if name == "scratch":
            numbers["segments"] = len(rec.frames[0]["results"]["segments"])
        if "hog_vector" in rec.frames[-1]["results"]:
            u, v, _ = rec.frames[-1]["results"]["hog_vector"]
            numbers["hog_median_uv"] = [float(np.median(u)),
                                        float(np.median(v))]
        log("pipeline", mode=name, shape=BM_SHAPE, frames=n,
            launches=json.dumps(want), files_checked=n_files,
            card_ms_per_frame_file_to_file=cli_ms / n,
            process_frame_ms=[round(f["ms"], 3) for f in rec.frames],
            span_ms=json.dumps(spans), **numbers)
        if name.endswith("_bm"):
            kept[name] = (inputs[kind], pattern, out_dir)
        # One profiler frame: the last frame again, from a copy of the
        # state it met, written to a folder of its own.
        last = rec.frames[-1]
        prof_dir = folder / f"{name}_profiled"
        prof_dir.mkdir()
        from tpuflow_torch.pipeline import orchestrator

        profile_frame("pipeline", lambda: orchestrator.process_frame(
            last["frame"], last["maxint"], last["opts"],
            str(prof_dir / Path(last["out_name"]).name),
            copy.deepcopy(last["state_before"]), **last["kw"]), mode=name)
        # The crop, on the card and on the float32 CPU.
        opts = pipeline_options(argv, crop=True)
        runs = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            sub = folder / f"{name}_crop_{where}"
            sub.mkdir()
            with FrameRecorder() as crec:
                from tpuflow_torch.pipeline.orchestrator import run_pipeline

                t1 = time.perf_counter()
                run_pipeline(crop_in[kind], str(sub / f"c_%04d{ext}"),
                             span[0], span[1], copy.deepcopy(opts), device=d)
                runs[where] = (crec, 1e3 * (time.perf_counter() - t1))
        err = check_pipeline_crop(name, runs["card"][0], runs["cpu"][0])
        log("pipeline", mode=name, crop=tuple(BM_CROP_SHAPE),
            max_abs_err_vs_cpu=err, equal_maps_segments_winners=True,
            card_ms_crop=runs["card"][1],
            chip_host_cpu_f32_ms_crop=runs["cpu"][1])
    # Kernel #3 at the prefilter's 21x21 taps on the frame.
    rng = np.random.default_rng(21)
    r = PIPE_GAUSS_TAPS // 2
    padded = torch_on(dev, rng.uniform(0, 255, (BM_SHAPE[0] + 2 * r,
                                                BM_SHAPE[1] + 2 * r)))
    xs = np.arange(PIPE_GAUSS_TAPS, dtype=np.float64) - r
    g = np.exp(-(xs ** 2) / (2.0 * 5.0 ** 2))
    g /= g.sum()
    taps = sepconv.host_taps(g, torch.float32)
    k2 = torch_on(dev, np.outer(taps, taps)[None, None])
    kernel_row({}, "sep_conv2d_valid", BM_SHAPE,
               lambda: sepconv.sep_conv2d_valid(padded, g, g),
               lambda: sepconv.sep_conv2d_valid_plain(padded, taps, taps),
               sep_bound(*padded.shape, PIPE_GAUSS_TAPS, PIPE_GAUSS_TAPS),
               library=lambda: F.conv2d(padded[None, None], k2),
               taps=(PIPE_GAUSS_TAPS, PIPE_GAUSS_TAPS), path="pipeline")
    log("pipeline", seconds=time.perf_counter() - t0)
    return kept


def main() -> None:
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    name = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    numbers = phase_kernels(dev)
    launches, hs, ba, fb_runs, stream, bm = phase_main(dev)
    phase_hs(*hs)
    phase_ba(*ba)
    phase_fb(fb_runs, stream)
    t0 = time.perf_counter()
    phase_bm(dev, *bm)
    log("bm", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    lk = main_lk(dev, launches)
    log("main", paths="lk", seconds=time.perf_counter() - t0)
    phase_lk(dev, *lk)
    t0 = time.perf_counter()
    affine = main_affine(dev, launches, bm[1])
    log("main", paths="affine", seconds=time.perf_counter() - t0)
    phase_affine(dev, *affine)
    phase_demos(dev, launches)
    labeler_row(dev)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tpuflow_pipeline_") as tmp:
        pipeline_runs = phase_pipeline(dev, launches, Path(tmp))
        single = {"default": bm[1], "fast": bm[3]["fast"][0],
                  "affine": affine[1][1]}
        t0 = time.perf_counter()
        for k, n in phase_dist(dev, ba, {mode: [bm_fields(o) for o in outs]
                                         for mode, outs in single.items()},
                               pipeline_runs).items():
            launches[k] = launches.get(k, 0) + n
        log("dist", seconds=time.perf_counter() - t0)
    kernels = []
    for kname, source, replaces in (
            ("hs_sweeps", "tpuflow_torch/csrc/hs_stencil.cu",
             "tpuflow/kernels/hs_stencil.py:706"),
            ("irls_sweeps", "tpuflow_torch/csrc/irls_stencil.cu",
             "tpuflow/kernels/irls_stencil.py:391"),
            ("sep_conv2d_valid", "tpuflow_torch/csrc/sepconv.cu",
             "tpuflow/kernels/sepconv.py:100"),
            ("fb_poly_expansion", "tpuflow_torch/csrc/fb_kernels.cu",
             "tpuflow/kernels/fb_kernels.py:203"),
            ("fb_blur_solve", "tpuflow_torch/csrc/fb_kernels.cu",
             "tpuflow/kernels/fb_kernels.py:93"),
            ("irls_gated_sweeps", "tpuflow_torch/csrc/irls_gated.cu",
             "tpuflow/kernels/irls_stencil.py:199"),
            ("mean_shift_filter", "tpuflow_torch/csrc/ms_filter.cu",
             "tpuflow/kernels/ms_filter.py:129"),
            ("hs_tile_sweeps", "tpuflow_torch/csrc/hs_stencil.cu",
             "tpuflow/kernels/hs_stencil.py:350"),
            ("horn_schunck_resident", "tpuflow_torch/csrc/hs_resident.cu",
             "tpuflow/kernels/hs_stencil.py:434"),
            ("horn_schunck_resident2", "tpuflow_torch/csrc/hs_resident.cu",
             "tpuflow/kernels/hs_stencil.py:560"),
            ("irls_tile_sweeps", "tpuflow_torch/csrc/irls_stencil.cu",
             "tpuflow/kernels/irls_stencil.py:353"),
            # Not TPU kernels: the jnp tile bodies tpuflow's sharded
            # flagship runs (tpuflow/dist/bm_refine.py:143 and
            # tpuflow/segmentation/meanshift.py:577), as Hopper entries.
            ("irls_gated_tile_sweeps", "tpuflow_torch/csrc/irls_gated.cu",
             "tpuflow/kernels/irls_stencil.py:97"),
            ("mean_shift_filter_tile", "tpuflow_torch/csrc/ms_filter.cu",
             "tpuflow/segmentation/meanshift.py:577")):
        if launches.get(kname, 0) < 1:
            raise AssertionError(f"{kname} was not launched on the main path")
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, **numbers[kname],
                        "launches": launches[kname]})
    log("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
