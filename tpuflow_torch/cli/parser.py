"""CLI — the reference's ~30-option surface (main.cpp:22-483); port of
:mod:`tpuflow.cli.parser`.

Every option of tpuflow's parser, with the same names, defaults and
semantics (the bit-mask mode system, Scratch_Struct.h:84-95), plus
``--device`` (default ``cuda``): where the pipeline runs. ``--telemetry``
turns on :mod:`tpuflow_torch.utils.telemetry`.

    python -m tpuflow_torch.cli -i in_%04d.pgm -o out_%04d.pgm -s 0 -e 9
"""

from __future__ import annotations

import argparse

from tpuflow_torch.core.config import (
    BLUE,
    GREEN,
    MODE_OUTPUT_AFFINE_BLOCKMATCHING,
    MODE_OUTPUT_BINARY_IMAGE,
    MODE_OUTPUT_FILTERED_IMAGE,
    MODE_OUTPUT_HOG,
    MODE_OUTPUT_HOG_MATCHING_VECTOR,
    MODE_OUTPUT_HOG_RAW,
    MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE,
    MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING,
    PLOT_AS_RESAMPLED,
    PLOT_NEGATE,
    PLOT_RESAMPLED_IMG_ONLY,
    RED,
    Options,
)


def _size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuflow_torch",
        description="Line scratch detection by meaningful alignments + "
        "dense optical flow (PyTorch/CUDA re-implementation of "
        "Cpp-Optical-Flow).")
    p.add_argument("-i", dest="input", required=False,
                   help="input filename pattern (printf %%0Nd for frames)")
    p.add_argument("-o", dest="output", required=False,
                   help="output filename pattern")
    p.add_argument("-s", dest="start", type=int, default=0,
                   help="start frame number")
    p.add_argument("-e", dest="end", type=int, default=0,
                   help="end frame number")
    p.add_argument("--filtered", action="store_true",
                   help="output first filtered image")
    p.add_argument("--binary", action="store_true",
                   help="output middle data at line scratch detection")
    p.add_argument("--multiple_affine", action="store_true",
                   help="output multiple motions' affine parameters")
    p.add_argument("--affine_blockmatching", action="store_true",
                   help="output optical flow via affine block matching")
    p.add_argument("--opticalflow_blockmatching", action="store_true",
                   help="output optical flow via block matching")
    p.add_argument("--mm_level", type=int, default=None,
                   help="max level of the Gaussian pyramid")
    p.add_argument("--HOG", action="store_true", dest="hog",
                   help="output block-normalized HOG")
    p.add_argument("--HOG_raw", action="store_true", dest="hog_raw",
                   help="output raw HOG")
    p.add_argument("--HOG_matching_vector", action="store_true",
                   dest="hog_matching_vector",
                   help="output HOG matching vectors")
    p.add_argument("--HOG_bins", type=int, default=None, dest="hog_bins")
    p.add_argument("--HOG_densely", action="store_true", dest="hog_densely")
    p.add_argument("--HOG_less_densely", action="store_true",
                   dest="hog_less_densely")
    p.add_argument("--HOG_signed", action="store_true", dest="hog_signed")
    p.add_argument("--HOG_unsigned", action="store_true",
                   dest="hog_unsigned")
    p.add_argument("--resample", type=_size, default=None,
                   metavar="WxH", help="resample input before processing")
    p.add_argument("--resample_method", choices=["z-hold", "bicubic"],
                   default="z-hold")
    p.add_argument("--plot_as_resampled", action="store_true")
    p.add_argument("--plot_resampled_only", action="store_true")
    p.add_argument("--x11_plot", action="store_true",
                   help="render the 3-D scene to <output>_3d.png "
                   "(headless stand-in for the X11 viewer)")
    # Line scratch detection options
    p.add_argument("--filter_size", type=_size, default=None, metavar="WxH")
    p.add_argument("--filter_type",
                   choices=["Epsilon", "Gaussian", "None",
                            "epsilon", "gaussian", "none"], default=None)
    p.add_argument("--gauss_stddev", type=float, default=None,
                   help="Gaussian filter standard deviation (main.cpp "
                   "option name)")
    p.add_argument("--gauss_var", type=float, default=None,
                   help="alias of --gauss_stddev")
    p.add_argument("--filter_ep", type=float, default=None)
    p.add_argument("--s_med", type=float, default=None)
    p.add_argument("--s_avg", type=float, default=None)
    # Meaningful alignments options
    p.add_argument("-l", dest="max_length", type=int, default=0,
                   help="max segment length when detecting")
    p.add_argument("-L", dest="max_output_length", type=int, default=0,
                   help="max segment length when writing")
    p.add_argument("-n", dest="negate", action="store_true",
                   help="negative output (fg black, bg white)")
    p.add_argument("--epsilon", type=float, default=None,
                   help="NFA threshold epsilon")
    p.add_argument("--exclusive_rad", type=float, default=None)
    p.add_argument("--exclusive", action="store_true")
    p.add_argument("--superimpose", choices=["red", "green", "blue"],
                   default=None)
    p.add_argument("--debug_dumps", action="store_true",
                   help="write the reference's debug images "
                   "(Pyramid_%%04d.pgm, filtered.pgm, IndexMap.pgm) next "
                   "to the output file")
    p.add_argument("--checkpoint", default=None,
                   help="path for per-frame pipeline state checkpoints")
    p.add_argument("--telemetry", action="store_true",
                   help="emit JSON-lines telemetry on stderr")
    p.add_argument("--devices", type=int, default=0,
                   help="tile the block-matching path over a mesh of N "
                   "ranks, one process each (image dims must divide it; "
                   "0 = one device)")
    p.add_argument("--bm_precision", choices=["f32", "bf16"],
                   default="f32",
                   help="block-matching search evaluator precision: f32 "
                   "is bit-faithful to the reference cost; bf16 feeds "
                   "the MXU reduction bf16 inputs with f32 accumulation "
                   "(winners can differ at near-ties; only pays at very "
                   "large region counts)")
    p.add_argument("--bm_profile",
                   choices=["faithful", "fast", "turbo", "quality"],
                   default=None,
                   help="flagship profile: 'faithful' (default) "
                   "keeps every knob bit-faithful to the reference; "
                   "'fast' = stride-2 coarse search + analytic-bound "
                   "plateau-stopped refinement (-0.07 dB corpus); "
                   "'quality' = half-res segmentation (finer regions; "
                   "corpus compensation ABOVE cv2 Farneback); 'turbo' "
                   "= both (documented trades, BASELINE.md r5)")
    p.add_argument("--refine_warp", action="store_true",
                   help="tpuflow extension: run the flagship gradient "
                   "refinement under the REAL BM warp instead of the "
                   "reference's zeroed-'for DEBUG' vector "
                   "(OpticalFlow_BlockMatching.cpp:291-293; see "
                   "docs/MIGRATION.md)")
    p.add_argument("--device", default="cuda",
                   help="device the pipeline runs on (default cuda; cpu "
                   "off the card)")
    return p


def parse_args_to_options(args) -> Options:
    opts = Options()
    mode = 0
    if args.filtered:
        mode |= MODE_OUTPUT_FILTERED_IMAGE
    if args.binary:
        mode |= MODE_OUTPUT_BINARY_IMAGE
    if args.multiple_affine:
        mode |= MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE
    if args.affine_blockmatching:
        mode |= MODE_OUTPUT_AFFINE_BLOCKMATCHING
    if args.opticalflow_blockmatching:
        mode |= MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING
    if args.hog:
        mode |= MODE_OUTPUT_HOG
    if args.hog_raw:
        mode |= MODE_OUTPUT_HOG_RAW
    if args.hog_matching_vector:
        mode |= MODE_OUTPUT_HOG_MATCHING_VECTOR
    opts.mode = mode
    if args.mm_level is not None:
        opts.multiple_motion_param.level = args.mm_level
    if args.bm_precision == "bf16":
        opts.multiple_motion_param.bm_method = "matmul_bf16"
    if args.refine_warp:
        opts.multiple_motion_param.bm_refine_warp = True
    if args.bm_profile:
        opts.multiple_motion_param.bm_profile = args.bm_profile
    hp = opts.hog_param
    if args.hog_bins is not None:
        hp.bins = args.hog_bins
    if args.hog_densely:
        hp.dense = True
    if args.hog_less_densely:
        hp.dense = False
    if args.hog_signed:
        hp.signed_orientation = True
    if args.hog_unsigned:
        hp.signed_orientation = False
    if args.resample is not None:
        opts.resample_size = args.resample
    opts.resample_method = 1 if args.resample_method == "bicubic" else 0
    plot = 0
    if args.negate:
        plot |= PLOT_NEGATE
    if args.plot_as_resampled:
        plot |= PLOT_AS_RESAMPLED
    if args.plot_resampled_only:
        plot |= PLOT_RESAMPLED_IMG_ONLY
    opts.plot_options = plot
    if args.filter_type is not None:
        opts.filter_param = opts.filter_param.change_filter(args.filter_type)
    if args.filter_size is not None:
        opts.filter_param.size = args.filter_size
    gauss_sd = args.gauss_stddev if args.gauss_stddev is not None \
        else args.gauss_var
    if gauss_sd is not None:
        opts.filter_param.std_deviation = gauss_sd
    if args.filter_ep is not None:
        opts.filter_param.epsilon = args.filter_ep
    if args.s_med is not None:
        opts.s_med = args.s_med
    if args.s_avg is not None:
        opts.s_avg = args.s_avg
    opts.max_length = args.max_length
    opts.max_output_length = args.max_output_length
    if args.epsilon is not None:
        opts.ep = args.epsilon
    if args.exclusive_rad is not None:
        opts.exclusive_max_radius = args.exclusive_rad
    opts.exclusive_principle = args.exclusive
    if args.superimpose:
        opts.superimpose = {"red": RED, "green": GREEN,
                            "blue": BLUE}[args.superimpose]
    opts.x11_plot = args.x11_plot
    opts.debug_dumps = args.debug_dumps
    opts.devices = args.devices
    return opts


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.input or not args.output:
        parser.error("-i and -o are required")
    opts = parse_args_to_options(args)
    if args.telemetry:
        from tpuflow_torch.utils.telemetry import Telemetry, set_telemetry

        set_telemetry(Telemetry(enabled=True))
    from tpuflow_torch.pipeline.orchestrator import run_pipeline

    run_pipeline(args.input, args.output, args.start, args.end, opts,
                 checkpoint_path=args.checkpoint, device=args.device)
    return 0
