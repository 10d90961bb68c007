"""Per-frame pipeline orchestrator: the reference's main program
(Scratch_MeaningfulMotion.cpp:12-623), port of
:mod:`tpuflow.pipeline.orchestrator`.

- printf-pattern filename expansion over [start, end] (:84-122);
- image read (PNM/PNG), size-consistency check across frames (:151-154),
  optional resample before processing (:156-209), RGB->gray (:235-264);
- <= 4-frame RGB/gray history;
- mode dispatch (:315-522): filtered image / binary scratch map /
  meaningful alignments (+ exclusive principle, plot, superimpose) /
  global affine / BM flow (gradient or affine refinement) / HOG family,
  each with tpuflow's output files and side-output names;
- ``x11_plot`` renders the 3-D scene to ``<output>_3d.png``.

The image work runs on ``device`` (the card unless the caller passes
``device="cpu"``) in ``dtype`` (float32 by default, the kernels' dtype):
the Gaussian prefilter on ``sep_conv2d_valid``, the flagship on
``irls_gated_sweeps`` and ``mean_shift_filter``. The frames, the history
and every result are host arrays, as in tpuflow; the a-contrario search,
the exclusive principle and the plots are host NumPy there too.

The cross-frame state lives in :class:`PipelineState`. Its flagship
state holds Lab frames on the device; :meth:`PipelineState.save` writes
host copies and :meth:`PipelineState.load` puts them on a device.

``opts.devices > 0`` runs the flagship on a mesh of that many ranks:
:func:`run_pipeline` spawns them once (``dist.run_on_mesh``); every rank
runs the frame loop on the same frames and keeps its own flagship state,
rank 0 writes the files, and the ranks' results must agree frame by frame.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.core import io as tio
from tpuflow_torch.core.color import rgb_to_gray
from tpuflow_torch.core.config import (
    MODE_OUTPUT_AFFINE_BLOCKMATCHING,
    MODE_OUTPUT_BINARY_IMAGE,
    MODE_OUTPUT_FILTERED_IMAGE,
    MODE_OUTPUT_HOG,
    MODE_OUTPUT_HOG_MATCHING_VECTOR,
    MODE_OUTPUT_HOG_RAW,
    MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE,
    MODE_OUTPUT_OPTICALFLOW,
    MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING,
    PLOT_AS_RESAMPLED,
    PLOT_NEGATE,
    PLOT_RESAMPLED_IMG_ONLY,
    Options,
)
from tpuflow_torch.core.resample import resample
from tpuflow_torch.utils.telemetry import get_telemetry, trace_span

BM_MODES = (MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING
            | MODE_OUTPUT_AFFINE_BLOCKMATCHING | MODE_OUTPUT_OPTICALFLOW)


@dataclass
class PipelineState:
    """Cross-frame state (the reference's statics made explicit)."""

    prev_rgb: np.ndarray | None = None
    prev_gray: np.ndarray | None = None
    prev_gray2: np.ndarray | None = None   # prev-of-prev (bidirectional MC)
    prev_out_name: str | None = None       # OutputNameNums_prev
    bm_state: object | None = None         # solvers.bm_flow.BMFlowState
    hog_prev: np.ndarray | None = None
    hog_raw_prev: np.ndarray | None = None
    pr_table: np.ndarray | None = None
    k_list: np.ndarray | None = None
    l_min: int | None = None
    frame_size: tuple[int, int] | None = None

    def to(self, device) -> "PipelineState":
        """This state with the flagship's Lab frames on ``device``."""
        if self.bm_state is None:
            return self
        bm = dataclasses.replace(
            self.bm_state,
            lab_frames=[t.to(device) for t in self.bm_state.lab_frames])
        return dataclasses.replace(self, bm_state=bm)

    def save(self, path: str | Path) -> None:
        """Checkpoint for restart: host copies of everything."""
        host = self.to("cpu")
        with open(path, "wb") as f:
            pickle.dump({fl.name: getattr(host, fl.name)
                         for fl in dataclasses.fields(host)}, f)

    @classmethod
    def load(cls, path: str | Path, device="cuda") -> "PipelineState":
        with open(path, "rb") as f:
            return cls(**pickle.load(f)).to(device)

    @classmethod
    def from_tpuflow(cls, state, device="cuda") -> "PipelineState":
        """Carry a tpuflow ``PipelineState`` across by field name; its
        flagship state through ``BMFlowState.from_tpuflow``."""
        from tpuflow_torch.solvers.bm_flow import BMFlowState

        fields = {}
        for fl in dataclasses.fields(cls):
            v = getattr(state, fl.name)
            if fl.name == "bm_state":
                v = None if v is None else BMFlowState.from_tpuflow(v, device)
            elif fl.name == "frame_size":
                v = None if v is None else tuple(int(s) for s in v)
            elif isinstance(v, np.ndarray):
                v = np.array(v)
            fields[fl.name] = v
        return cls(**fields)


def _on(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dump_pyramid(proc: np.ndarray, maxint: int, max_level: int,
                  out_name: str, device, dtype) -> None:
    """The DEBUG_PYRAMID dump: every Gaussian pyramid level as
    Pyramid_%04d.pgm, values x256 of the MaxInt-normalized image
    (MultiResolution.cpp:86-94). Written next to the output file."""
    from tpuflow_torch.pyramid import pyramider
    from tpuflow_torch.utils.numerics import true_div

    levels = pyramider(true_div(_on(proc, device, dtype), float(maxint)),
                       max_level)
    out_dir = Path(out_name).parent
    for lv, img in enumerate(levels):
        tio.write_image(out_dir / f"Pyramid_{lv:04d}.pgm",
                        np.clip(_host(img).astype(np.float64) * 256.0, 0,
                                255), 255)


def _hog_compensated(cur_gray: np.ndarray, u: np.ndarray, v: np.ndarray,
                     dense: bool, device, dtype) -> np.ndarray:
    """Compensated image from HOG matching vectors
    (HOG_vector_compensated_write, HOG_match.cpp:125-145, reconstructed
    as tpuflow does: grid vectors scaled to pixels (x cell size when the
    grid is one site per 7x7 cell), nearest-upsampled to the frame, and
    the current frame warped back through them)."""
    from tpuflow_torch.core.resample import resize_zero_order_hold
    from tpuflow_torch.features.hog import CELL
    from tpuflow_torch.pipeline.motion_compensation import compensate

    scale = 1.0 if dense else float(CELL[0])
    h, w = cur_gray.shape
    uu = resize_zero_order_hold(_on(u * scale, device, dtype), (w, h))
    vv = resize_zero_order_hold(_on(v * scale, device, dtype), (w, h))
    return _host(compensate(_on(cur_gray, device, dtype), uu, vv))


def _insert_tag(name: str, tag: str) -> str:
    """The reference's side-output naming: insert the tag before the
    trailing digit run (OpticalFlow_BlockMatching.cpp:137-143)."""
    s = str(Path(name))
    i = len(s)
    while i > 0 and s[i - 1].isdigit():
        i -= 1
    j = i
    if j == len(s):  # no digits: before the extension
        j = s.rfind(".")
        if j < 0:
            j = len(s)
    return s[:j] + tag + s[j:]


def process_frame(
    frame_rgb: np.ndarray,
    maxint: int,
    opts: Options,
    out_name: str,
    state: PipelineState,
    write_outputs: bool = True,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    mesh=None,
) -> tuple[dict, PipelineState]:
    """One iteration of the frame loop. Returns (results dict, state).

    ``mesh`` (a ``tpuflow_torch.dist.Mesh``; the caller is one of its
    ranks) runs the flagship on the mesh, on the mesh's device."""
    if mesh is not None:
        device = mesh.device
    device = torch.device(device)
    results: dict = {}
    tel = get_telemetry()

    orig = frame_rgb
    gray = frame_rgb if frame_rgb.ndim == 2 else rgb_to_gray(
        torch.from_numpy(np.asarray(frame_rgb, np.float64))).numpy()

    # Resample before processing (--resample).
    rw, rh = opts.resample_size
    if rw > 0 and rh > 0:
        proc = _host(resample(_on(gray, device, dtype), (rw, rh),
                              opts.resample_method)).astype(np.float64)
        proc_rgb = _host(resample(
            _on(frame_rgb, device, dtype), (rw, rh),
            opts.resample_method)).astype(np.float64) \
            if frame_rgb.ndim == 3 else proc
        if opts.plot_options & PLOT_RESAMPLED_IMG_ONLY and write_outputs:
            tio.write_image(out_name, proc, maxint)
            return {"resampled": proc}, state
    else:
        proc = gray.astype(np.float64)
        proc_rgb = frame_rgb

    if state.frame_size is not None and state.frame_size != proc.shape:
        raise ValueError(
            f"frame size changed: {state.frame_size} -> {proc.shape} "
            "(Scratch_MeaningfulMotion.cpp:151-154)")
    state.frame_size = proc.shape

    mode = opts.mode
    mm = opts.multiple_motion_param

    if mode & MODE_OUTPUT_FILTERED_IMAGE:
        from tpuflow_torch.detection import detect_scratch

        with trace_span("pipeline.filtered"):
            _, filtered = detect_scratch(_on(proc, device, dtype), opts.s_med,
                                         opts.s_avg, opts.filter_param,
                                         do_detection=False)
        results["filtered"] = _host(filtered)
        if write_outputs:
            tio.write_image(out_name, results["filtered"], maxint)

    elif mode & MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE:
        if state.prev_gray is None:
            tel.event("pipeline.skip", reason="no previous frame")
        else:
            from tpuflow_torch.solvers import multiple_motion_affine

            with trace_span("pipeline.affine"):
                a = multiple_motion_affine(
                    _on(state.prev_gray, device, dtype),
                    _on(proc, device, dtype), float(maxint), mm)
            results["affine"] = _host(a)
            if write_outputs:
                tio.write_affine(out_name, results["affine"])
                if opts.debug_dumps:
                    _dump_pyramid(proc, maxint, mm.level, out_name, device,
                                  dtype)

    elif mode & BM_MODES:
        if state.prev_rgb is None:
            tel.event("pipeline.skip", reason="no previous frame")
        else:
            from tpuflow_torch.solvers.bm_flow import (
                optical_flow_block_matching)

            bm_mode = (MODE_OUTPUT_AFFINE_BLOCKMATCHING
                       if mode & MODE_OUTPUT_AFFINE_BLOCKMATCHING else 0)
            with trace_span("pipeline.bm_flow"):
                out, state.bm_state = optical_flow_block_matching(
                    state.prev_rgb, proc_rgb, float(maxint), mm,
                    mode=bm_mode, iter_max=mm.irls_iter_max,
                    state=state.bm_state,
                    search_range=mm.bm_search_range,
                    kernel_spatial=mm.bm_kernel_spatial,
                    kernel_intensity=mm.bm_kernel_intensity,
                    subpixel_scale=mm.bm_subpixel_scale,
                    mesh=mesh, bm_method=mm.bm_method,
                    refine_warp=mm.bm_refine_warp,
                    profile=mm.bm_profile, device=device)
            results["flow"] = out
            if write_outputs:
                from tpuflow_torch.pipeline.motion_compensation import (
                    compensate)

                # Bidirectional estimation is for the *middle* frame, so
                # flow + compensated image go under the previous frame's
                # output name (OutputNameNums_prev,
                # Scratch_MeaningfulMotion.cpp:544-552); the segmentation
                # side outputs always use the newest frame's name
                # (newest_filename, OpticalFlow_BlockMatching.cpp:137-196).
                flow_name = out_name
                u_t = torch.from_numpy(np.asarray(out.u)).to(device)
                v_t = torch.from_numpy(np.asarray(out.v)).to(device)
                if out.bidirectional and state.prev_out_name \
                        and state.prev_gray2 is not None:
                    flow_name = state.prev_out_name
                    # Predict the middle frame from the per-pixel matching
                    # direction: prev-of-prev where t < 0, current where
                    # t > 0 (OpticalFlow_BlockMatching.cpp:702-752).
                    comp_p = _host(compensate(
                        _on(state.prev_gray2, device, dtype), u_t, v_t))
                    comp_n = _host(compensate(_on(proc, device, dtype),
                                              u_t, v_t))
                    comp = np.where(out.t < 0, comp_p, comp_n)
                else:
                    comp = _host(compensate(
                        _on(state.prev_gray, device, dtype), u_t, v_t))
                tio.write_flow(flow_name, out.u, out.v)
                comp_name = str(Path(flow_name).with_name(
                    "compensated_" + Path(flow_name).name)) + ".pgm"
                tio.write_image(comp_name, comp, maxint)
                tio.write_image(_insert_tag(out_name, "segmentation_") + ".pgm",
                                out.segmentation.labels.astype(np.float64),
                                max(out.segmentation.n_regions - 1, 1))
                tio.write_image(_insert_tag(out_name, "color-quantized_")
                                + ".ppm", out.quantized_rgb, 255)
                tio.write_flow(_insert_tag(out_name, "shift-vector_"),
                               out.shift_vector[..., 0],
                               out.shift_vector[..., 1])
                if opts.debug_dumps:
                    _dump_pyramid(proc, maxint, mm.level, out_name, device,
                                  dtype)

    elif mode & (MODE_OUTPUT_HOG | MODE_OUTPUT_HOG_RAW
                 | MODE_OUTPUT_HOG_MATCHING_VECTOR):
        from tpuflow_torch.features import hog_descriptor, hog_matching

        hp = opts.hog_param
        with trace_span("pipeline.hog"):
            raw, block = hog_descriptor(
                _on(proc / maxint, device, dtype), bins=hp.bins,
                signed=hp.signed_orientation, dense=hp.dense)
        raw_np, block_np = _host(raw), _host(block)
        results["hog_raw"] = raw_np
        results["hog"] = block_np
        if mode & MODE_OUTPUT_HOG_MATCHING_VECTOR:
            if state.hog_prev is not None \
                    and state.hog_prev.shape == block_np.shape:
                with trace_span("pipeline.hog_match"):
                    u, v, score = (_host(t) for t in hog_matching(
                        _on(state.hog_prev, device, dtype), block))
                results["hog_vector"] = (u, v, score)
                comp = _hog_compensated(proc, u, v, hp.dense, device, dtype)
                results["hog_compensated"] = comp
                if write_outputs:
                    tio.write_flow(out_name, u, v, score)
                    # HOG_vector_compensated_write (HOG_match.cpp:125-145):
                    # "compensated" inserted before the extension, PNM
                    # bytes regardless of the extension (pnm.write).
                    stem = Path(out_name)
                    comp_name = str(stem.with_name(
                        stem.stem + "compensated" + (stem.suffix or ".pgm")))
                    tio.write_pnm(comp_name, comp, maxint)
            else:
                tel.event("pipeline.skip", reason="no previous HOG")
        elif write_outputs:
            if mode & MODE_OUTPUT_HOG_RAW:
                tio.write_hog(out_name, raw_np, hp.signed_orientation)
            else:
                tio.write_hog(out_name, block_np, hp.signed_orientation)
        state.hog_prev = block_np
        state.hog_raw_prev = raw_np

    else:
        # Scratch detection (+ optional meaningful alignments).
        from tpuflow_torch.detection import detect_scratch

        with trace_span("pipeline.scratch"):
            smap_t, filtered = detect_scratch(_on(proc, device, dtype),
                                              opts.s_med, opts.s_avg,
                                              opts.filter_param)
        smap = _host(smap_t)
        results["scratch_map"] = smap
        if opts.debug_dumps and write_outputs:
            # Detection.cpp:67-79 writes the prefiltered image to
            # "filtered.pgm" in cwd; written next to the output here.
            tio.write_image(Path(out_name).parent / "filtered.pgm",
                            _host(filtered), maxint)
        if mode & MODE_OUTPUT_BINARY_IMAGE:
            if write_outputs:
                tio.write_image(out_name, smap, maxint)
        else:
            from tpuflow_torch.detection import (
                aligned_segments_vertical,
                calc_k_l,
                exclusive_principle,
                l_min_for,
                pr_table,
            )
            from tpuflow_torch.ops import derivative_angler
            from tpuflow_torch.viz.plot2d import plot_segments, superimpose

            h, w = smap.shape
            if state.pr_table is None:
                with trace_span("pipeline.pr_table"):
                    state.pr_table = pr_table(max(w, h), opts.p)
                    state.k_list = calc_k_l(w, h, opts.p, opts.ep,
                                            state.pr_table)
                    state.l_min = l_min_for(w, h, opts.p, opts.ep)
            angles = _host(derivative_angler(smap_t))
            with trace_span("pipeline.alignments"):
                segs = aligned_segments_vertical(
                    angles, state.k_list, state.l_min, state.pr_table,
                    opts.max_length, opts.max_output_length, opts.p, opts.ep)
            tel.event("pipeline.segments", count=len(segs))
            if opts.exclusive_principle and segs:
                with trace_span("pipeline.exclusive"):
                    segs, index_map = exclusive_principle(
                        angles, segs, state.k_list, state.pr_table,
                        opts.exclusive_max_radius)
                tel.event("pipeline.segments_ep", count=len(segs))
                if opts.debug_dumps and write_outputs:
                    # Exclusive.cpp:27-31 (unowned -1 clipped to 0).
                    tio.write_image(
                        Path(out_name).parent / "IndexMap.pgm",
                        np.maximum(index_map, 0).astype(np.float64),
                        max(len(segs), 1))
            results["segments"] = segs

            negate = bool(opts.plot_options & PLOT_NEGATE)
            as_res = bool(opts.plot_options & PLOT_AS_RESAMPLED)
            size_out = (w, h) if as_res else (gray.shape[1], gray.shape[0])
            plot = plot_segments(segs, (w, h), size_out, negate)
            results["plot"] = plot
            if opts.superimpose:
                base = proc if as_res else (orig if orig.ndim == 3 else gray)
                over = superimpose(base, plot, opts.superimpose, negate,
                                   maxint)
                results["superimposed"] = over
                if write_outputs:
                    tio.write_image(out_name, over, maxint)
            elif write_outputs:
                tio.write_image(out_name, plot.astype(np.float64), maxint)
            if opts.x11_plot and write_outputs:
                from tpuflow_torch.viz.plot3d import render_scene

                scene = render_scene(proc, None, segs, float(maxint))
                tio.write_image(str(Path(out_name).with_suffix("")) +
                                "_3d.png", scene, 255)

    state.prev_gray2 = state.prev_gray
    state.prev_rgb = proc_rgb
    state.prev_gray = proc
    state.prev_out_name = out_name
    return results, state


def _frames(in_names):
    """(frame, maxint) per input name: binary PNM decoded on the native
    prefetcher's threads (frame N+1's read overlaps frame N's work; a
    build or load failure of the native library raises), other formats
    read here."""
    if all(str(p).lower().endswith((".pgm", ".ppm")) for p in in_names):
        from tpuflow_torch.native import FramePrefetcher

        with FramePrefetcher(in_names, threads=2) as pf:
            yield from pf
        return
    for p in in_names:
        yield tio.read_image(p)


def _digest(results: dict) -> str:
    """A hash of a frame's results (arrays, segments, flagship outputs),
    to hold the ranks of a mesh run to the same output."""
    h = hashlib.sha256()

    def add(v):
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode() + str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for fl in dataclasses.fields(v):
                add(getattr(v, fl.name))
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x)
        else:
            h.update(repr(v).encode())

    for key in sorted(results):
        h.update(key.encode())
        add(results[key])
    return h.hexdigest()


def _frame_loop(input_pattern, output_pattern, start, end, opts, state,
                checkpoint_path, device, dtype, mesh=None, on_frame=None):
    tel = get_telemetry()
    write = mesh is None or (mesh.iy, mesh.ix) == (0, 0)
    in_names = [tio.expand_frame_pattern(input_pattern, num)
                for num in range(start, end + 1)]
    for num, (frame, maxint) in zip(range(start, end + 1),
                                    _frames(in_names)):
        in_name = in_names[num - start]
        out_name = tio.expand_frame_pattern(output_pattern, num)
        if write:
            tel.event("pipeline.frame", num=num, input=in_name,
                      output=out_name)
        with trace_span("pipeline.process", frame=num):
            results, state = process_frame(
                frame.astype(np.float64), maxint, opts, out_name, state,
                write_outputs=write, device=device, dtype=dtype, mesh=mesh)
        if on_frame is not None:
            on_frame(num, results)
        if checkpoint_path and write:
            state.save(checkpoint_path)
    return state


def _mesh_rank(mesh, input_pattern, output_pattern, start, end, opts, state,
               checkpoint_path, dtype):
    """One rank of a mesh run: the whole frame loop on this rank, its
    results' digests compared with every other rank's after each frame."""
    import torch.distributed as dist

    def agree(num, results):
        mine = _digest(results)
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.group)
        if len(set(every)) != 1:
            raise RuntimeError(f"run_pipeline: the mesh's ranks disagree on "
                               f"frame {num}")

    state = _frame_loop(input_pattern, output_pattern, start, end, opts,
                        state.to(mesh.device), checkpoint_path, mesh.device,
                        dtype, mesh=mesh, on_frame=agree)
    return state.to("cpu")


def run_pipeline(
    input_pattern: str,
    output_pattern: str,
    start: int,
    end: int,
    opts: Options | None = None,
    state: PipelineState | None = None,
    checkpoint_path: str | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> PipelineState:
    """The frame loop (Scratch_MeaningfulMotion.cpp:79-599) on ``device``.

    With ``opts.devices > 0`` the loop runs on that many spawned ranks
    (NCCL on cards, gloo on the CPU), once for the whole sequence; the
    returned state is rank 0's, on ``device``."""
    if opts is None:
        opts = Options()
    if state is None:
        state = PipelineState()
    if opts.devices:
        from tpuflow_torch.dist import run_on_mesh

        kind = torch.device(device).type
        state = run_on_mesh(
            _mesh_rank, int(opts.devices),
            "nccl" if kind == "cuda" else "gloo", kind,
            args=(input_pattern, output_pattern, start, end, opts,
                  state.to("cpu"), checkpoint_path, dtype))
        return state.to(device)
    return _frame_loop(input_pattern, output_pattern, start, end, opts,
                       state, checkpoint_path, device, dtype)
