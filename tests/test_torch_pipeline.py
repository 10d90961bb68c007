"""tpuflow_torch's main program (``pipeline/orchestrator``) against
tpuflow's, on the CPU: the scratch, filtered and affine modes (HOG in
tests/test_torch_pipeline_hog.py, the flagship's in
tests/test_torch_pipeline_bm.py), from the same files to files.

The port runs with ``device="cpu"`` and float64, tpuflow under the
tests' x64. Both write into their own folder under the same names; the
folders must hold the same files, and:

- byte for byte: the scratch plots (alignments, exclusive principle,
  superimposed, negated, resampled), the binary maps, the filtered
  frames (epsilon and Gaussian prefilters), the debug dumps
  (filtered.pgm, IndexMap.pgm, Pyramid_%04d.pgm), the 3-D scene PNG and
  the resampled-only frames;
- the multiple-motion affine fit within 1e-9 (tests/test_torch_affine.py
  holds the solver to 1e-9 at float64).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as gf

import tpuflow.core.config as jcfg
from tpuflow.pipeline import orchestrator as jorch
from tpuflow_torch.core import io as tio
from tpuflow_torch.core.config import from_tpuflow
from tpuflow_torch.pipeline import orchestrator as torch_orch

AFFINE_ATOL = 1e-9


def _scratch_frames(folder: Path, n=3, h=40, w=56, rgb=False):
    rng = np.random.default_rng(0)
    for i in range(n):
        img = np.full((h, w), 100.0) + rng.normal(0, 0.5, (h, w))
        img[:, 28] += 40
        img[:, 10 + i] += 35
        for y in range(h):
            img[y, 40 + y // 10] -= 30
        img = np.clip(img, 0, 255).astype(np.uint8)
        if rgb:
            img = np.stack([img, np.roll(img, 1, 1), img // 2], -1)
        tio.write_pnm(folder / f"in_{i:04d}.{'ppm' if rgb else 'pgm'}", img)
    return str(folder / f"in_%04d.{'ppm' if rgb else 'pgm'}")


def _motion_frames(folder: Path, n=3, h=72, w=96, step=2):
    rng = np.random.default_rng(11)
    pad = step * n
    base = gf(rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad)), 2.5)
    base = 40 + (base - base.min()) / (np.ptp(base) + 1e-9) * 175
    for i in range(n):
        o = step * i
        tio.write_pnm(folder / f"in_{i:04d}.pgm",
                      base[o:o + h, o:o + w].astype(np.uint8))
    return str(folder / "in_%04d.pgm")


def _run_both(tmp_path, pattern, out_name, opts, end=2):
    outs = {}
    for tag in ("j", "t"):
        folder = tmp_path / tag
        folder.mkdir()
        out = str(folder / out_name)
        if tag == "j":
            jorch.run_pipeline(pattern, out, 0, end, opts)
        else:
            torch_orch.run_pipeline(pattern, out, 0, end, from_tpuflow(opts),
                                    device="cpu", dtype=torch.float64)
        outs[tag] = folder
    names = sorted(p.name for p in outs["j"].iterdir())
    assert names == sorted(p.name for p in outs["t"].iterdir())
    assert names
    return outs["j"], outs["t"], names


def _same_bytes(j, t, names):
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name


def _opts(**kw):
    opts = jcfg.Options()
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


SCRATCH_CASES = {
    "alignments": dict(),
    "binary": dict(mode=jcfg.MODE_OUTPUT_BINARY_IMAGE),
    "exclusive_red": dict(exclusive_principle=True, superimpose=jcfg.RED),
    "negate_blue": dict(plot_options=jcfg.PLOT_NEGATE,
                        superimpose=jcfg.BLUE),
    "lengths": dict(max_length=20, max_output_length=30, ep=0.5),
    "debug_dumps": dict(debug_dumps=True, exclusive_principle=True),
    "x11_plot": dict(x11_plot=True),
    "resampled": dict(resample_size=(48, 36), resample_method=1,
                      plot_options=jcfg.PLOT_AS_RESAMPLED),
    "resampled_only": dict(resample_size=(28, 20),
                           plot_options=jcfg.PLOT_RESAMPLED_IMG_ONLY),
}


@pytest.mark.parametrize("case", sorted(SCRATCH_CASES))
def test_scratch_modes(tmp_path, case):
    pattern = _scratch_frames(tmp_path)
    j, t, names = _run_both(tmp_path, pattern, "out_%04d.pgm",
                            _opts(**SCRATCH_CASES[case]))
    _same_bytes(j, t, names)
    if case == "alignments":
        plot, _ = tio.read_pnm(t / "out_0000.pgm")
        assert plot[:, 26:31].max() == 255
    if case == "debug_dumps":
        assert {"filtered.pgm", "IndexMap.pgm"} <= set(names)


def test_scratch_on_rgb_frames(tmp_path):
    pattern = _scratch_frames(tmp_path, rgb=True)
    j, t, names = _run_both(tmp_path, pattern, "out_%04d.ppm",
                            _opts(superimpose=jcfg.GREEN))
    _same_bytes(j, t, names)


@pytest.mark.parametrize("kind", ["epsilon", "gaussian"])
def test_filtered_mode(tmp_path, kind):
    pattern = _scratch_frames(tmp_path)
    opts = _opts(mode=jcfg.MODE_OUTPUT_FILTERED_IMAGE)
    opts.filter_param = opts.filter_param.change_filter(kind)
    opts.filter_param.size = (7, 5)
    j, t, names = _run_both(tmp_path, pattern, "f_%04d.pgm", opts)
    _same_bytes(j, t, names)


def test_affine_mode(tmp_path):
    pattern = _motion_frames(tmp_path)
    opts = _opts(mode=jcfg.MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE,
                 debug_dumps=True)
    opts.multiple_motion_param.level = 2
    j, t, names = _run_both(tmp_path, pattern, "aff_%04d.txt", opts)
    assert "aff_0000.txt" not in names
    for name in ("aff_0001.txt", "aff_0002.txt"):
        np.testing.assert_allclose(tio.read_affine(t / name),
                                   tio.read_affine(j / name), rtol=0,
                                   atol=AFFINE_ATOL)
    _same_bytes(j, t, [n for n in names if n.startswith("Pyramid_")])


def test_process_frame_results_match(tmp_path):
    """The results dict of one frame: the same keys and arrays."""
    img = np.asarray(tio.read_image(_scratch_frames(tmp_path, n=1)
                                    .replace("%04d", "0000"))[0],
                     np.float64)
    opts = _opts(exclusive_principle=True, superimpose=jcfg.RED)
    jres, _ = jorch.process_frame(img, 255, opts, str(tmp_path / "a.pgm"),
                                  jorch.PipelineState(), write_outputs=False)
    tres, st = torch_orch.process_frame(
        img, 255, from_tpuflow(opts), str(tmp_path / "b.pgm"),
        torch_orch.PipelineState(), write_outputs=False, device="cpu",
        dtype=torch.float64)
    assert sorted(tres) == sorted(jres)
    for key in ("scratch_map", "plot", "superimposed"):
        np.testing.assert_array_equal(tres[key], np.asarray(jres[key]))
    assert [(s.n, s.m, s.x, s.y, s.pr) for s in tres["segments"]] == \
        [(s.n, s.m, s.x, s.y, s.pr) for s in jres["segments"]]
    assert st.frame_size == img.shape and not list(tmp_path.glob("[ab].*"))


def test_size_change_rejected(tmp_path):
    tio.write_pnm(tmp_path / "a_0000.pgm", np.full((20, 30), 7, np.uint8))
    tio.write_pnm(tmp_path / "a_0001.pgm", np.full((24, 30), 7, np.uint8))
    with pytest.raises(ValueError, match="frame size changed"):
        torch_orch.run_pipeline(str(tmp_path / "a_%04d.pgm"),
                                str(tmp_path / "o_%04d.pgm"), 0, 1,
                                device="cpu")


def test_insert_tag_matches_tpuflow():
    for name in ("of_0001.dat", "out.pgm", "x/y/frame12", "noext"):
        for tag in ("segmentation_", "shift-vector_"):
            assert torch_orch._insert_tag(name, tag) == \
                jorch._insert_tag(name, tag)


def test_png_input_reads_synchronously(tmp_path):
    """Non-PNM sequences read through core.io (PIL), not the prefetcher."""
    img = np.full((24, 32), 100, np.uint8)
    img[:, 12] = 150
    tio.write_image(tmp_path / "p_0000.png", img)
    torch_orch.run_pipeline(str(tmp_path / "p_%04d.png"),
                            str(tmp_path / "o_%04d.pgm"), 0, 0,
                            jcfg_to_port(jcfg.MODE_OUTPUT_BINARY_IMAGE),
                            device="cpu")
    out, _ = tio.read_pnm(tmp_path / "o_0000.pgm")
    assert (out[:, 12] == 255).all()


def jcfg_to_port(mode):
    return from_tpuflow(_opts(mode=mode))
