"""tpuflow_torch's native C++ library against its plain versions and
tpuflow's, on the CPU.

- The codecs: the native PNM reader equals the Python one (binary, 8 and
  16 bit, gray and RGB); the native PNM and flow writers' files are
  byte-equal to the Python writers' on integer-valued images and any
  flow; the native flow reader reads both back exactly.
- ``FramePrefetcher`` delivers every frame in order, at several thread
  counts and ring capacities, and ``ImageSequenceSource`` yields the same
  frames with and without it, and as tpuflow's.
- ``label_regions`` (the flagship's labeler) is bitwise
  ``_merge_labels_plain`` and tpuflow's labeler (equal labels, equal
  region count) on mean-shift-filtered Voronoi Lab frames at four seeds.
- ``draw_quiver`` equals the Python body pixel for pixel.

Every comparison is exact. Inputs are seeded numpy arrays at tens of
pixels; the library builds with g++ at first use.
"""

import numpy as np
import pytest

import chip_smoke
from tpuflow.pipeline import streaming as jst
from tpuflow.segmentation import meanshift as jms
from tpuflow_torch import native
from tpuflow_torch.core import io as tio
from tpuflow_torch.pipeline import streaming as tst
from tpuflow_torch.segmentation import meanshift as tms
from tpuflow_torch.solvers.bm_flow import _to_lab
from tpuflow_torch.viz import quiver as tq

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("maxval", [255, 65535])
def test_native_pnm_equals_python_codec(tmp_path, rgb, maxval):
    shape = (13, 19, 3) if rgb else (13, 19)
    img = RNG.integers(0, maxval + 1, shape).astype(
        np.uint16 if maxval > 255 else np.uint8)
    ext = ".ppm" if rgb else ".pgm"
    tio.write_pnm(tmp_path / f"py{ext}", img, maxval=maxval)
    native.write_pnm(tmp_path / f"nat{ext}", img, maxval=maxval)
    assert (tmp_path / f"py{ext}").read_bytes() == \
        (tmp_path / f"nat{ext}").read_bytes()
    got, mv = native.read_pnm(tmp_path / f"py{ext}")
    want, wmv = tio.read_pnm(tmp_path / f"py{ext}")
    assert mv == wmv == maxval and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("components", [2, 3])
def test_native_flow_equals_python_codec(tmp_path, components):
    u, v, s = (RNG.normal(0, 4, (9, 14)) for _ in range(3))
    score = s if components == 3 else None
    tio.write_flow(tmp_path / "py.bin", u, v, score)
    native.write_flow(tmp_path / "nat.bin", u, v, score)
    assert (tmp_path / "py.bin").read_bytes() == \
        (tmp_path / "nat.bin").read_bytes()
    for a, b in zip(native.read_flow(tmp_path / "py.bin", components),
                    tio.read_flow(tmp_path / "py.bin", components)):
        np.testing.assert_array_equal(a, b)


def test_native_errors(tmp_path):
    with pytest.raises(IOError, match="tf_read_pnm failed"):
        native.read_pnm(tmp_path / "absent.pgm")
    with pytest.raises(IOError, match="tf_flow_size failed"):
        native.read_flow(tmp_path / "absent.bin")
    with pytest.raises(IOError, match="tf_write_pnm failed"):
        native.write_pnm(tmp_path / "no" / "dir.pgm", np.zeros((2, 2)))


def _sequence(tmp_path, n, rgb):
    frames = []
    for k in range(n):
        shape = (8 + k % 3, 10, 3) if rgb else (8 + k % 3, 10)
        f = RNG.integers(0, 256, shape).astype(np.uint8)
        tio.write_pnm(tmp_path / f"f_{k:03d}.{'ppm' if rgb else 'pgm'}", f)
        frames.append(f)
    return frames, str(tmp_path / f"f_%03d.{'ppm' if rgb else 'pgm'}")


@pytest.mark.parametrize("threads,capacity", [(1, 1), (3, 2), (4, 8)])
def test_prefetcher_delivers_in_order(tmp_path, threads, capacity):
    frames, pattern = _sequence(tmp_path, 12, rgb=False)
    paths = [tio.expand_frame_pattern(pattern, k) for k in range(12)]
    with native.FramePrefetcher(paths, threads=threads,
                                capacity=capacity) as pf:
        got = list(pf)
    assert len(got) == 12
    for (arr, mv), want in zip(got, frames):
        assert mv == 255
        np.testing.assert_array_equal(arr, want)


def test_prefetcher_reports_a_bad_frame(tmp_path):
    _, pattern = _sequence(tmp_path, 3, rgb=False)
    paths = [tio.expand_frame_pattern(pattern, k) for k in range(3)]
    paths[1] = str(tmp_path / "absent.pgm")
    with native.FramePrefetcher(paths, threads=2) as pf:
        next(pf)
        with pytest.raises(IOError, match="absent.pgm"):
            next(pf)


@pytest.mark.parametrize("rgb", [False, True])
def test_image_sequence_source_matches(tmp_path, rgb):
    frames, pattern = _sequence(tmp_path, 6, rgb)
    fetched = list(tst.ImageSequenceSource(pattern, 1, 5, prefetch=True,
                                           threads=3))
    plain = list(tst.ImageSequenceSource(pattern, 1, 5))
    theirs = list(jst.ImageSequenceSource(pattern, 1, 5, prefetch=True))
    assert len(fetched) == len(plain) == len(theirs) == 5
    for a, b, c, want in zip(fetched, plain, theirs, frames[1:]):
        for x in (a, b, c):
            np.testing.assert_array_equal(x, want)


def test_video_source_matches(tmp_path):
    cv2 = pytest.importorskip("cv2")
    clip = tmp_path / "clip.avi"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (32, 24))
    base = RNG.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    for k in range(3):
        wr.write(np.roll(base, k, axis=1))
    wr.release()
    got = list(tst.video_source(clip))
    want = list(jst.video_source(clip))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def filtered_voronoi():
    """Mean-shift-filtered Lab of the middle Voronoi frame at four seeds
    (64x96, ~40 cells; kernel 6 px, 8 iterations on the plain filter)."""
    out = {}
    for seed in (1, 2, 3, 4):
        frames, _ = chip_smoke.voronoi_frames(
            shape=(64, 96), cells_per_px=40 / (64 * 96), pan=(1, 2),
            seed=seed)
        _, lab = _to_lab(frames[1], 255.0)
        pos, col = tms.mean_shift_filter(lab.double(), 6, 16.0 / 255.0, 8)
        out[seed] = (pos.numpy(), col.numpy())
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("min_size", [1, 16, 60])
def test_label_regions_is_bitwise_plain(filtered_voronoi, seed, min_size):
    pos, col = filtered_voronoi[seed]
    args = (pos, col, 6.0, 16.0 / 255.0, min_size)
    labels, n = native.label_regions(*args)
    plain, n_plain = tms._merge_labels_plain(*args)
    theirs, n_theirs = jms._merge_labels_py(*args)
    assert n == n_plain == n_theirs > 1
    np.testing.assert_array_equal(labels, plain)
    np.testing.assert_array_equal(labels, theirs)
    # The flagship's labeling is the native one.
    got, n_got = tms._merge_labels(*args)
    assert n_got == n
    np.testing.assert_array_equal(got, labels)


@pytest.mark.parametrize("delta,scale,outlier", [
    (4, 1.0, 0.0), (5, 7.5, 2.0), (3, -3.0, 0.5), (7, 20.0, 5.0)])
@pytest.mark.parametrize("gray", [False, True])
def test_draw_quiver_equals_python(delta, scale, outlier, gray):
    h, w = 31, 45
    img = RNG.integers(0, 256, (h, w) if gray else (h, w, 3)).astype(
        np.uint8)
    u, v = (RNG.normal(0, 2, (h, w)) for _ in range(2))
    kw = dict(delta=delta, scale=scale, outlier=outlier,
              line_color=(10, 200, 30), tip_color=(250, 5, 99))
    got = tq.plot_quiver(img, u, v, **kw)
    want = tq.plot_quiver_plain(img, u, v, **kw)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != (np.stack([img] * 3, -1) if gray else img)).any()


def test_library_builds_once_into_build_dir():
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.suffix == ".so"
    assert native.build_library() == path
    assert native.load_library() is native.load_library()
