"""tpuflow_torch's file I/O and errors against tpuflow's, on the CPU.

Every reader and writer round-trips; for PNM (binary and ASCII, 8 and 16
bit, gray and RGB), flow (2 and 3 components), affine, HOG and the
matrix-txt dump the port's files are byte-equal to tpuflow's, and each
package reads the other's files to equal arrays. PNG goes through PIL in
both packages (the card's machine has it too), so the port's PNGs are
held byte-equal to tpuflow's. Inputs are seeded numpy arrays at tens of
pixels; no tolerance anywhere: every comparison is exact.
"""

import io
import json

import numpy as np
import pytest
import torch

from tpuflow.core import errors as jerr
from tpuflow.core import io as jio
from tpuflow.utils import telemetry as jtel
from tpuflow_torch.core import errors as terr
from tpuflow_torch.core import io as tio
from tpuflow_torch.utils import telemetry as ttel

RNG = np.random.default_rng(12)
H, W = 11, 17


def _img(rgb: bool, maxval: int):
    shape = (H, W, 3) if rgb else (H, W)
    dtype = np.uint16 if maxval > 255 else np.uint8
    return RNG.integers(0, maxval + 1, shape).astype(dtype)


PNM_CASES = [(rgb, maxval, binary) for rgb in (False, True)
             for maxval in (255, 4095) for binary in (True, False)]


@pytest.mark.parametrize("rgb,maxval,binary", PNM_CASES)
def test_pnm_round_trip_and_bytes(tmp_path, rgb, maxval, binary):
    img = _img(rgb, maxval)
    ext = ".ppm" if rgb else ".pgm"
    mine, theirs = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    tio.write_pnm(mine, img, maxval=maxval, binary=binary)
    jio.write_pnm(theirs, img, maxval=maxval, binary=binary)
    assert mine.read_bytes() == theirs.read_bytes()
    arr, mv = tio.read_pnm(mine)
    assert mv == maxval and arr.dtype == img.dtype
    np.testing.assert_array_equal(arr, img)
    # read_image: binary through the native codec (float64), ASCII through
    # read_pnm; tpuflow's read_image gives the same values.
    got, mv = tio.read_image(mine)
    want, jmv = jio.read_image(theirs)
    assert mv == jmv == maxval
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("scale", [1.0, 256.0])
def test_pnm_float_input_bytes(tmp_path, scale):
    """Float data is scaled, clipped and truncated as tpuflow's."""
    img = RNG.uniform(-3, 300, (H, W)) / scale
    tio.write_pnm(tmp_path / "t.pgm", img, scale=scale)
    jio.write_pnm(tmp_path / "j.pgm", img, scale=scale)
    assert (tmp_path / "t.pgm").read_bytes() == \
        (tmp_path / "j.pgm").read_bytes()


def test_pnm_header_comments(tmp_path):
    img = _img(False, 255)
    body = b"P5\n# a comment\n17 # width\n11\n255\n" + img.tobytes()
    (tmp_path / "c.pgm").write_bytes(body)
    arr, _ = tio.read_pnm(tmp_path / "c.pgm")
    np.testing.assert_array_equal(arr, jio.read_pnm(tmp_path / "c.pgm")[0])


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_png_round_trip_and_bytes(tmp_path, mode):
    maxval = 65535 if mode == "I;16" else 255
    if mode == "RGBA":
        img = RNG.integers(0, 256, (H, W, 4)).astype(np.uint8)
    else:
        img = _img(mode == "RGB", maxval)
    tio.write_image(tmp_path / "t.png", img, maxval=maxval)
    jio.write_image(tmp_path / "j.png", img, maxval=maxval)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    got, mv = tio.read_image(tmp_path / "t.png")
    want, jmv = jio.read_image(tmp_path / "j.png")
    assert mv == jmv
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img[..., :3] if mode == "RGBA"
                                  else img)


def test_png_float_input(tmp_path):
    img = RNG.uniform(-5, 1100, (H, W, 3))
    tio.write_image(tmp_path / "t.png", img, maxval=1023)
    jio.write_image(tmp_path / "j.png", img, maxval=1023)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("components", [2, 3])
def test_flow_round_trip_and_bytes(tmp_path, components):
    u, v, s = (RNG.normal(0, 5, (H, W)) for _ in range(3))
    score = s if components == 3 else None
    tio.write_flow(tmp_path / "t.bin", u, v, score)
    jio.write_flow(tmp_path / "j.bin", u, v, score)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    got = tio.read_flow(tmp_path / "t.bin", components)
    for a, b in zip(got, (u, v, s)[:components]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jio.read_flow(tmp_path / "t.bin", components)):
        np.testing.assert_array_equal(a, b)


def test_affine_round_trip_and_bytes(tmp_path):
    a = RNG.normal(0, 1, 6) * np.array([1, 1e-3, 1e5, 1, -1e-9, 3])
    tio.write_affine(tmp_path / "t.txt", a)
    jio.write_affine(tmp_path / "j.txt", a)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(tio.read_affine(tmp_path / "t.txt"),
                                  jio.read_affine(tmp_path / "t.txt"))
    np.testing.assert_allclose(tio.read_affine(tmp_path / "t.txt"), a,
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("signed", [False, True])
def test_hog_round_trip_and_bytes(tmp_path, signed):
    hog = RNG.uniform(0, 1, (5, 7, 16))
    tio.write_hog(tmp_path / "t.hog", hog, signed)
    jio.write_hog(tmp_path / "j.hog", hog, signed)
    assert (tmp_path / "t.hog").read_bytes() == \
        (tmp_path / "j.hog").read_bytes()
    arr, sg = tio.read_hog(tmp_path / "t.hog")
    assert sg == signed
    np.testing.assert_array_equal(arr, hog)


def test_matrix_txt_bytes_and_opencv_read_back(tmp_path):
    m = RNG.normal(0, 3, (7, 9))
    m[0, 0], m[1, 1], m[2, 2] = np.inf, -np.inf, np.nan
    tio.write_matrix_txt(tmp_path / "t.txt", m, "u matrix")
    jio.write_matrix_txt(tmp_path / "j.txt", m, "u matrix")
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    cv2 = pytest.importorskip("cv2")
    fs = cv2.FileStorage(str(tmp_path / "t.txt"), cv2.FILE_STORAGE_READ)
    back = fs.getNode("u matrix").mat()
    fs.release()
    np.testing.assert_array_equal(back, m)


@pytest.mark.parametrize("pattern", [
    "frame_%04d.pgm", "f%d.png", "a%3d_%02d.ppm", "plain.pgm", "x%05d",
    "%0d-%d"])
@pytest.mark.parametrize("num", [0, 7, 12345])
def test_expand_frame_pattern_matches(pattern, num):
    assert tio.expand_frame_pattern(pattern, num) == \
        jio.expand_frame_pattern(pattern, num)


@pytest.mark.parametrize("body,match", [
    (b"GIF89a", "not a PNM"), (b"P4\n1 1\n", "unsupported PNM magic P4")])
def test_read_pnm_errors_match(tmp_path, body, match):
    path = tmp_path / "bad.pgm"
    path.write_bytes(body)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match=match):
            mod.read_pnm(path)


def test_native_read_failure_raises(tmp_path):
    """A truncated binary PNM raises from the native codec; nothing falls
    back to the Python codec."""
    path = tmp_path / "short.pgm"
    path.write_bytes(b"P5\n17 11\n255\n" + b"\0" * 20)
    with pytest.raises(IOError, match="tf_read_pnm failed"):
        tio.read_image(path)


def test_missing_file_raises(tmp_path):
    for mod in (tio, jio):
        with pytest.raises(FileNotFoundError):
            mod.read_image(tmp_path / "absent.pgm")


@pytest.mark.parametrize("cls", ["TpuflowError", "FunctionFailError",
                                 "ValueIncorrectError", "PointerNullError",
                                 "FileReadError", "FileWriteError"])
def test_errors_match(cls, monkeypatch):
    """Same message, fields, kind and telemetry event as tpuflow's."""
    events = []
    for mod, tel in ((terr, ttel), (jerr, jtel)):
        stream = io.StringIO()
        monkeypatch.setattr(tel, "_GLOBAL", tel.Telemetry(stream))
        err = getattr(mod, cls)("Read", value="42", file="a.pgm",
                                detail="short read")
        assert isinstance(err, RuntimeError)
        assert (err.function, err.value, err.file) == ("Read", "42", "a.pgm")
        rec = json.loads(stream.getvalue())
        rec.pop("ts")
        events.append((str(err), err.kind, rec))
    assert events[0] == events[1]
    assert events[0][0] == ("*** Read error - value (42) - file 'a.pgm' : "
                            "short read")


def test_trace_span_matches(monkeypatch):
    recs = []
    for tel in (ttel, jtel):
        stream = io.StringIO()
        monkeypatch.setattr(tel, "_GLOBAL", tel.Telemetry(stream))
        with tel.trace_span("stage", frame=3):
            pass
        with tel.trace_span("stage"):
            pass
        lines = [json.loads(x) for x in stream.getvalue().splitlines()]
        assert all(r["wall_s"] >= 0 for r in lines)
        recs.append([{k: v for k, v in r.items() if k not in ("ts", "wall_s")}
                     for r in lines])
    assert recs[0] == recs[1] == [{"event": "stage.done", "frame": 3},
                                  {"event": "stage.done"}]


def test_trace_span_profile_labels_the_trace():
    """A span labels the trace of a recording profiler unasked."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttel.trace_span("tiled_stage"):
            torch.ones(4) + 1
    assert "tiled_stage" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("rgb,method", [(False, "nearest"), (True, "nearest"),
                                        (False, "bilinear")])
def test_writers_match(tmp_path, rgb, method):
    """write_flow_with_compensated (the flow file and the compensated
    PGM/PPM beside it) and write_affine_params: byte-equal to tpuflow's,
    from numpy arrays and, for the port, from CPU tensors."""

    from tpuflow.pipeline import writers as jw
    from tpuflow_torch.pipeline import writers as tw

    img = RNG.uniform(0, 255, (H, W, 3) if rgb else (H, W))
    u, v = (RNG.normal(0, 2, (H, W)) for _ in range(2))
    for sub, args in (("t", (img, u, v)),
                      ("tt", tuple(torch.from_numpy(a) for a in (img, u, v))),
                      ("j", (img, u, v))):
        (tmp_path / sub).mkdir()
        mod = jw if sub == "j" else tw
        kw = {"device": "cpu"} if sub == "t" else {}
        path = mod.write_flow_with_compensated(tmp_path / sub / "flow.bin",
                                               *args, method=method, **kw)
        assert path == tmp_path / sub / "compensated_flow.bin"
        mod.write_affine_params(tmp_path / sub / "a.txt",
                                args[1][:2, :3].reshape(-1))
    comp = "compensated_flow." + ("ppm" if rgb else "pgm")
    for name in ("flow.bin", comp, "a.txt"):
        want = (tmp_path / "j" / name).read_bytes()
        assert (tmp_path / "t" / name).read_bytes() == want
        assert (tmp_path / "tt" / name).read_bytes() == want


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the card default on a host without one")
def test_writer_numpy_defaults_to_the_card(tmp_path):
    """Numpy frames go to the card unless the caller passes
    device="cpu": on a host without CUDA the default call raises."""
    from tpuflow_torch.pipeline import writers as tw

    u = np.zeros((H, W))
    with pytest.raises((RuntimeError, AssertionError)):
        tw.write_flow_with_compensated(tmp_path / "flow.bin",
                                       np.zeros((H, W)), u, u)
    assert not (tmp_path / "flow.bin").exists()
