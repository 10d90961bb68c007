"""tpuflow_torch's pair demos against tpuflow's, on the CPU.

Synthetic pairs (a smoothed seeded texture moved by a known shift) are
written to ``tmp_path`` as gray PGM, RGB PPM and RGB PNG at 48x64, and
each demo runs in both packages from the same files: the port with
``device="cpu"`` and float64 (tpuflow runs float64 under x64), so the
parity tolerances are the solvers' own:

- HS: u, v within atol 1e-10 (tests/test_torch_horn_schunck.py);
- Farneback: within 1e-8 x max(1, max|u|) (tpuflow's default warp against
  the port's gather, tests/test_torch_farneback.py);
- LK: the same corners in the same order, tracked points within 1e-9 px
  (tests/test_torch_lucas_kanade.py), the same accept mask.

The written artifacts: the quiver and track PNGs are equal to tpuflow's
pixel for pixel, the matrix dumps parse back to the returned arrays
exactly and to tpuflow's within the tolerance above. The command line
runs each demo at its default float32 and writes what the library call
writes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow.pipeline import demos as jd
from tpuflow_torch.core.io import read_image, write_image, write_pnm
from tpuflow_torch.pipeline import demos as td

H, W = 48, 64
HS_ATOL = 1e-10
FB_ATOL = 1e-8
LK_ATOL = 1e-9
F64 = dict(device="cpu", dtype=torch.float64)


def _pair(seed=3, shift=(1, 2), rgb=True):
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (H + 16, W + 16, 3)),
                           (2.5, 2.5, 0))
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    prev = np.rint(base[8:8 + H, 8:8 + W])
    dy, dx = shift
    nxt = np.rint(base[8 - dy:8 - dy + H, 8 - dx:8 - dx + W])
    if not rgb:
        prev, nxt = prev[..., 0], nxt[..., 0]
    return prev.astype(np.uint8), nxt.astype(np.uint8)


def _files(tmp_path, ext, rgb=True):
    prev, nxt = _pair(rgb=rgb)
    paths = [tmp_path / f"prev{ext}", tmp_path / f"next{ext}"]
    for p, img in zip(paths, (prev, nxt)):
        (write_pnm if ext in (".pgm", ".ppm") else write_image)(p, img)
    return [str(p) for p in paths]


def _close(got, want, atol):
    bound = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _matrix(path, key):
    cv2 = pytest.importorskip("cv2")
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
    m = fs.getNode(key).mat()
    fs.release()
    return m


def _same_image(a: Path, b: Path):
    np.testing.assert_array_equal(read_image(a)[0], read_image(b)[0])


def _run(tmp_path, fn_t, fn_j, *args, **kw):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = fn_t(*args, f"{tmp_path}/t/", **kw, **F64)
    want = fn_j(*args, f"{tmp_path}/j/", **kw)
    return got, want


@pytest.mark.parametrize("ext,rgb", [(".pgm", False), (".ppm", True),
                                     (".png", True)])
def test_horn_schunck_demo_matches(tmp_path, ext, rgb):
    files = _files(tmp_path, ext, rgb)
    (u, v), (ju, jv) = _run(tmp_path, td.demo_horn_schunck,
                            jd.demo_horn_schunck, *files, max_iterations=30)
    assert u.shape == (H, W) and u.dtype == np.float64
    _close(u, np.asarray(ju), HS_ATOL)
    _close(v, np.asarray(jv), HS_ATOL)
    assert np.abs(u).max() > 0.1
    for name, arr in (("uMatrixHS.txt", u), ("vMatrixHS.txt", v)):
        key = name[0] + " matrix"
        np.testing.assert_array_equal(_matrix(tmp_path / "t" / name, key),
                                      arr)
        _close(_matrix(tmp_path / "t" / name, key),
               _matrix(tmp_path / "j" / name, key), HS_ATOL)
    _same_image(tmp_path / "t/hsbresenhamLineFlow.png",
                tmp_path / "j/hsbresenhamLineFlow.png")


def test_horn_schunck_demo_video(tmp_path):
    cv2 = pytest.importorskip("cv2")
    clip = tmp_path / "clip.avi"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (W, H))
    prev, _ = _pair()
    for k in range(4):
        wr.write(np.roll(prev, k, axis=1))
    wr.release()
    (u, v), (ju, jv) = _run(tmp_path, td.demo_horn_schunck,
                            jd.demo_horn_schunck, 1, 2, max_iterations=5,
                            video=str(clip))
    _close(u, np.asarray(ju), HS_ATOL)
    _close(v, np.asarray(jv), HS_ATOL)
    _same_image(tmp_path / "t/hsbresenhamLineFlow.png",
                tmp_path / "j/hsbresenhamLineFlow.png")


@pytest.mark.parametrize("cfg,matrices", [
    (dict(winsize=16, iterations=2, poly_n=5, poly_sigma=1.1), False),
    (dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
          poly_sigma=1.2), True)])
def test_farneback_demo_matches(tmp_path, cfg, matrices):
    files = _files(tmp_path, ".ppm")
    (u, v), (ju, jv) = _run(tmp_path, td.demo_farneback_pair,
                            jd.demo_farneback_pair, *files,
                            write_matrices=matrices, **cfg)
    _close(u, np.asarray(ju), FB_ATOL)
    _close(v, np.asarray(jv), FB_ATOL)
    assert 0.5 < np.abs(u).max() < 20.0
    name = f"Farneback-{cfg['winsize']}.png"
    _same_image(tmp_path / "t" / name, tmp_path / "j" / name)
    if matrices:
        for name, arr in (("uMatrixFB.txt", u), ("vMatrixFB.txt", v)):
            np.testing.assert_array_equal(
                _matrix(tmp_path / "t" / name, name[0] + " matrix"), arr)
        _same_image(tmp_path / "t/fbbresenhamLineFlow.png",
                    tmp_path / "j/fbbresenhamLineFlow.png")
    else:
        assert not (tmp_path / "t/uMatrixFB.txt").exists()


def test_lucas_kanade_demo_matches(tmp_path):
    files = _files(tmp_path, ".ppm")
    kw = dict(max_count=60, quality_level=0.01, min_distance=5.0,
              min_motion=1.0)
    pts, new, acc = td.demo_lucas_kanade(*files, tmp_path / "t.png", **kw,
                                         **F64)
    jpts, jnew, jacc = jd.demo_lucas_kanade(*files, tmp_path / "j.png", **kw)
    np.testing.assert_array_equal(pts, np.asarray(jpts))
    assert len(pts) > 10
    np.testing.assert_allclose(new, np.asarray(jnew), rtol=0, atol=LK_ATOL)
    np.testing.assert_array_equal(acc, np.asarray(jacc))
    assert acc.dtype == bool and acc.sum() > 5
    # The known shift (1, 2) px: the accepted tracks move by it.
    d = np.median(new[acc] - pts[acc], axis=0)
    np.testing.assert_allclose(d, [2.0, 1.0], atol=0.2)
    _same_image(tmp_path / "t.png", tmp_path / "j.png")


def test_main_command_line(tmp_path):
    files = _files(tmp_path, ".pgm", rgb=False)
    f32 = dict(device="cpu", dtype=torch.float32)
    for algo in ("hs", "fb", "lk"):
        out = tmp_path / algo
        out.mkdir()
        assert td.main([algo, *files, f"{out}/cli_", "--device", "cpu"]) == 0
    lib = tmp_path / "lib"
    lib.mkdir()
    u, _ = td.demo_horn_schunck(*files, f"{lib}/", **f32)
    np.testing.assert_array_equal(
        _matrix(tmp_path / "hs/cli_uMatrixHS.txt", "u matrix"),
        u.astype(np.float64))
    _same_image(tmp_path / "hs/cli_hsbresenhamLineFlow.png",
                lib / "hsbresenhamLineFlow.png")
    td.demo_farneback_pair(*files, f"{lib}/", **f32)
    _same_image(tmp_path / "fb/cli_Farneback-64.png", lib / "Farneback-64.png")
    td.demo_lucas_kanade(*files, lib / "lk.png", **f32)
    _same_image(tmp_path / "lk/cli_lk_tracks.png", lib / "lk.png")
    with pytest.raises(SystemExit):
        td.main(["xx", *files, "p"])


def test_size_mismatch_raises(tmp_path):
    prev, nxt = _pair(rgb=False)
    write_pnm(tmp_path / "a.pgm", prev)
    write_pnm(tmp_path / "b.pgm", nxt[:-1])
    for mod in (td, jd):
        with pytest.raises(ValueError, match="Image sizes are different"):
            mod.demo_horn_schunck(tmp_path / "a.pgm", tmp_path / "b.pgm",
                                  f"{tmp_path}/x_", **(
                                      F64 if mod is td else {}))
