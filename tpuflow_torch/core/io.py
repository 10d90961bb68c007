"""Image and flow-field I/O, on the host in NumPy (port of
:mod:`tpuflow.core.io`).

Re-implements the behavioral I/O contract of the reference (SURVEY.md §2.5):

- PNM: PGM/PPM binary (P5/P6) and ASCII (P2/P3) read/write — the missing
  ``pnm_lib_cpp`` submodule's surface used throughout
  ``Scratch_MeaningfulMotion.cpp`` (read at :124-209) and the debug dumps
  (``Pyramid_%04d.pgm`` MultiResolution.cpp:86-94, ``filtered.pgm``
  Detection.cpp:67-79, ``IndexMap.pgm`` Exclusive.cpp:28-31).
- PNG and other formats: via PIL, imported at first use, for the
  KITTI-style corpus and OpenCV-demo parity (``HornSchunckOF/main.cpp:50-51``).
- Flow field: text header ``"%d %d\n"`` (width height) followed by row-major
  little-endian float64 (x, y) pairs — ``OpticalFlow/OpticalFlow.cpp:400-417``.
  The HOG-match variant appends a third ``score`` double per pixel
  (``HOG/HOG_match.cpp:92-116``).
- Affine parameters: 6 lines of ``%0.16e`` text
  (``OpticalFlow/Affine_MultipleMotion.cpp:243-270``).
- HS demo matrices: plain-text u/v matrices equivalent to OpenCV FileStorage
  dumps (``HornSchunckOF/main.cpp:99-102``) — written as .npy + .txt.
- printf-pattern filename expansion (``%0Nd`` frame numbering,
  ``Scratch_MeaningfulMotion.cpp:84-122``).

Binary PNM reads go through the native C++ codec
(:mod:`tpuflow_torch.native`), with no fallback: :func:`read_pnm` is its
plain version.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# PNM


def read_pnm(path: str | Path) -> tuple[np.ndarray, int]:
    """Read P2/P3/P5/P6. Returns (array, maxval).

    Gray -> (H, W); RGB -> (H, W, 3). dtype uint8 or uint16.
    """
    data = Path(path).read_bytes()
    if not data[:1] == b"P":
        raise ValueError(f"{path}: not a PNM file")
    magic = data[:2].decode("ascii")
    if magic not in ("P2", "P3", "P5", "P6"):
        raise ValueError(f"{path}: unsupported PNM magic {magic}")

    # Tokenize header, skipping comments.
    pos = 2
    tokens: list[int] = []
    while len(tokens) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    width, height, maxval = tokens
    channels = 3 if magic in ("P3", "P6") else 1
    count = width * height * channels

    if magic in ("P5", "P6"):
        pos += 1  # single whitespace after maxval
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
        arr = arr.astype(np.uint16 if maxval > 255 else np.uint8)
    else:
        vals = data[pos:].split()
        arr = np.array([int(v) for v in vals[:count]],
                       dtype=np.uint16 if maxval > 255 else np.uint8)
    if channels == 3:
        arr = arr.reshape(height, width, 3)
    else:
        arr = arr.reshape(height, width)
    return arr, maxval


def write_pnm(path: str | Path, img: np.ndarray, maxval: int = 255,
              binary: bool = True, scale: float = 1.0) -> None:
    """Write PGM/PPM. (H, W) -> P5/P2, (H, W, 3) -> P6/P3.

    ``scale`` mirrors pnm's ``copy(desc, W, H, maxint, data, scale)`` — float
    data is multiplied by scale then clipped to [0, maxval] (the pyramid dump
    uses scale=256, ``MultiResolution.cpp:89``).
    """
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.floating):
        img = np.clip(img * scale, 0, maxval).astype(
            np.uint16 if maxval > 255 else np.uint8)
    else:
        img = np.clip(img, 0, maxval).astype(
            np.uint16 if maxval > 255 else np.uint8)
    rgb = img.ndim == 3
    h, w = img.shape[:2]
    magic = ("P6" if rgb else "P5") if binary else ("P3" if rgb else "P2")
    header = f"{magic}\n{w} {h}\n{maxval}\n".encode("ascii")
    path = Path(path)
    if binary:
        body = img.astype(">u2" if maxval > 255 else "u1").tobytes()
        path.write_bytes(header + body)
    else:
        flat = img.reshape(-1)
        lines = []
        for i in range(0, flat.size, 16):
            lines.append(" ".join(str(int(v)) for v in flat[i : i + 16]))
        path.write_bytes(header + ("\n".join(lines) + "\n").encode("ascii"))


# ---------------------------------------------------------------------------
# Generic image read (PNG/PNM/...)


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing this image format needs PIL "
                          "(Pillow); PNM (.pgm/.ppm/.pnm) needs nothing"
                          ) from e
    return Image


def read_image(path: str | Path) -> tuple[np.ndarray, int]:
    """Read PNG/PNM/JPEG... -> (array, maxval). Gray (H,W) or RGB (H,W,3).

    Binary PNM goes through the native C++ codec (:mod:`tpuflow_torch.native`,
    float64 values); ASCII PNM through :func:`read_pnm`, other formats
    through PIL."""
    path = Path(path)
    if path.suffix.lower() in (".pgm", ".ppm", ".pnm"):
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic in (b"P5", b"P6"):
            from tpuflow_torch import native

            return native.read_pnm(path)
        return read_pnm(path)
    Image = _pil()
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im, dtype=np.uint16)
            return arr, 65535
        if im.mode not in ("L", "RGB"):
            im = im.convert("RGB" if ("A" in im.mode or im.mode == "P") else "L")
        arr = np.asarray(im)
        if arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[..., :3]
        return arr, 255


def write_image(path: str | Path, img: np.ndarray, maxval: int = 255) -> None:
    path = Path(path)
    if path.suffix.lower() in (".pgm", ".ppm", ".pnm"):
        write_pnm(path, img, maxval=maxval)
        return
    Image = _pil()

    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.floating):
        img = np.clip(img, 0, maxval)
        img = (img * (255.0 / maxval)).astype(np.uint8)
    Image.fromarray(img).save(path)


# ---------------------------------------------------------------------------
# Flow-field binary format


def write_flow(path: str | Path, u: np.ndarray, v: np.ndarray,
               score: np.ndarray | None = None) -> None:
    """Reference flow format: b"W H\n" + row-major little-endian f64 pairs.

    With ``score`` a third double per pixel is written (HOG-match variant).
    """
    u = np.asarray(u, dtype="<f8")
    v = np.asarray(v, dtype="<f8")
    h, w = u.shape
    comps = [u, v] if score is None else [u, v, np.asarray(score, dtype="<f8")]
    inter = np.stack(comps, axis=-1)  # (H, W, 2|3) -> interleaved per pixel
    with open(path, "wb") as f:
        f.write(f"{w} {h}\n".encode("ascii"))
        f.write(inter.astype("<f8").tobytes())


def read_flow(path: str | Path, components: int = 2) -> tuple[np.ndarray, ...]:
    data = Path(path).read_bytes()
    nl = data.index(b"\n")
    w, h = (int(t) for t in data[:nl].split())
    arr = np.frombuffer(data, dtype="<f8", offset=nl + 1,
                        count=w * h * components)
    arr = arr.reshape(h, w, components)
    return tuple(arr[..., i].copy() for i in range(components))


# ---------------------------------------------------------------------------
# Affine parameter text format


def write_affine(path: str | Path, a: np.ndarray) -> None:
    """6 lines of '%0.16e ' (Affine_MultipleMotion.cpp:243-270)."""
    with open(path, "w") as f:
        for v in np.asarray(a, dtype=np.float64).reshape(-1):
            f.write(f"{v:0.16e} \n")


def read_affine(path: str | Path) -> np.ndarray:
    vals = [float(line.split()[0]) for line in Path(path).read_text().split("\n")
            if line.strip()]
    return np.array(vals, dtype=np.float64)


# ---------------------------------------------------------------------------
# HOG binary format


def write_hog(path: str | Path, hog: np.ndarray, signed: bool) -> None:
    """HOG file: b"signed\\nW H\\nbins\\n" + row-major doubles per
    (y, x, bin) (HOG_write, HOG/HOG.cpp:295-332)."""
    hog = np.asarray(hog, dtype="<f8")
    h, w, bins = hog.shape
    with open(path, "wb") as f:
        f.write(f"{int(signed)}\n{w} {h}\n{bins}\n".encode("ascii"))
        f.write(hog.tobytes())


def read_hog(path: str | Path) -> tuple[np.ndarray, bool]:
    data = Path(path).read_bytes()
    p1 = data.index(b"\n")
    p2 = data.index(b"\n", p1 + 1)
    p3 = data.index(b"\n", p2 + 1)
    signed = bool(int(data[:p1]))
    w, h = (int(t) for t in data[p1 + 1 : p2].split())
    bins = int(data[p2 + 1 : p3])
    arr = np.frombuffer(data, dtype="<f8", offset=p3 + 1,
                        count=w * h * bins).reshape(h, w, bins)
    return arr.copy(), signed


# ---------------------------------------------------------------------------
# Matrix text dump (HS demo FileStorage-equivalent)


def write_matrix_txt(path: str | Path, m: np.ndarray,
                     name: str = "m") -> None:
    """cv::FileStorage-compatible YAML matrix dump.

    The reference demos dump u/v with ``cv::FileStorage(path, WRITE) <<
    "u matrix" << u`` (HornSchunckOF/main.cpp:99-102), which writes a
    YAML document with an ``!!opencv-matrix`` node even under a ``.txt``
    name. This emits the same structure — ``cv2.FileStorage`` (and any
    OpenCV-based downstream tool) reads the dumps back bitwise. Values use
    shortest round-trip formatting, so the f64 payload is exact."""
    m = np.asarray(m, dtype=np.float64)

    def _fmt(v: float) -> str:
        # cv::FileStorage writes non-finite doubles as '.Inf'/'-.Inf'/
        # '.Nan'; Python's 'inf'/'nan' would break the advertised
        # cv2.FileStorage round-trip.
        if v != v:
            return ".Nan"
        if v == np.inf:
            return ".Inf"
        if v == -np.inf:
            return "-.Inf"
        return repr(v)

    vals = [_fmt(float(v)) for v in m.reshape(-1)]
    lines = [f"%YAML 1.2\n---\n{name}: !!opencv-matrix\n",
             f"   rows: {m.shape[0]}\n",
             f"   cols: {m.shape[1]}\n",
             "   dt: d\n",
             "   data: [ "]
    # Wrap the flow list the way OpenCV does (continuation lines
    # indented under "data:"); any wrapping parses identically.
    col = len(lines[-1])
    out = lines
    for i, s in enumerate(vals):
        tok = s + (", " if i + 1 < len(vals) else " ]\n")
        if col + len(tok) > 96:
            out.append("\n       ")
            col = 7
        out.append(tok)
        col += len(tok)
    with open(path, "w") as f:
        f.write("".join(out))


# ---------------------------------------------------------------------------
# printf-pattern frame filenames


_PATTERN = re.compile(r"%(0?)(\d*)d")


def expand_frame_pattern(pattern: str, num: int) -> str:
    """Expand one printf-style %0Nd in a filename
    (Scratch_MeaningfulMotion.cpp:84-122). No pattern -> unchanged."""

    def sub(m: re.Match) -> str:
        zero, width = m.group(1), m.group(2)
        if width:
            return f"{num:{zero or ''}{width}d}"
        return str(num)

    return _PATTERN.sub(sub, pattern, count=1)
