"""The region matcher's moment sums (``tpuflow_torch.kernels.bm_cost``).

On the CPU: the wrapper takes the plain version (``bm_cost._matmul_sums``,
the strip loop) and launches nothing; every matmul method's cost tables
are bitwise what the matcher gave before the sums moved behind the
wrapper (a frozen copy of that ``_matmul_costs`` below); bad input
raises; the kernel's plan (:func:`bm_cost.segment_plan`) covers every
region's pixels, and a model of the kernel's segments and their combine,
at a few pixels a segment, gives the plain sums within 1e-12; the module
imports nothing of the matcher above it.

On the card only (the kernel has no CPU form; the ``cuda`` fixture skips
here): for each matmul method on small Voronoi frames, the kernel's sums
against the plain version's on the card within rtol 1e-12 (float64 sums
of the same float32 fields in two orders), the costs within the matcher
tests' COST_RTOL / COST_ATOL, winners and time directions equal; two runs,
a slice of the candidates and one reference of two bitwise the whole
call's; a region larger than a segment. Run them on the card with
``python -m pytest --noconftest tests/test_torch_bm_cost.py -q`` (this
file imports no JAX; tests/conftest.py does).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import voronoi_frames
from tpuflow_torch.blockmatching import matcher
from tpuflow_torch.kernels import bm_cost
from tpuflow_torch.solvers import bm_flow

MATMUL = ("matmul", "matmul_bf16", "matmul_coarse", "matmul_coarse3",
          "matmul_half", "matmul_half2")
COST_RTOL, COST_ATOL = 1e-10, 1e-12
SUM_RTOL = 1e-12
SEARCH = 7
CHUNK = 64
SHAPE = (40, 56)
CARD_SHAPE = (64, 96)
CARD_SEARCH = 15


def _scene(shape):
    """Three Lab frames (float32, the flagship's host conversion) of a
    Voronoi pan, and the middle frame's cells as labels 0..n-1."""
    frames, cells = voronoi_frames(shape)
    labs = [bm_flow._to_lab(f, 255.0)[1] for f in frames]
    uniq, labels = np.unique(cells, return_inverse=True)
    return labs, labels.reshape(cells.shape).astype(np.int32), len(uniq)


@pytest.fixture(scope="module")
def scene():
    return _scene(SHAPE)


def _cand(method, search, dev="cpu"):
    return torch.as_tensor(matcher.padded_candidates(
        matcher.method_candidates(method, search), CHUNK), device=dev)


def _matmul_costs_before(cur_lab, refs, plan, cand, coeff_mad, coeff_zncc,
                         chunk, radius, bf16=False):
    """``matcher._matmul_costs`` as it was before its sums moved behind
    ``bm_cost.region_sums`` (frozen; it takes the plan's host labels)."""
    labels, n_regions = plan.host_labels, plan.n_regions
    dev = cur_lab.device
    h, w, c = cur_lab.shape
    R = radius
    n_ref = len(refs)
    refs_p = [torch.nn.functional.pad(r, (0, 0, R, R, R, R)) for r in refs]
    n_cand = cand.shape[0]
    acc_var = torch.zeros((n_regions, 4 * n_ref, n_cand), dtype=matcher.ACC,
                          device=dev)
    acc_fix = torch.zeros((n_regions, 3), dtype=matcher.ACC, device=dev)
    strips = bm_cost._strip_plan(labels, dev)
    for y0, rows, present, local, n_p in strips:
        L = torch.nn.functional.one_hot(local, n_p).to(matcher.ACC)
        cur_s = cur_lab[y0 : y0 + rows].reshape(rows * w, 1, c)
        a = cur_s[:, 0, 0]
        fix = torch.stack([torch.ones_like(a), a, a * a], dim=-1)
        acc_fix[present] += L.t() @ fix.to(matcher.ACC)
        for k0 in range(0, n_cand, chunk):
            d = cand[k0 : k0 + chunk]
            fields = []
            for ref_p in refs_p:
                sub = bm_cost._shifted(ref_p, R, y0, rows, d)
                b = sub[..., 0]
                fields += [bm_cost._l1(cur_s, sub), b, b * b,
                           cur_s[..., 0] * b]
            F = torch.stack(fields, dim=1).reshape(rows * w, -1)
            if bf16:
                F = F.to(torch.bfloat16)
            F = F.to(matcher.ACC)
            acc_var[present, :, k0 : k0 + d.shape[0]] += (L.t() @ F).view(
                n_p, 4 * n_ref, d.shape[0])
    var = acc_var.permute(2, 0, 1)
    out = []
    for off in range(0, 4 * n_ref, 4):
        mad, zncc, _ = matcher._cost_core(acc_fix[:, 0], var[..., off],
                                          acc_fix[:, 1], var[..., off + 1],
                                          acc_fix[:, 2], var[..., off + 2],
                                          var[..., off + 3])
        out.append(coeff_mad * mad - coeff_zncc * zncc)
    return out


def _method_costs(method, labs, labels, n, search, cand, n_ref=2):
    refs = [labs[0], labs[2]][:n_ref]
    plan = matcher.region_plan(labels, n, labs[1].device)
    return matcher.method_costs(method, labs[1], refs, plan, cand, search,
                                1.0, 0.5, CHUNK)


def _spy_args(monkeypatch, method, labs, labels, n, search, cand):
    """The arguments ``method_costs`` hands ``bm_cost.region_sums``."""
    seen = []
    real = bm_cost.region_sums

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(bm_cost, "region_sums", spy)
    _method_costs(method, labs, labels, n, search, cand)
    monkeypatch.setattr(bm_cost, "region_sums", real)
    return seen[0]


def _seg(labels, n, dev="cpu"):
    return bm_cost.segment_plan(torch.from_numpy(labels).to(dev), n)


def _plain(args):
    """The plain version on ``region_sums``'s arguments (it takes the
    host labels, not their segment plan)."""
    cur, refs, labels, _, *rest = args
    return bm_cost._matmul_sums(cur, refs, labels, *rest)


# ---------------------------------------------------------------- CPU ---


@pytest.mark.parametrize("n_ref", [1, 2])
def test_cpu_takes_plain_version(scene, n_ref):
    labs, labels, n = scene
    cand = _cand("matmul", SEARCH)
    refs = [labs[0], labs[2]][:n_ref]
    before = bm_cost.LAUNCHES
    got = bm_cost.region_sums(labs[1], refs, labels, _seg(labels, n), n,
                              cand, CHUNK, SEARCH // 2)
    want = bm_cost._matmul_sums(labs[1], refs, labels, n, cand, CHUNK,
                                SEARCH // 2)
    assert bm_cost.LAUNCHES == before
    assert got[0].shape == (n, 4 * n_ref, len(cand))
    assert got[1].shape == (n, 3)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and torch.equal(a, b)


@pytest.mark.parametrize("method", MATMUL)
def test_plain_tables_unchanged(scene, monkeypatch, method):
    labs, labels, n = scene
    cand = _cand(method, SEARCH)
    got = _method_costs(method, labs, labels, n, SEARCH, cand)
    monkeypatch.setattr(matcher, "_matmul_costs", _matmul_costs_before)
    want = _method_costs(method, labs, labels, n, SEARCH, cand)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().nan_to_num().max())


class _CudaFrame:
    """Stands in for a CUDA tensor (there is no card here): what the
    wrapper's checks read, nothing to launch on."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def _bad_inputs(case, labs, labels, n):
    cur, refs = labs[1], [labs[0], labs[2]]
    cand = _cand("matmul", SEARCH)
    seg = _seg(labels, n)
    hw = tuple(cur.shape[:2])
    if case == "cur_shape":
        return cur[..., :2], [r[..., :2] for r in refs], labels, seg, n, cand
    if case == "ref_shape":
        return cur, [refs[0][1:]], labels, seg, n, cand
    if case == "no_ref":
        return cur, [], labels, seg, n, cand
    if case == "labels_shape":
        return cur, refs, labels[1:], seg, n, cand
    if case == "cand_shape":
        return cur, refs, labels, seg, n, cand[:, :1]
    if case == "device":
        meta = [x.to("meta") for x in (cur, *refs)]
        return meta[0], meta[1:], labels, seg, n, cand.to("meta")
    cuda = [_CudaFrame((*hw, 3)) for _ in range(3)]
    cand_cuda = _CudaFrame((len(cand), 2), torch.int64)
    if case == "cuda_float64":
        return _CudaFrame((*hw, 3), torch.float64), cuda[1:], labels, seg, \
            n, cand_cuda
    if case == "cuda_int32_cand":
        return cuda[0], cuda[1:], labels, seg, n, _CudaFrame((len(cand), 2),
                                                            torch.int32)
    if case == "cuda_three_refs":
        return cuda[0], cuda, labels, seg, n, cand_cuda
    if case == "cuda_cand_on_cpu":
        return cuda[0], cuda[1:], labels, seg, n, cand
    if case == "cuda_labels_range":
        return cuda[0], cuda[1:], labels, seg, int(labels.max()), cand_cuda
    if case == "cuda_plan_on_cpu":  # the kernel would read host pointers
        return cuda[0], cuda[1:], labels, seg, n, cand_cuda
    raise AssertionError(case)


@pytest.mark.parametrize("case,error", [
    ("cur_shape", ValueError), ("ref_shape", ValueError),
    ("no_ref", ValueError), ("labels_shape", ValueError),
    ("cand_shape", ValueError), ("device", ValueError),
    ("cuda_float64", TypeError), ("cuda_int32_cand", TypeError),
    ("cuda_three_refs", ValueError), ("cuda_cand_on_cpu", ValueError),
    ("cuda_labels_range", ValueError), ("cuda_plan_on_cpu", ValueError)])
def test_raises_on_bad_input(scene, case, error):
    labs, labels, n = scene
    before = bm_cost.LAUNCHES
    with pytest.raises(error, match="region_sums"):
        bm_cost.region_sums(*_bad_inputs(case, labs, labels, n), CHUNK,
                            SEARCH // 2)
    assert bm_cost.LAUNCHES == before


def test_kernel_layer_imports_no_matcher():
    """kernels/bm_cost.py sits below the matcher: no import of it, or of
    anything under ``tpuflow_torch.blockmatching``, anywhere in the
    module (a function's own imports included)."""
    tree = ast.parse(Path(bm_cost.__file__).read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [f"{node.module}.{a.name}" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) for a in node.names]
    assert "tpuflow_torch.kernels._build" in names  # the walk sees imports
    assert [m for m in names
            if m.startswith("tpuflow_torch.blockmatching")] == []


def _label_maps():
    rng = np.random.default_rng(5)
    strays = (np.arange(30)[:, None] // 6 * 7
              + np.arange(44)[None, :] // 7).astype(np.int32)
    strays[rng.uniform(size=strays.shape) < 0.1] = 3
    one = np.zeros((30, 44), np.int32)
    gaps = strays.copy()
    gaps[gaps == 5] = 9  # regions 5 and the last stay empty
    return {"strays": (strays, int(strays.max()) + 1),
            "one_region": (one, 1), "empty_regions": (gaps,
                                                      int(gaps.max()) + 2)}


@pytest.mark.parametrize("maps", ["strays", "one_region", "empty_regions"])
@pytest.mark.parametrize("segment", [7, 1024])
def test_segment_plan_covers_regions(monkeypatch, maps, segment):
    monkeypatch.setattr(bm_cost, "SEGMENT", segment)
    labels, n = _label_maps()[maps]
    perm, bounds, seg_end = bm_cost.segment_plan(torch.from_numpy(labels), n)
    want_perm, want_bounds = matcher.region_reduction_plan(labels, n)
    assert torch.equal(perm, torch.from_numpy(want_perm))
    assert torch.equal(bounds, torch.from_numpy(want_bounds))
    counts = np.diff(want_bounds)
    parts = np.maximum(-(-counts // segment), 1)
    assert seg_end.tolist() == np.cumsum(parts).tolist()
    # Every segment fits a launch's block rows, every later segment a
    # scratch row.
    assert int(seg_end[-1]) <= bm_cost.slots(n, labels.size)
    assert int(seg_end[-1]) - n <= labels.size // segment


def _fields(cur, refs, cand, radius, bf16):
    """(N, 4 n_ref, n_cand) float64: each pixel's fields for every
    candidate, computed in float32 as the plain version computes them."""
    h, w, c = cur.shape
    cur_s = cur.reshape(h * w, 1, c)
    out = []
    for ref in refs:
        ref_p = torch.nn.functional.pad(ref, (0, 0, radius, radius, radius,
                                              radius))
        sub = bm_cost._shifted(ref_p, radius, 0, h, cand)
        b = sub[..., 0]
        out += [bm_cost._l1(cur_s, sub), b, b * b, cur_s[..., 0] * b]
    f = torch.stack(out, dim=1)
    if bf16:
        f = f.to(torch.bfloat16)
    return f.to(torch.float64)


def _kernel_model(cur, refs, labels, n, cand, radius, bf16):
    """csrc/bm_cost.cu's blocks and combine, written out: each slot's
    region and segment, its sums to ``out`` or to scratch row slot - r - 1,
    then the later segments added in order."""
    perm, bounds, seg_end = bm_cost.segment_plan(torch.from_numpy(labels), n)
    fields = _fields(cur, refs, cand, radius, bf16)
    a = cur[..., 0].reshape(-1)
    fix_fields = torch.stack([torch.ones_like(a), a, a * a], -1).double()
    n_slots = bm_cost.slots(n, labels.size)
    rows = max(n_slots - n, 1)
    nan = float("nan")
    out = torch.full((n, *fields.shape[1:]), nan, dtype=torch.float64)
    fix = torch.full((n, 3), nan, dtype=torch.float64)
    scratch = torch.full((rows, *fields.shape[1:]), nan, dtype=torch.float64)
    fix_scratch = torch.full((rows, 3), nan, dtype=torch.float64)
    ends = seg_end.tolist()
    for slot in range(n_slots):
        r = int(np.searchsorted(ends, slot, side="right"))
        if r == n:
            continue
        part = slot - (ends[r - 1] if r else 0)
        start = int(bounds[r]) + part * bm_cost.SEGMENT
        end = min(start + bm_cost.SEGMENT, int(bounds[r + 1]))
        px = perm[start:end]
        dst, fdst, row = ((out, fix, r) if part == 0
                          else (scratch, fix_scratch, slot - r - 1))
        dst[row] = fields[px].sum(0)
        fdst[row] = fix_fields[px].sum(0)
    for r in range(n):
        first = ends[r - 1] if r else 0
        for k in range(1, ends[r] - first):
            out[r] += scratch[first - r + k - 1]
            fix[r] += fix_scratch[first - r + k - 1]
    return out, fix


@pytest.mark.parametrize("method", ["matmul", "matmul_bf16", "matmul_half"])
@pytest.mark.parametrize("segment", [5, 64])
def test_segment_model_matches_plain(scene, monkeypatch, method, segment):
    labs, labels, n = scene
    cand = _cand(method, SEARCH)
    args = _spy_args(monkeypatch, method, labs, labels, n, SEARCH, cand)
    cur, refs, lab, _, n_r, cand_r, chunk, radius, bf16 = args
    monkeypatch.setattr(bm_cost, "SEGMENT", segment)
    got = _kernel_model(cur, refs, np.ascontiguousarray(lab), n_r, cand_r,
                        radius, bf16)
    want = _plain(args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=0)


# ---------------------------------------------------------- the card ---


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bm_cost kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_scene(cuda):
    labs, labels, n = _scene(CARD_SHAPE)
    return [x.to(cuda) for x in labs], labels, n


def _plain_on_card(monkeypatch):
    """Route the matcher's sums to the plain version on the card."""
    monkeypatch.setattr(bm_cost, "region_sums", lambda *args: _plain(args))


@pytest.mark.parametrize("method", MATMUL)
def test_kernel_matches_plain_on_card(card_scene, monkeypatch, method):
    labs, labels, n = card_scene
    cand = _cand(method, CARD_SEARCH, labs[1].device)
    args = _spy_args(monkeypatch, method, labs, labels, n, CARD_SEARCH, cand)
    before = bm_cost.LAUNCHES
    got = bm_cost.region_sums(*args)
    assert bm_cost.LAUNCHES == before + 2
    want = _plain(args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=0)
    costs = _method_costs(method, labs, labels, n, CARD_SEARCH, cand)
    res = matcher.block_matching_bidirectional(
        labs[1], labs[0], labs[2], labels, n, search_range=CARD_SEARCH,
        method=method)
    _plain_on_card(monkeypatch)
    costs_plain = _method_costs(method, labs, labels, n, CARD_SEARCH, cand)
    res_plain = matcher.block_matching_bidirectional(
        labs[1], labs[0], labs[2], labels, n, search_range=CARD_SEARCH,
        method=method)
    real = len(matcher.method_candidates(method, CARD_SEARCH))
    for a, b in zip(costs, costs_plain):
        torch.testing.assert_close(a, b, rtol=COST_RTOL, atol=COST_ATOL)
        assert torch.equal(torch.argmin(a[:real], 0),
                           torch.argmin(b[:real], 0))
    for a, b in zip(res[:2], res_plain[:2]):
        np.testing.assert_array_equal(a.region_uv, b.region_uv)
    np.testing.assert_array_equal(res[2], res_plain[2])


@pytest.mark.parametrize("method", MATMUL)
def test_kernel_bitwise_repeat_slice_one_ref(card_scene, monkeypatch,
                                             method):
    labs, labels, n = card_scene
    cand = _cand(method, CARD_SEARCH, labs[1].device)
    args = _spy_args(monkeypatch, method, labs, labels, n, CARD_SEARCH, cand)
    cur, refs, lab, seg, n_r, cand_r, chunk, radius, bf16 = args
    first = bm_cost.region_sums(*args)
    again = bm_cost.region_sums(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # A mesh rank's slice of the padded list (dist/bm.py), and the other
    # reference alone.
    half = len(cand_r) // 2
    part = bm_cost.region_sums(cur, refs, lab, seg, n_r, cand_r[half:],
                               chunk, radius, bf16)
    assert torch.equal(part[0], first[0][:, :, half:])
    assert torch.equal(part[1], first[1])
    for k in range(2):
        one = bm_cost.region_sums(cur, refs[k : k + 1], lab, seg, n_r,
                                  cand_r, chunk, radius, bf16)
        assert torch.equal(one[0], first[0][:, 4 * k : 4 * k + 4])
        assert torch.equal(one[1], first[1])


def test_kernel_region_larger_than_segment(card_scene):
    labs, labels, n = card_scene
    big = labels.copy()
    big[:, : CARD_SHAPE[1] // 2] = 0  # one region of ~3,000 px: 3 segments
    _, big = np.unique(big, return_inverse=True)
    big = big.reshape(labels.shape).astype(np.int32)
    n_big = int(big.max()) + 1
    assert np.bincount(big.ravel()).max() > 2 * bm_cost.SEGMENT
    cand = _cand("matmul", CARD_SEARCH, labs[1].device)
    args = (labs[1], [labs[0], labs[2]], big,
            _seg(big, n_big, labs[1].device), n_big, cand, CHUNK,
            CARD_SEARCH // 2, False)
    got = bm_cost.region_sums(*args)
    want = _plain(args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=0)
