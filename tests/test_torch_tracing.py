"""The port's tracer (``tpuflow_torch.utils.telemetry``) on the CPU: spans
only while a profiler records, on the clock of its exported trace, and the
spans of the flagship and of Black-Anandan, which leave every output
bitwise as it was."""

import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import voronoi_frames
from tpuflow_torch.blockmatching import matcher
from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.kernels import bm_cost
from tpuflow_torch.solvers import bm_flow
from tpuflow_torch.solvers.black_anandan_fast import optical_flow_pyramid_fast
from tpuflow_torch.utils import telemetry
from tpuflow_torch.utils.numerics import warm_cpu_sqrt

warm_cpu_sqrt()

# tests/test_torch_bm_flow.py's flagship crop and tests/test_torch_black_
# anandan.py's pyramid pair.
FLAGSHIP_KW = dict(search_range=7, kernel_spatial=8, iter_max=130)
BA_LEVEL, BA_ITERS, BA_FUSE = 2, 8, 4


def _recorded(fn):
    """``fn()`` under a CPU profiler; returns (result, the spans)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, telemetry.spans()


@pytest.fixture(scope="module")
def three_frames():
    frames, _ = voronoi_frames((40, 56), cells_per_px=150 / (56 * 72),
                               pan=(1, 2), shade=1.875, seed=1)
    return frames


def _flagship(frames, blocks):
    out1, state = bm_flow.optical_flow_block_matching(
        frames[0], frames[1], device="cpu", blocks=blocks, **FLAGSHIP_KW)
    out2, _ = bm_flow.optical_flow_block_matching(
        frames[1], frames[2], state=state, device="cpu", blocks=blocks,
        **FLAGSHIP_KW)
    return out1, out2


@pytest.fixture(scope="module")
def flagship_runs(three_frames):
    """Both pairs with recording off, then on: (outputs, blocks) each, and
    the recorded spans."""
    plain_blocks, traced_blocks = [], []
    plain = _flagship(three_frames, plain_blocks)
    traced, spans = _recorded(lambda: _flagship(three_frames, traced_blocks))
    return (plain, plain_blocks), (traced, traced_blocks), spans


@pytest.fixture(scope="module")
def ba_pair():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (72, 88)), 2.0)
    return (torch.from_numpy(base[:64, :80].copy()),
            torch.from_numpy(base[4:68, 2:82].copy()))


def _ba(pair, blocks):
    return optical_flow_pyramid_fast(
        *pair, 255.0, MultipleMotionParam(level=BA_LEVEL),
        iter_max=BA_ITERS, fuse=BA_FUSE, blocks=blocks)


@pytest.fixture(autouse=True)
def _window_ended():
    """A read with no profiler recording ends the last window: each test's
    profiler starts a list of its own."""
    telemetry.spans()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def test_nothing_recorded_without_a_profiler(monkeypatch, ba_pair):
    monkeypatch.setattr(telemetry, "_window", telemetry._Window())
    with telemetry.record_span("stage", device="cpu", k=1):
        telemetry.note(count=3)
    _ba(ba_pair, [])
    assert telemetry.spans() == [] and telemetry.dropped() == 0
    assert telemetry.chrome_events() == []


def test_span_holds_the_profilers_op_on_its_clock(tmp_path):
    a = torch.randn(48, 48)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.record_span("outer", k=1):
            with telemetry.record_span("inner"):
                a @ a
                telemetry.note(count=2)
                telemetry.note(count=3, tag="x")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    mm = [e for e in trace["traceEvents"]
          if e.get("ph") == "X" and e["name"] == "aten::mm"]
    assert len(mm) == 1
    start_us = mm[0]["ts"] + base_us
    end_us = start_us + mm[0]["dur"]
    outer, got_inner = telemetry.spans()
    for s in (outer, got_inner):
        assert s.start_ns / 1e3 <= start_us and end_us <= s.end_ns / 1e3
    assert (outer.parent, got_inner.parent) == (None, outer.index)
    assert outer.frame == got_inner.frame
    assert outer.fields == {"k": 1}
    assert got_inner.fields == {"count": 5, "tag": "x"}
    assert got_inner.device_ms is None  # no device time on the CPU

    # The spans appended to the export: still a chrome trace, each span
    # an "X" event on the trace's own time base around the op.
    trace["traceEvents"] += telemetry.chrome_events(
        trace["baseTimeNanoseconds"])
    path.write_text(json.dumps(trace))
    again = json.loads(path.read_text())
    ours = [e for e in again["traceEvents"]
            if e.get("cat") == "tpuflow_span"]
    assert [e["name"] for e in ours] == ["outer", "inner"]
    for e in ours:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["ts"] <= mm[0]["ts"]
        assert mm[0]["ts"] + mm[0]["dur"] <= e["ts"] + e["dur"]
    assert ours[1]["args"] == {"count": 5, "tag": "x", "frame": 0,
                               "parent": 0}


def test_a_new_window_resets_the_list_and_drops_past_the_bound(monkeypatch):
    def one(name):
        with telemetry.record_span(name):
            pass

    _recorded(lambda: one("first"))
    one("between")  # no profiler: the next window starts a new list
    monkeypatch.setattr(telemetry, "MAX_SPANS", 2)
    _, spans = _recorded(lambda: [one(name) for name in "xyz"])
    assert [s.name for s in spans] == ["x", "y"]
    assert telemetry.dropped() == 1
    assert [s.frame for s in spans] == [0, 1]


def test_recorded_spans_leave_no_collectable_objects():
    """A window's spans add numbers to lists, not objects: a long window
    must not drive the garbage collector (a per-span object made traced
    frames collect tens of ms of garbage each)."""
    import gc

    def many():
        for _ in range(3000):
            with telemetry.record_span("wait.x", count=2):
                pass
            with telemetry.record_span("wait.y"):
                pass

    _recorded(many)  # the first window's lists grow to their size
    gc.collect()
    before = len(gc.get_objects())
    _, spans = _recorded(many)
    del spans
    gc.collect()
    # each "wait.x" keeps its one fields dict, untracked: it holds ints
    assert len(gc.get_objects()) - before < 100


def test_done_event_keeps_its_fields_while_recording(monkeypatch):
    stream = io.StringIO()
    monkeypatch.setattr(telemetry, "_GLOBAL", telemetry.Telemetry(stream))
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.trace_span("stage", device="cpu", frame=3):
            telemetry.note(count=1)
    rec = json.loads(stream.getvalue())
    assert rec["wall_s"] >= 0
    assert {k: v for k, v in rec.items() if k not in ("ts", "wall_s")} == {
        "event": "stage.done", "frame": 3}
    span, = telemetry.spans()
    assert span.frame == 3 and span.fields == {"frame": 3, "count": 1}


@pytest.mark.parametrize("recording", [False, True])
def test_program_spans_emit_nothing_to_a_sink(monkeypatch, ba_pair,
                                              three_frames, recording):
    """The flagship's and BA's spans record only under a profiler: a sink
    installed sees BA's energy events and the flagship's nothing, with a
    profiler recording or not; a trace_span beside them emits its .done."""
    stream = io.StringIO()
    monkeypatch.setattr(telemetry, "_GLOBAL", telemetry.Telemetry(stream))

    def run():
        _ba(ba_pair, [])
        _flagship(three_frames, [])
        with telemetry.trace_span("stage"):
            pass

    if recording:
        _recorded(run)
    else:
        run()
    events = {json.loads(line)["event"]
              for line in stream.getvalue().splitlines()}
    assert events == {"irls.energy", "stage.done"}


def test_flagship_outputs_bitwise_with_recording(flagship_runs):
    (plain, plain_blocks), (traced, traced_blocks), _ = flagship_runs
    assert plain_blocks == traced_blocks
    for got, want in zip(traced, plain):
        for name in ("u", "v", "t", "bm_u", "bm_v", "quantized_rgb",
                     "shift_vector"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        np.testing.assert_array_equal(got.segmentation.labels,
                                      want.segmentation.labels)
        assert got.bidirectional == want.bidirectional


FRAME_STAGES = {
    # first pair: both frames segmented, one direction searched
    False: ["bm.lab", "bm.segment", "bm.label", "bm.lab", "bm.segment",
            "bm.label", "bm.search", "bm.refine", "bm.compose",
            "bm.side_outputs"],
    # a middle frame: the new frame's filter queued, then the search
    True: ["bm.lab", "bm.segment", "bm.search", "bm.label", "bm.refine",
           "bm.compose", "bm.side_outputs"],
}


def test_flagship_spans_nest_as_the_frame_runs(flagship_runs):
    (_, _), (traced, blocks), spans = flagship_runs
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in tops] == ["bm.frame", "bm.fetch"] * 2
    for k, (frame, fetch, out) in enumerate(zip(tops[::2], tops[1::2],
                                                 traced)):
        bidir = out.bidirectional
        assert frame.fields == {"bidirectional": bidir}
        assert fetch.frame == frame.frame + 1  # a top span of its own
        assert [s.name for s in _children(spans, frame)] == \
            FRAME_STAGES[bidir]
        assert [s.name for s in _children(spans, fetch)] == ["wait.fetch"]
        assert _children(spans, fetch)[0].fields == {
            "count": 5 if bidir else 4}
        kids = _children(spans, frame)
        for lab in (s for s in kids if s.name == "bm.lab"):
            assert [c.name for c in _children(spans, lab)] == [
                "wait.lab_upload"]
        search = next(s for s in kids if s.name == "bm.search")
        # The plan's one upload, then the candidates and the refine's
        # offsets in one span, whatever the directions.
        assert [c.name for c in _children(spans, search)] == [
            "wait.plan", "wait.candidates", "wait.strip_plan"]
        assert _children(spans, search)[1].fields == {"count": 2}
        assert search.fields["regions"] == out.segmentation.n_regions
        want = {"directions": 2} if bidir else {"direction": "prev"}
        assert {k: search.fields[k] for k in want} == want
        for lab in (s for s in kids if s.name == "bm.label"):
            assert lab.fields["regions"] > 0
        if not bidir:  # the new frame's labels gate the first pair
            assert lab.fields["regions"] == out.segmentation.n_regions
        refine = next(s for s in kids if s.name == "bm.refine")
        checks = _children(spans, refine)
        assert {c.name for c in checks} == {"wait.refine_check"}
        assert refine.fields == {"launches": blocks[k],
                                 "checks": len(checks)}
    for s in spans:
        assert s.frame == _top(spans, s).frame
        assert s.start_ns <= s.end_ns and s.device_ms is None


def test_one_region_plan_a_frame(monkeypatch, three_frames, flagship_runs):
    """Each frame builds its segmentation's plan once, in its search, and
    nothing on the frame path sorts labels on the host; the outputs are
    the unwrapped run's."""
    (plain, plain_blocks), _, _ = flagship_runs
    built, host_sorts = [], []
    build = matcher.region_plan
    argsort = np.argsort

    def counted(labels, n_regions, device):
        built.append(n_regions)
        return build(labels, n_regions, device)

    def host_sort(*args, **kwargs):
        host_sorts.append(np.shape(args[0]))
        return argsort(*args, **kwargs)

    monkeypatch.setattr(matcher, "region_plan", counted)
    monkeypatch.setattr(np, "argsort", host_sort)
    monkeypatch.setattr(matcher, "region_reduction_plan", None)
    blocks = []
    outs = _flagship(three_frames, blocks)
    assert built == [out.segmentation.n_regions for out in outs]
    assert host_sorts == []
    assert blocks == plain_blocks
    for got, want in zip(outs, plain):
        for name in ("u", "v", "t", "bm_u", "bm_v", "quantized_rgb",
                     "shift_vector"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        np.testing.assert_array_equal(got.segmentation.labels,
                                      want.segmentation.labels)


def _top(spans, s):
    while s.parent is not None:
        s = spans[s.parent]
    return s


def test_search_counts_its_chunks(flagship_runs):
    *_, spans = flagship_runs
    searches = [s for s in spans if s.name == "bm.search"]
    chunk = matcher.match_chunk("matmul", 16)
    for s in searches:
        f = s.fields
        assert f["candidates"] == len(matcher.search_candidates(7))
        assert f["strips"] == -(-40 // bm_cost._STRIP)
        assert f["chunks"] == f["strips"] * -(-f["candidates"] // chunk)
        strip = next(c for c in spans if c.parent == s.index
                     and c.name == "wait.strip_plan")
        assert strip.fields == {"count": 2 * f["strips"]}


def test_search_counts_its_launches(three_frames):
    """On the card the search's sums are csrc/bm_cost.cu's two launches a
    call, which the span notes as ``launches`` in place of the plain
    loop's ``strips`` and ``chunks``; bm_cost.LAUNCHES counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bm_cost kernel has no CPU form")

    def run():
        out1, state = bm_flow.optical_flow_block_matching(
            three_frames[0], three_frames[1], device="cuda", **FLAGSHIP_KW)
        bm_flow.optical_flow_block_matching(
            three_frames[1], three_frames[2], state=state, device="cuda",
            **FLAGSHIP_KW)

    before = bm_cost.LAUNCHES
    _, spans = _recorded(run)
    searches = [s for s in spans if s.name == "bm.search"]
    assert len(searches) == 2
    for s in searches:
        assert s.fields["launches"] == 2
        assert "strips" not in s.fields and "chunks" not in s.fields
        assert [c.name for c in spans if c.parent == s.index] == [
            "wait.plan", "wait.candidates"]
    assert bm_cost.LAUNCHES - before == 4


def test_ba_outputs_bitwise_with_recording(ba_pair):
    plain_blocks, traced_blocks = [], []
    want = _ba(ba_pair, plain_blocks)
    got, spans = _recorded(lambda: _ba(ba_pair, traced_blocks))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert traced_blocks == plain_blocks


def test_ba_spans_count_blocks_and_checks(ba_pair):
    blocks = []
    _, spans = _recorded(lambda: _ba(ba_pair, blocks))
    top, = (s for s in spans if s.parent is None)
    assert top.name == "ba.frame" and top.fields == {}
    kids = _children(spans, top)
    assert [s.name for s in kids] == ["ba.pyramid"] + ["ba.level"] * (
        BA_LEVEL + 1)
    levels = kids[1:]
    assert [s.fields["level"] for s in levels] == list(
        range(BA_LEVEL, -1, -1))
    assert [s.fields["blocks"] for s in levels] == blocks
    for s in levels:
        per_check = max((64 if s.fields["level"] == 0 else BA_FUSE)
                        // BA_FUSE, 1)
        assert s.fields["checks"] == s.fields["blocks"] // per_check
        waits = _children(spans, s)
        assert [w.name for w in waits] == ["wait.ba_check"] * len(waits)
        assert len(waits) == s.fields["checks"]
        assert s.fields["stopped"] in ("threshold", "strikes", "budget")
        assert s.frame == top.frame
    # Budget 8 sweeps = 2 blocks of 4: level 0 never reaches its first
    # check (sweep 64); the levels above check every block.
    assert levels[-1].fields["stopped"] == "budget"
