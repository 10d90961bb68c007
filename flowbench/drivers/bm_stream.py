"""Drives the flagship as a closed-loop stream of colour frames.

One step pulls the next frame of the traffic's walk into
``tpuflow_torch.pipeline.streaming.bm_flow_stream`` (which issues that
frame's work before it fetches the previous pair's result) and returns the
output it yields: the flow of the middle frame of the three frames before
it. The first output is one-directional and cold; warm-up takes it and the
second.

The program's counters it reads: the gated refine's launches (the driver's
``blocks`` list, one entry a call) and, in a traced run, the refine's
energy checks through the program's telemetry (one ``irls.energy`` event a
check and direction), which tell whether both directions ran the same
sweeps.
"""

from __future__ import annotations

import io
import json
import time
from types import SimpleNamespace

import numpy as np

from flowbench import bounds
from flowbench.harness import load_module


class _Events(io.StringIO):
    """A telemetry sink whose events a step takes away."""

    def take(self) -> list:
        lines = self.getvalue().splitlines()
        self.seek(0)
        self.truncate()
        return [json.loads(s) for s in lines]


class BMStream:
    def __init__(self, ctx):
        from tpuflow_torch.pipeline.streaming import bm_flow_stream

        self.ctx = ctx
        cfg = ctx.cell.config
        self.cfg = cfg
        self.pool = ctx.traffic
        self.pulled = []        # (pool index, host time handed in)
        self.blocks = []        # gated refine launches, one entry a call
        self.events = None
        if ctx.trace:
            from tpuflow_torch.utils.telemetry import Telemetry, set_telemetry

            self.events = _Events()
            set_telemetry(Telemetry(stream=self.events, enabled=True))

        def frames():
            for idx in self.pool.order():
                self.pulled.append((idx, time.perf_counter()))
                yield self.pool.frames[idx]

        self.stream = bm_flow_stream(
            frames(), float(cfg["max_int"]), device=ctx.device,
            blocks=self.blocks, mode=int(cfg["mode"]),
            iter_max=int(cfg["iter_max"]),
            search_range=int(cfg["search_range"]),
            kernel_spatial=int(cfg["kernel_spatial"]),
            kernel_intensity=float(cfg["kernel_intensity"]),
            subpixel_scale=int(cfg["subpixel_scale"]),
            bm_method=cfg["bm_method"], profile=cfg["profile"])
        self.n_out = 0

    def step(self) -> dict:
        out = next(self.stream)
        t_done = time.perf_counter()
        j = self.n_out
        self.n_out += 1
        rec = {"index": j, "out": out, "t_done": t_done,
               "t_in": self.pulled[j + 1][1],
               "frames": tuple(self.pulled[k][0] for k in (j - 1, j, j + 1))
               if j else None}
        if self.events is not None:
            rec["energy"] = [e for e in self.events.take()
                             if e.get("event") == "irls.energy"]
        return rec

    def warmup(self) -> None:
        for _ in range(int(self.ctx.cell.cell["warmup_steps"])):
            self.step()

    def release(self) -> None:
        """Drop the program's stream and its device state."""
        self.stream.close()
        self.stream = None
        if self.ctx.device != "cpu":
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _reference(self):
        return load_module("reference", self.cfg["reference"])

    def check(self, rec) -> dict:
        """The reference's numbers for a sampled output (a bidirectional
        middle frame)."""
        ref_mod = self._reference()
        frames = [self.pool.frames[k] for k in rec["frames"]]
        ref = ref_mod.frame_reference(*frames, self.cfg, self.ctx.device)
        o = rec["out"]
        seg = o.segmentation
        return ref_mod.judge(SimpleNamespace(
            labels=seg.labels, pos=seg.shift_spatial, col=seg.shift_color,
            bm_u=o.bm_u, bm_v=o.bm_v, t=o.t, u=o.u, v=o.v), ref)

    def trace_extras(self, traced, counted) -> dict:
        """Bounds of the work the traced steps issued. Step j issues call
        j + 1, which filters frame j + 2 of the walk and refines the middle
        frame of output j + 1 (yielded by the next step, a counting step
        for the last traced one)."""
        import torch

        ref_mod = self._reference()
        cfg = self.cfg
        by_index = {r["index"]: r for r in traced + counted}
        gated, ms = 0.0, 0.0
        batch_known = True
        for r in traced:
            call = r["index"] + 1
            out = by_index[call]["out"]
            labels = out.segmentation.labels
            sweeps = bounds.gated_sweeps_of_launches(self.blocks[call],
                                                     int(cfg["iter_max"]))
            iters = [e["iteration"] for e in r.get("energy", [])]
            runs = np.split(iters, [k for k in range(1, len(iters))
                                    if iters[k] <= iters[k - 1]])
            batch = 2 if out.bidirectional else 1
            if batch == 2 and (len(runs) != 2
                               or len(runs[0]) != len(runs[1])):
                batch_known = False
            gated += bounds.gated_bound(labels.size,
                                        bounds.same_region_edges(labels),
                                        sweeps, batch)
            lab = ref_mod.to_lab(self.pool.frames[self.pulled[call + 1][0]],
                                 float(cfg["max_int"])).to(self.ctx.device)
            _, _, states = ref_mod.mean_shift(
                lab, int(cfg["kernel_spatial"]),
                float(cfg["kernel_intensity"]), int(cfg["ms_iters"]),
                states=True)
            ms += bounds.ms_bound(labels.size, int(cfg["kernel_spatial"]),
                                  bounds.ms_query_iterations(states))
            del states
            if self.ctx.device != "cpu":
                torch.cuda.empty_cache()
        return {"gated_bound_s": gated if batch_known else None,
                "ms_bound_s": ms}


def make(ctx) -> BMStream:
    return BMStream(ctx)
