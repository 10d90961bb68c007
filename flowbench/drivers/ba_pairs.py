"""Drives the Black-Anandan pyramid on a closed loop of gray frame pairs.

One step hands the next pair of the traffic to the card (two host frames
uploaded), solves it with
``tpuflow_torch.solvers.black_anandan_fast.optical_flow_pyramid_fast`` and
fetches (u, v) back to the host. The program's counter it reads: the
driver's ``blocks`` list, each level's launched blocks of ``fuse`` sweeps,
coarsest level first.
"""

from __future__ import annotations

import time

import numpy as np

from flowbench import bounds
from flowbench.harness import load_module


class BAPairs:
    def __init__(self, ctx):
        from tpuflow_torch.core.config import MultipleMotionParam

        self.ctx = ctx
        cfg = ctx.cell.config
        self.cfg = cfg
        self.param = MultipleMotionParam(
            level=int(cfg["level"]),
            error_min_threshold=float(cfg["error_min_threshold"]))
        self.order = ctx.traffic.order()
        self.n = 0

    def step(self) -> dict:
        import torch

        from tpuflow_torch.solvers.black_anandan_fast import (
            optical_flow_pyramid_fast)

        k = next(self.order)
        prev, nxt = self.ctx.traffic.pairs[k]
        blocks = []
        t_in = time.perf_counter()
        a = torch.from_numpy(prev).to(self.ctx.device)
        b = torch.from_numpy(nxt).to(self.ctx.device)
        u, v = optical_flow_pyramid_fast(
            a, b, float(self.cfg["max_int"]), self.param,
            iter_max=int(self.cfg["iter_max"]), fuse=int(self.cfg["fuse"]),
            blocks=blocks)
        u, v = u.cpu().numpy(), v.cpu().numpy()
        t_done = time.perf_counter()
        rec = {"index": self.n, "pair": k, "u": u, "v": v, "blocks": blocks,
               "t_in": t_in, "t_done": t_done}
        self.n += 1
        return rec

    def warmup(self) -> None:
        for _ in range(int(self.ctx.cell.cell["warmup_steps"])):
            self.step()

    def release(self) -> None:
        if self.ctx.device != "cpu":
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, rec) -> dict:
        ref = load_module("reference", self.cfg["reference"])
        prev, nxt = self.ctx.traffic.pairs[rec["pair"]]
        u, v, _ = ref.flow(prev, nxt, self.cfg, self.ctx.device)
        return {"flow_max_abs_px": float(max(np.abs(rec["u"] - u).max(),
                                             np.abs(rec["v"] - v).max()))}

    def trace_extras(self, traced, counted) -> dict:
        """Sweeps run and the frozen IRLS bound of each traced frame, level
        by level (coarsest first, as ``blocks`` lists them)."""
        ref = load_module("reference", self.cfg["reference"])
        h, w = self.cfg["frame_shape"]
        sizes = ref.pyramid_sizes(w, h, int(self.cfg["level"]))[::-1]
        fuse = int(self.cfg["fuse"])
        sweeps, bound = [], 0.0
        for r in traced:
            sweeps.append(fuse * sum(r["blocks"]))
            for (wl, hl), b in zip(sizes, r["blocks"]):
                bound += bounds.irls_bound((hl, wl), b * fuse)
        return {"ba_sweeps": sweeps, "irls_bound_s": bound}


def make(ctx) -> BAPairs:
    return BAPairs(ctx)
