"""Weak-scaling measurement of the sharded Horn-Schunck.

Port of :mod:`tpuflow.dist.scaling`. Runs the fused sharded HS at a
per-rank-constant problem size over growing sub-meshes (the first 1, 2,
4, ... ranks, each a ``new_group``) and reports throughput and efficiency
(t_1 / t_n; 1.0 is perfect weak scaling). Call it on every rank of an
initialised process group (e.g. inside :func:`~tpuflow_torch.dist.mesh.
run_on_mesh`); every rank returns the same report structure, with rank 0's
times. On one card it has one row, n = 1.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from tpuflow_torch.dist.mesh import make_mesh, mesh_factor
from tpuflow_torch.dist.solvers import horn_schunck_sharded_fused


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling_report(
    tile_hw: tuple[int, int] = (512, 512),
    iterations: int = 50,
    window_size: int = 5,
    fuse: int = 5,
    repeats: int = 3,
    device=None,
) -> dict:
    """Time the fused sharded HS at ``tile_hw`` *per rank* on sub-meshes of
    1, 2, 4, ... ranks of the default group; ``device`` as for
    :func:`~tpuflow_torch.dist.mesh.make_mesh`. Each row's seconds are the
    mean over ``repeats`` calls after one warm-up, the card synchronised
    before and after."""
    th, tw = tile_hw
    world = dist.get_world_size()
    counts = [1 << k for k in range(world.bit_length()) if 1 << k <= world]
    rows = []
    t_base = None
    for n in counts:
        mesh = make_mesh(n, device=device)
        ty, tx = mesh_factor(n)
        h, w = th * ty, tw * tx
        dt = None
        if mesh is not None:
            rng = np.random.default_rng(0)
            prev_np = rng.uniform(0, 255, (h, w)).astype(np.float32)
            prev = torch.from_numpy(prev_np).to(mesh.device)
            nxt = torch.from_numpy(np.roll(prev_np, 2, axis=1)).to(mesh.device)

            def run():
                return horn_schunck_sharded_fused(prev, nxt, mesh, window_size,
                                                  iterations, 1.0, fuse)

            run()
            _sync(mesh.device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                run()
            _sync(mesh.device)
            dt = (time.perf_counter() - t0) / repeats
        # Rank 0's time, on every rank.
        box = [dt]
        dist.broadcast_object_list(box, src=0)
        dt = box[0]
        if t_base is None:
            t_base = dt
        rows.append({
            "devices": n, "mesh": [ty, tx], "image": [h, w],
            "seconds": dt,
            "mpix_per_s": h * w * iterations / dt / 1e6,
            "efficiency": t_base / dt,
        })
    return {"tile": list(tile_hw), "iterations": iterations, "runs": rows}
