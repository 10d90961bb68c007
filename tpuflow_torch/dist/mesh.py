"""The (ty, tx) mesh of ranks for 2-D image-domain tiling, and its launcher.

Port of :mod:`tpuflow.dist.mesh`. tpuflow tiles a frame over a JAX device
mesh ``("ty", "tx")`` under one controller; here every tile is a process
(a rank of ``torch.distributed``) and a :class:`Mesh` is one rank's view:
the mesh's extents, its own place in it, its process group and its
device. Rank ``r`` of the group sits at ``divmod(r, tx)``, as
``np.array(devices).reshape(ty, tx)`` places tpuflow's devices.

- NCCL moves CUDA tensors between cards; gloo moves CPU tensors, so a CUDA
  tile under gloo is staged through the host (:mod:`tpuflow_torch.dist.halo`).
- :func:`run_on_mesh` is the counterpart of tpuflow's single controller:
  it spawns the ranks, runs one function on each over a mesh and returns
  rank 0's result. Nothing here starts a process or a group at import.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# Seconds a collective may wait before its process group gives up, and the
# launcher's default deadline for a whole run.
GROUP_TIMEOUT_S = 300.0
RUN_TIMEOUT_S = 600.0


def mesh_factor(n: int) -> tuple[int, int]:
    """Factor n into (ty, tx) as near-square as possible, tx >= ty."""
    ty = int(math.isqrt(n))
    while n % ty != 0:
        ty -= 1
    return ty, n // ty


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (ty, tx) mesh.

    ``ranks`` are the global ranks of the group's members in mesh order
    (point-to-point ops address global ranks); ``group`` is None for the
    default group."""

    ty: int
    tx: int
    iy: int
    ix: int
    ranks: tuple[int, ...]
    group: object
    device: torch.device
    backend: str

    @property
    def shape(self) -> tuple[int, int]:
        return self.ty, self.tx

    @property
    def size(self) -> int:
        return self.ty * self.tx

    @property
    def staged(self) -> bool:
        """Whether tiles cross the host for the exchange (gloo on a card)."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def peer(self, iy: int, ix: int) -> int | None:
        """Global rank at mesh place (iy, ix), or None off the mesh."""
        if 0 <= iy < self.ty and 0 <= ix < self.tx:
            return self.ranks[iy * self.tx + ix]
        return None


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """A (ty, tx) mesh over the first ``n_devices`` ranks of the initialised
    default process group (all of them by default).

    Every rank must call it (a sub-mesh creates a group, a collective call);
    a rank outside the sub-mesh gets None. ``device`` defaults to
    ``cuda:<rank % device_count>``; the CPU is used only when asked for.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (use run_on_mesh or "
                           "torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices of a world of {world}")
    group = None if n == world else dist.new_group(ranks=list(range(n)))
    if rank >= n:
        return None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                               "to tile on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    ty, tx = mesh_factor(n)
    iy, ix = divmod(rank, tx)
    return Mesh(ty, tx, iy, ix, tuple(range(n)), group, device,
                dist.get_backend(group))


def _rank_main(rank, world_size, backend, device, init_file, threads, fn,
               args, kwargs, results):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            if device == "cuda":
                torch.cuda.set_device(rank % torch.cuda.device_count())
                mesh = make_mesh(device=None)
            else:
                mesh = make_mesh(device=device)
            out = fn(mesh, *args, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def run_on_mesh(fn, world_size: int, backend: str = "nccl",
                device: str = "cuda", *, args: tuple = (),
                kwargs: dict | None = None, timeout: float = RUN_TIMEOUT_S,
                threads: int = 1):
    """Run ``fn(mesh, *args, **kwargs)`` on ``world_size`` spawned ranks
    and return rank 0's result (pickled across; return CPU tensors or
    numpy).

    Ranks rendezvous through a file in a fresh temporary directory, so two
    launchers never contend for a port. Each rank uses ``threads`` torch
    threads; ``device="cuda"`` puts rank r on card ``r % device_count``,
    ``device="cpu"`` keeps every tile on the host. Every process group
    waits at most :data:`GROUP_TIMEOUT_S` in a collective; past
    ``timeout`` seconds the launcher kills every rank and raises. A rank
    that fails makes the launcher kill the others and raise with its
    traceback. ``fn`` must be importable by name (a module-level function).
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="tpuflow_mesh_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main,
            args=(rank, world_size, backend, device, init_file, threads, fn,
                  args, kwargs or {}, results),
            daemon=True)
            for rank in range(world_size)]
        for p in procs:
            p.start()
        reported, result, errors = set(), None, []
        try:
            while len(reported) < world_size and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"run_on_mesh: {world_size} ranks did not "
                                  f"finish within {timeout} s")
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in reported]
                    if dead:
                        errors.append(f"run_on_mesh: rank {dead[0]} exited "
                                      f"with code {procs[dead[0]].exitcode} "
                                      "and no report")
                    continue
                reported.add(rank)
                if not ok:
                    errors.append(payload)
                elif rank == 0:
                    result = pickle.loads(payload)
            if errors:
                # A failed rank makes its peers fail too: gather their
                # reports for a moment, so the one that failed first shows.
                grace = time.monotonic() + 2.0
                while time.monotonic() < grace:
                    try:
                        _, ok, payload = results.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if not ok:
                        errors.append(payload)
            for p in procs:
                if not errors:
                    p.join(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if errors:
        raise RuntimeError("\n".join(errors))
    return result
