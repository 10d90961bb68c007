"""Halo exchange between the tiles of a mesh, and the tile/gather pair.

Port of :mod:`tpuflow.dist.halo`. Each rank owns an (H/ty, W/tx) tile; a
stencil of radius r needs the r-pixel border of its four neighbours.
:func:`halo_pad_2d` exchanges it peer to peer (``batch_isend_irecv``):
x strips first, then y strips of the widened tile, which carry the
corners. A global border, and an axis of size 1, receive zeros: the
reference's BORDER_CONSTANT / zeropad convention, so a zero-border stencil
on the padded tile computes what the single-device solve computes.

NCCL moves CUDA tensors; gloo moves CPU tensors, so on a mesh whose
backend is gloo and whose device is a card the strips cross the host
(:attr:`Mesh.staged`). The backend decides, never a caught error.

:func:`tile_of` and :func:`gather_tiles` stand for
``jax.device_put(x, NamedSharding(mesh, P("ty", "tx")))`` and for the
global array a sharded result stands for. All functions take tiles of
shape (..., h, w): leading axes ride along in one message.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuflow_torch.dist.mesh import Mesh


def _exchange(mesh: Mesh, sends, recvs) -> None:
    """Post every (peer, tensor) send and (peer, buffer) receive at once and
    wait for them all; a CUDA tensor on a staged mesh crosses the host."""
    if not sends and not recvs:
        return
    host = [(p, t.cpu().contiguous() if mesh.staged else t.contiguous())
            for p, t in sends]
    bufs = [(p, torch.empty_like(b, device="cpu") if mesh.staged else b)
            for p, b in recvs]
    ops = ([dist.P2POp(dist.isend, t, p, mesh.group) for p, t in host]
           + [dist.P2POp(dist.irecv, b, p, mesh.group) for p, b in bufs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if mesh.staged:
        for (_, b), (_, staged) in zip(recvs, bufs):
            b.copy_(staged)


def _step(mesh: Mesh, axis: str, direction: int):
    """(source, destination) global ranks of a one-step move along
    ``axis`` ("ty" or "tx"); None where there is none."""
    dy, dx = (direction, 0) if axis == "ty" else (0, direction)
    return (mesh.peer(mesh.iy - dy, mesh.ix - dx),
            mesh.peer(mesh.iy + dy, mesh.ix + dx))


def shift_along(x: torch.Tensor, mesh: Mesh, axis: str,
                direction: int) -> torch.Tensor:
    """Move data one step along a mesh axis ("ty" or "tx").

    direction=+1: rank i's data arrives at rank i+1 (each receives from its
    left/top neighbour); ranks with no source receive zeros.
    """
    src, dst = _step(mesh, axis, direction)
    out = torch.zeros_like(x)
    _exchange(mesh, [] if dst is None else [(dst, x)],
              [] if src is None else [(src, out)])
    return out


def _pad_axis(tile: torch.Tensor, r: int, mesh: Mesh, axis: str):
    """Concatenate the neighbours' r-wide strips along one axis (zeros at a
    global border): the low side gets the low neighbour's high strip."""
    dim = -1 if axis == "tx" else -2
    lo_src, hi_dst = _step(mesh, axis, +1)
    shape = list(tile.shape)
    shape[dim] = r
    low = tile.new_zeros(shape)
    high = tile.new_zeros(shape)
    sends, recvs = [], []
    if hi_dst is not None:
        sends.append((hi_dst, tile.narrow(dim, tile.shape[dim] - r, r)))
        recvs.append((hi_dst, high))
    if lo_src is not None:
        sends.append((lo_src, tile.narrow(dim, 0, r)))
        recvs.append((lo_src, low))
    _exchange(mesh, sends, recvs)
    return torch.cat([low, tile, high], dim=dim)


def halo_pad_2d(tile: torch.Tensor, r: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (..., h, w) tile to (..., h + 2r, w + 2r) with its neighbours'
    halos; global borders get zeros (BORDER_CONSTANT)."""
    if r < 1:
        return tile
    th, tw = tile.shape[-2:]
    if (mesh.tx > 1 and r > tw) or (mesh.ty > 1 and r > th):
        raise ValueError(f"halo {r} wider than the {th}x{tw} tile")
    return _pad_axis(_pad_axis(tile, r, mesh, "tx"), r, mesh, "ty")


def tile_of(full: torch.Tensor, mesh: Mesh, halo: int = 0) -> torch.Tensor:
    """This rank's (..., H/ty, W/tx) tile of a full frame every rank holds,
    with ``halo`` pixels of the zero-padded frame around it."""
    h, w = full.shape[-2:]
    if h % mesh.ty or w % mesh.tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    th, tw = h // mesh.ty, w // mesh.tx
    src = full
    if halo:
        src = torch.nn.functional.pad(full, (halo, halo, halo, halo))
    return src[..., mesh.iy * th : mesh.iy * th + th + 2 * halo,
               mesh.ix * tw : mesh.ix * tw + tw + 2 * halo].contiguous()


def all_gather(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` in mesh order, on x's device."""
    if mesh.size == 1:
        return [x]
    src = x.cpu() if mesh.staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return [p.to(x.device) for p in parts]


def gather_tiles(tile: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full (..., H, W) frame from every rank's tile, on every rank."""
    if mesh.size == 1:
        return tile
    parts = all_gather(tile, mesh)
    rows = [torch.cat(parts[i * mesh.tx : (i + 1) * mesh.tx], dim=-1)
            for i in range(mesh.ty)]
    return torch.cat(rows, dim=-2)


def all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    """``x`` reduced over the mesh with ``op`` (a ``dist.ReduceOp``), on
    x's device; a new tensor."""
    if mesh.size == 1:
        return x.clone()
    buf = x.cpu() if mesh.staged else x.clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(x.device)
