"""The yardstick's roofline arithmetic, frozen.

Copied from ``chip_smoke.py`` (``bound``, ``irls_bound``, ``gated_bound``,
``ms_bound``, and the counting rule of ``ms_query_iterations``) so that a
later change to the program or its smoke script cannot move the bounds the
per-layer roofline shares are taken against. Each function returns the
least time one H100 SXM could take for the work, in seconds: each input
byte read and each output byte written once at the HBM rate, or the float32
operations at the peak rate, whichever is longer. An add, a multiply, a
division and a square root each count as one operation at the FMA rate, so
a bound is up to 2x optimistic for kernels that do mostly adds.
"""

from __future__ import annotations

import math

#: Published H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

#: Sweeps a launch of the flagship's gated refine runs at most, and the
#: sweeps between two of its energy checks (bm_flow.DEFAULT_FUSE,
#: bm_flow.CHECK_EVERY).
GATED_FUSE = 16
GATED_CHECK_EVERY = 64


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


def irls_bound(shape, sweeps: int) -> float:
    """#2, the IRLS sweep. Per pixel: the data term (4) and its psi (5),
    lambda_d * psi and its products with gx and gy (3), and for each of u
    and v the smoothness product, the sum, the division by sup and the
    subtraction (8). Per edge between two pixels in the frame, for each of
    u and v: the difference, psi (5), the add at one end and the
    subtraction at the other (8). Bytes: u, v, gx, gy, it read and u, v
    written once."""
    h, w = shape
    edges = h * (w - 1) + (h - 1) * w
    return bound_s(7 * 4 * h * w, sweeps * (20 * h * w + 16 * edges))


def same_region_edges(labels) -> int:
    """Edges between two 4-adjacent pixels of one region."""
    return (int((labels[:, 1:] == labels[:, :-1]).sum())
            + int((labels[1:] == labels[:-1]).sum()))


def gated_bound(px: int, edges: int, sweeps: int, batch: int) -> float:
    """#8, the region-gated sweep. Per pixel: the data term and psi (10),
    its norm (4), the two updates (12). Per same-region edge: the cosine and
    weight once (9), and for each of u and v the difference, psi and weight
    (8), the add at one end and the subtraction at the other (2). Bytes:
    u, v, it per direction and gx, gy, labels read, u, v written."""
    ops = sweeps * batch * (26 * px + 29 * edges)
    return bound_s(4 * px * (5 * batch + 3), ops)


def gated_sweeps_of_launches(launches: int, iter_max: int) -> int:
    """The sweeps the flagship's refine ran in ``launches`` launches: its
    schedule is 1 sweep, then blocks of 64 up to ``iter_max``, each block
    cut into launches of at most :data:`GATED_FUSE` (the frozen
    ``bm_flow._check_schedule``). Raises if no prefix of the schedule
    gives that launch count."""
    n, sweeps, count = 0, 0, 0
    while count < launches and n < iter_max:
        k = -(-n // GATED_CHECK_EVERY) * GATED_CHECK_EVERY
        end = min(k + 1, iter_max)
        block = end - n
        count += -(-block // GATED_FUSE)
        sweeps += block
        n = end
    if count != launches:
        raise ValueError(f"{launches} launches fit no prefix of the "
                         f"refine's schedule")
    return sweeps


def ms_disc(R: int) -> int:
    """Lattice points of a disc of radius R (1,257 at R = 20)."""
    return sum(2 * math.isqrt(R * R - dy * dy) + 1 for dy in range(-R, R + 1))


def ms_bound(px: int, R: int, query_iterations: int) -> float:
    """#11, the mean-shift filter. Per query, iteration it needs and offset
    within R of its drift: the spatial distance (3), the colour distance
    (8) and the two tests (2); per disc row the dy term (2). The sums of the
    points that pass depend on the data and are not counted, so the bound
    is low by up to 6 per offset. Bytes: the Lab frame read, (pos, col)
    written."""
    return bound_s(4 * 8 * px,
                   query_iterations * (13 * ms_disc(R) + 2 * (2 * R + 1)))


def ms_query_iterations(states) -> int:
    """The counting rule of ``chip_smoke.ms_query_iterations``: a query
    needs the iterations up to the first whose state repeats the previous
    iteration's bit for bit, or all of them. ``states`` is the list of
    per-query state bit patterns after 0, 1, ..., iters iterations (each
    an (N, k) int32 tensor); returns the iterations needed, summed."""
    import torch

    iters = len(states) - 1
    need = torch.full(states[0].shape[:1], iters, device=states[0].device)
    for k in range(1, iters + 1):
        same = (states[k] == states[k - 1]).all(1)
        need = torch.where(same & (need == iters), k, need)
    return int(need.sum())
