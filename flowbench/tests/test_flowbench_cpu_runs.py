"""Each driver against its reference on the CPU, and the faults a cell can
have seen to fail its comparison.

A run here skips run.py's look for a card and drives the rest of a run
(``harness.run(device="cpu")``) at a crop of the configuration's frame
size: the port's plain versions stand in for its kernels."""

import numpy as np
import pytest

from flowbench import harness

SEED = 2**31 + 977


def _crop(name, shape, small_kernel):
    ov = {"config": {"frame_shape": list(shape)}}
    if name.startswith("flagship"):
        ov["traffic"] = {"pool_frames": 6, "walk_margin": [6, 12]}
        if small_kernel:
            # The plain mean-shift sweeps (4R + 1)^2 offsets a pixel; the
            # faults' runs take R = 5 to stay short on the CPU.
            ov["config"]["kernel_spatial"] = 5
    return ov


def _run(name, shape, small_kernel=False, seed=SEED):
    return harness.run(name, seed, 0.5, False, device="cpu",
                       overrides=_crop(name, shape, small_kernel))


@pytest.mark.parametrize("name", ["ba_kitti_pairs", "flagship_kitti_dense"])
def test_driver_matches_reference_on_a_crop(name):
    res = _run(name, (96, 160))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def _state_unchanged_ba(monkeypatch):
    from tpuflow_torch.solvers import black_anandan_fast

    monkeypatch.setattr(black_anandan_fast, "irls_sweeps",
                        lambda u, v, *a, **k: (u, v))


def _state_unchanged_flagship(monkeypatch):
    from tpuflow_torch.kernels import irls_stencil

    monkeypatch.setattr(irls_stencil, "irls_gated_sweeps",
                        lambda u, v, *a, **k: (u, v))


def _answer_altered_ba(monkeypatch):
    from tpuflow_torch.solvers import black_anandan_fast

    solve = black_anandan_fast.optical_flow_pyramid_fast

    def altered(*a, **k):
        u, v = solve(*a, **k)
        u = u.clone()
        u[5, 7] += 0.05
        return u, v

    monkeypatch.setattr(black_anandan_fast, "optical_flow_pyramid_fast",
                        altered)


def _answer_altered_flagship(monkeypatch):
    from tpuflow_torch.blockmatching import matcher

    refine = matcher._argmin_and_refine

    def altered(*a, **k):
        uv, cost = refine(*a, **k)
        uv = uv.clone()
        uv[0, 0] += 1.0
        return uv, cost

    monkeypatch.setattr(matcher, "_argmin_and_refine", altered)


def _half_batch_flagship(monkeypatch):
    """The refine's batch of two directions with the second left out."""
    from tpuflow_torch.kernels import irls_stencil

    sweeps = irls_stencil.irls_gated_sweeps

    def half(u, v, *a, **k):
        nu, nv = sweeps(u, v, *a, **k)
        if u.dim() == 3:
            nu, nv = nu.clone(), nv.clone()
            nu[1:], nv[1:] = u[1:], v[1:]
        return nu, nv

    monkeypatch.setattr(irls_stencil, "irls_gated_sweeps", half)


FAULTS = [("ba_kitti_pairs", _state_unchanged_ba),
          ("ba_kitti_pairs", _answer_altered_ba),
          ("flagship_kitti_dense", _state_unchanged_flagship),
          ("flagship_kitti_dense", _answer_altered_flagship),
          ("flagship_kitti_dense", _half_batch_flagship)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_fault_fails_the_comparison(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name, (48, 80), small_kernel=True)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
    assert any(not c["value"] <= c["limit"] for c in res["checks"].values())
    assert all(np.isfinite(c["limit"]) for c in res["checks"].values())
