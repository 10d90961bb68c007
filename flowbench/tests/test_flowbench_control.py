"""The control (the reference one precision lower in the program's place)
fails each cell's comparison: on the card at the cell's own size on three
seeds (``-m card``), and here on the CPU at a crop."""

import json

import pytest

from flowbench import control, harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def _fails(name, got):
    limits = harness.Cell.load(name).cell["limits"]
    return [k for k, v in got.items() if not v <= limits[k]]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, seed, card):
    got = control.readings(name, seed, card)
    print(json.dumps({"workload": name, "seed": seed, "control": got}))
    assert _fails(name, got), got


@pytest.mark.parametrize("name", ["ba_kitti_pairs", "flagship_kitti_dense"])
def test_control_fails_on_a_crop(name):
    ov = {"config": {"frame_shape": [48, 80]}}
    if name.startswith("flagship"):
        ov["traffic"] = {"pool_frames": 6, "walk_margin": [6, 12]}
        ov["config"]["kernel_spatial"] = 5  # (4R + 1)^2 offsets on the CPU
    got = control.readings(name, SEEDS[0], "cpu", ov)
    assert _fails(name, got), got
