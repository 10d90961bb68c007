"""tpuflow_torch's package boundary: it imports neither jax nor tpuflow,
builds nothing at import, and takes tpuflow's configuration by field name."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from tpuflow.core.config import MultipleMotionParam as JParam
from tpuflow_torch.core.config import MultipleMotionParam, from_tpuflow

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, subprocess, sys

def refuse(*args, **kwargs):
    raise AssertionError(f"a subprocess was started at import: {args!r}")

subprocess.Popen = refuse
import tpuflow_torch
names = [m.name for m in pkgutil.walk_packages(tpuflow_torch.__path__,
                                               "tpuflow_torch.")]
for name in names:
    importlib.import_module(name)
from tpuflow_torch.kernels import _build
assert _build.load.cache_info().currsize == 0, "a kernel was loaded"
from tpuflow_torch import native
assert native.load_library.cache_info().currsize == 0, "g++ library loaded"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpuflow", "PIL", "cv2"))
assert not bad, bad
print(" ".join(names))
"""

# Modules of the I/O, demo and sharded-Farneback slice; each must be among
# the modules the import check walks.
SLICE_MODULES = ("tpuflow_torch.core.io", "tpuflow_torch.core.errors",
                 "tpuflow_torch.native", "tpuflow_torch.pipeline.demos",
                 "tpuflow_torch.pipeline.writers", "tpuflow_torch.viz",
                 "tpuflow_torch.viz.colorwheel", "tpuflow_torch.viz.quiver",
                 "tpuflow_torch.viz.plot2d", "tpuflow_torch.viz.plot3d",
                 "tpuflow_torch.dist.farneback",
                 # The main program's slice.
                 "tpuflow_torch.detection.scratch",
                 "tpuflow_torch.detection.alignments",
                 "tpuflow_torch.detection.exclusive",
                 "tpuflow_torch.features.hog", "tpuflow_torch.dist.ops",
                 "tpuflow_torch.pipeline.orchestrator",
                 "tpuflow_torch.cli.parser", "tpuflow_torch.cli.__main__")


def test_imports_no_jax_and_builds_nothing():
    """Every module imports in a fresh interpreter without pulling in jax,
    tpuflow, PIL or cv2 and without starting nvcc, g++ (or any other
    process)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 14
    assert [m for m in SLICE_MODULES if m not in names] == []


def _non_default_values():
    return dict(level=3, irls_iter_max=77, error_min_threshold=2.5e-3,
                lambda_d=4.0, lambda_s=0.5, sigma_d=1.5, sigma_s=0.25,
                block_matching_block_size=16, bm_search_range=31,
                bm_subpixel_scale=4, bm_kernel_spatial=12,
                bm_kernel_intensity=0.125, bm_method="gather",
                bm_refine_warp=True, bm_profile="fast")


def test_from_tpuflow_round_trips_every_field():
    """Every field of tpuflow's MultipleMotionParam crosses by name; a
    field the JAX side gains and the port lacks fails here."""
    values = _non_default_values()
    assert set(values) == {f.name for f in dataclasses.fields(JParam)}
    port = from_tpuflow(JParam(**values))
    assert isinstance(port, MultipleMotionParam)
    assert dataclasses.asdict(port) == values
    assert dataclasses.asdict(MultipleMotionParam()) == \
        dataclasses.asdict(JParam())


def test_from_tpuflow_rejects_unknown_fields():
    @dataclasses.dataclass
    class Wider(JParam):
        new_knob: int = 1

    with pytest.raises(ValueError, match="new_knob"):
        from_tpuflow(Wider())
    with pytest.raises(TypeError):
        from_tpuflow(JParam)


def test_solvers_export_what_tpuflow_exports():
    """Every public function of ``tpuflow.solvers`` has its namesake in
    ``tpuflow_torch.solvers``."""
    import tpuflow.solvers as jsolvers
    import tpuflow_torch.solvers as tsolvers

    names = [n for n in dir(jsolvers) if not n.startswith("_")
             and callable(getattr(jsolvers, n))]
    assert len(names) >= 24
    assert [n for n in names if not callable(getattr(tsolvers, n, None))] \
        == []


@pytest.mark.parametrize("package,least", [("detection", 9),
                                           ("features", 6), ("ops", 12),
                                           ("dist", 20)])
def test_package_exports_what_tpuflow_exports(package, least):
    """Every public function and class of ``tpuflow.<package>`` has its
    namesake in ``tpuflow_torch.<package>`` (tpuflow's submodules
    aside)."""
    import importlib
    import types

    jpkg = importlib.import_module(f"tpuflow.{package}")
    tpkg = importlib.import_module(f"tpuflow_torch.{package}")
    names = [n for n in dir(jpkg) if not n.startswith("_")
             and callable(getattr(jpkg, n))
             and not isinstance(getattr(jpkg, n), types.ModuleType)]
    assert len(names) >= least
    assert [n for n in names if not callable(getattr(tpkg, n, None))] == []
