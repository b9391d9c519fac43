"""chip_smoke.py phase C at a tiny size on the CPU: every time stepper,
the 2D scene and the Stable Neo-Hookean scene through the CLI entry
point in f32, each held to an f64 Newton run (or, for the 2D and SNH
scenes, DOT in f64) within the test suite's bands."""

import pytest

import chip_smoke as cs

TINY = (12, 4, 4)
BLOCK = 128


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return str(tmp_path_factory.mktemp("chip_smoke_c"))


@pytest.fixture(scope="module")
def reference(out):
    return cs.phase_c_reference(out, dims=TINY)


@pytest.mark.parametrize("stepper", [*cs.STEPPERS, f"DOT -1 {BLOCK}"])
def test_phase_c_stepper_tiny(out, reference, stepper):
    cs.phase_c_stepper(out, stepper, reference, dims=TINY)


@pytest.mark.parametrize("kind", ["2d", "snh"])
def test_phase_c_scene_tiny(out, kind):
    cs.phase_c_scene(out, kind, dims=TINY, resolution_2d=200)
