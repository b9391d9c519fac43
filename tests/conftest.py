"""Test configuration: run the tests on the CPU with 8 virtual devices
so the multi-device sharding logic is exercised without accelerators.

Backends are not initialized until first use, so setting jax_platforms
here (before any jax call) takes effect. Tests marked `gpu` skip on the
CPU; on a GPU host they run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist

The persistent compilation cache is off: XLA:CPU entries are machine
code for the host that compiled them, and a checkout copied to another
machine must not carry them there.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import functools  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU device for `gpu`-marked tests; skips anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)


def subprocess_isolated(fn):
    """Run the decorated (argument-less) test in its own pytest child.

    Workaround for a reproducible XLA:CPU in-process compiler segfault:
    compiling the 8-virtual-device coarse-space rebuild program crashes
    inside backend_compile_and_load, but ONLY after ~90 other tests
    have compiled in the same process (the identical test passes alone
    and in any small grouping tried). The crash is below Python, in
    LLVM/XLA state accumulated across compilations, so the honest fix
    is process isolation, not a repro-shaped change to the test.
    """
    if os.environ.get("DOT_ISOLATED_CHILD"):
        return fn

    @functools.wraps(fn)
    def wrapper():
        here = os.path.dirname(os.path.abspath(__file__))
        nodeid = f"{os.path.join(here, fn.__module__ + '.py')}::{fn.__name__}"
        env = dict(os.environ, DOT_ISOLATED_CHILD="1")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q", nodeid],
            cwd=os.path.dirname(here), env=env, timeout=1800,
            capture_output=True, text=True)
        assert r.returncode == 0, (
            f"isolated child failed (rc {r.returncode}):\n"
            f"{r.stdout[-4000:]}\n{r.stderr[-2000:]}")

    return wrapper
