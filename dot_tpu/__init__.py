"""dot_tpu — implicit elastodynamics on an accelerator, in JAX.

Re-implements the capabilities of the DOT reference code (Decomposed
Optimization Time integration, SIGGRAPH 2019; reference C++ at
penn-graphics-research/DOT) as a JAX/XLA framework:

- per-element energy/gradient/Hessian as batched kernels over all tets
  (reference: TBB + AVX2, src/Energy/Energy.cpp),
- subdomain-decomposed quasi-Newton (DOT) with batched dense or banded
  Cholesky initializers (reference: CHOLMOD per subdomain,
  src/TimeStepper/DOTTimeStepper.cpp),
- the whole inner solve jitted with `lax.while_loop` (no host round trips).

float64 is enabled at import so CPU tests can run at reference precision;
simulation dtype is chosen per-run (f32 on an accelerator by default).
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)


def compile_cache_dir():
    """Directory of JAX's persistent compilation cache: the one that
    JAX_COMPILATION_CACHE_DIR names (JAX reads that variable itself), or
    else one fixed path inside the checkout. The path is part of the
    cache's key, so it holds no host, process or time component."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from . import materials  # noqa: E402,F401
from .config import Config  # noqa: E402,F401
from .mesh import Mesh  # noqa: E402,F401

__version__ = "0.1.0"
