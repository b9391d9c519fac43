"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
anywhere but on a GPU, and the device-honesty pieces it relies on: the
compile-cache location, the device memory budget, the generated bar
scene and the precision pinned on every f32 dot_general."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs

TINY = (12, 4, 4)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return str(tmp_path_factory.mktemp("chip_smoke"))


@pytest.mark.parametrize("entry", [lambda: cs.main([]), bench.main],
                         ids=["chip_smoke", "bench"])
def test_entry_points_refuse_a_cpu(entry):
    with pytest.raises(SystemExit) as e:
        entry()
    assert "needs a GPU" in str(e.value.code)


def test_phase_a_tiny(out):
    r = cs.phase_a(out, dims=TINY, warmup=1, frames=2)
    assert len(r["sys_e"]) == 3 and r["iters_per_frame"] > 0
    assert r["paths"]["partitioner"] in ("kway", "rcb")


def test_phase_b_tiny(out):
    r32, r64 = cs.phase_b(out, dims=TINY, frames=3)
    assert r32["dtype"] == "f32" and r64["dtype"] == "f64"
    assert len(r32["sys_e"]) == len(r64["sys_e"]) == 3


def test_phase_d_tiny(out):
    r = cs.phase_d(out, dims=TINY, frames=2, block=64, expect_large=False)
    assert r["frames"] == 2 and r["iters_per_frame"] > 0


def test_phase_d_demands_the_large_paths(out):
    with pytest.raises(RuntimeError, match="large-subdomain paths"):
        cs.phase_d(out, dims=TINY, frames=1, block=64)


def test_check_agree_fails_outside_the_band():
    r = {"name": "a", "dtype": "f32", "sys_e": [1.0, 1.01],
         "x": np.zeros((2, 3))}
    ref = {"name": "b", "dtype": "f64", "sys_e": [1.0, 1.0],
           "x": np.zeros((2, 3))}
    with pytest.raises(RuntimeError, match="sysE"):
        cs.check_agree(r, ref, 1e-3)


@pytest.mark.parametrize("env", [None, "custom_cache"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    import dot_tpu
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(dot_tpu.__file__)))
        assert dot_tpu.compile_cache_dir() == os.path.join(repo,
                                                           ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env))
        assert dot_tpu.compile_cache_dir() == str(tmp_path / env)


def _plan(band_nb=3, band_bs=384, n_parts=4, n3=1152):
    from types import SimpleNamespace
    return SimpleNamespace(band_nb=band_nb, band_bs=band_bs,
                           n_parts=n_parts, n3=n3)


def test_matrix_budget_against_a_device_limit():
    from dot_tpu.sim import _check_matrix_budget
    # 5 x 4 parts x 5 blocks x 384^2 x 4 B = 59 MB
    _check_matrix_budget(_plan(), jnp.float32, "Newton",
                         limit_bytes=1 << 30)
    with pytest.raises(MemoryError, match="exceeds the device's"):
        _check_matrix_budget(_plan(), jnp.float32, "Newton",
                             limit_bytes=1 << 20)


def test_matrix_budget_skipped_without_a_device_limit():
    from dot_tpu.sim import _check_matrix_budget, device_memory_limit
    assert device_memory_limit() is None        # the CPU reports none
    _check_matrix_budget(_plan(band_nb=1000, band_bs=3840), jnp.float64,
                         "Newton")


def test_generated_bar17k_scene(tmp_path):
    from dot_tpu.config import Config
    from dot_tpu.mesh import Mesh
    from dot_tpu.scenes import write_bar_scene
    cfg = Config.load(write_bar_scene(str(tmp_path), "bar17"))
    assert (cfg.time_stepper, cfg.partition_amt, cfg.energy) == \
        ("DOT", 6, "FCR")
    assert (cfg.dt, cfg.ym, cfg.pr, cfg.warm_start) == (0.025, 1e5, 0.4, 2)
    mesh = Mesh.from_config(cfg)
    assert (mesh.n_elem, mesh.n_vert) == (86016, 16473)


def _dot_generals(jaxpr):
    """(operand dtypes, precision) of every dot_general, sub-jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(({v.aval.dtype for v in eqn.invars},
                        eqn.params["precision"]))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if hasattr(sub, "jaxpr"):
                    out.extend(_dot_generals(getattr(sub, "jaxpr", sub)))
                elif hasattr(sub, "eqns"):
                    out.extend(_dot_generals(sub))
    return out


def _banded_f32_system(n_parts=2, nx=24):
    import __graft_entry__ as ge
    return ge._build_scene(n_parts=n_parts, nx=nx, band_bs_unit=24,
                           band_min_nb=3)


@pytest.mark.parametrize("path", ["exact", "fast", "dot_step"])
def test_f32_dot_generals_pin_highest(path):
    """Every dot_general with f32 operands names HIGHEST, so no backend
    may run it as TF32 or bf16 passes; bf16 operands are the only
    reduced precision (core module docstring)."""
    from dot_tpu.steppers.core import F64, BTDFactor, CRFactor
    system, stepper = _banded_f32_system()
    state = stepper.init_state()
    if path == "dot_step":
        tol = jnp.asarray(system.target_g_res(1e-5), F64)
        jp = jax.make_jaxpr(type(stepper)._step_impl)(stepper, state, tol)
    else:
        fast = path == "fast"

        def f(sy, x, fixed, b):
            _, U, s, V = sy.fsvd(x)
            Hd = sy.assemble_subdomains(sy.element_hessians(U, s, V), fixed)
            L, d = sy.factorize_fast(Hd) if fast else sy.factorize(Hd)
            assert isinstance(L, (BTDFactor, CRFactor))
            return sy.solve_local(L, b)

        b = jnp.ones((system.n_parts, system.n3), jnp.float32)
        jp = jax.make_jaxpr(f)(system, state.x, state.fixed, b)
    dots = _dot_generals(jp.jaxpr)
    assert dots
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    f32 = [p for dts, p in dots if jnp.dtype(jnp.float32) in dts]
    assert f32 and all(p == hi for p in f32), set(map(str, f32))


def test_dryrun_multichip_in_process():
    """The multi-device dry run uses the devices JAX already has (the
    conftest's virtual CPU devices) — no re-exec onto another backend."""
    import __graft_entry__ as ge
    assert len(jax.devices()) >= 4
    ge.dryrun_multichip(4)


def test_dryrun_multichip_needs_the_devices():
    import __graft_entry__ as ge
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.sharded_dot_check(64)


@pytest.mark.gpu
def test_exact_factor_residual_on_gpu(gpu, tmp_path):
    """The exact-path factor on the card against the f64 bands of
    chip_smoke phase B, at the bar17K-class widths."""
    from dot_tpu.config import Config
    from dot_tpu.scenes import write_bar_scene
    from dot_tpu.sim import Simulator
    cfg = Config.load(write_bar_scene(str(tmp_path), "bar17"))
    for dt, lim in ((jnp.float32, cs.RESID_F32), (jnp.float64,
                                                  cs.RESID_F64)):
        sim = Simulator(cfg, str(tmp_path / str(dt)), dtype=dt,
                        save_every=10 ** 9, mute=True, render=False)
        sim.run(2)
        res = cs.factor_residual(sim.system, sim.state.x, sim.state.fixed, 0)
        assert res <= lim, (dt, res)


@pytest.mark.gpu
def test_f32_dot_matches_f64_on_gpu(gpu, tmp_path):
    """Phase B's comparison on the card at a small width."""
    cs.phase_b(str(tmp_path), dims=cs.BUNNY_BAR, frames=3)
