"""End-to-end stepper tests on a small structured bar (CPU, f64).

Mirrors the reference's de-facto integration test: different solvers on the
same scene must agree since all minimize the same incremental potential to
the same characteristic tolerance (reference: input/otherMethods/ suite,
SURVEY section 4.4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dot_tpu.mesh_gen import bar_mesh
from dot_tpu.config import Config
from dot_tpu import partition, scripts
from dot_tpu.steppers import System, DOTStepper, NewtonStepper


def _scene(script="stretch", energy="FCR"):
    mesh = bar_mesh(8, 3, 3)
    cfg = Config(energy=energy, dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                 script=script, handle_ratio=0.05)
    mesh.set_lame(cfg.ym, cfg.pr)
    mesh.find_border_verts(cfg.handle_ratio)
    sd = scripts.init_script(mesh, script)
    mesh.fixed_mask = sd.fixed0.copy()
    return mesh, cfg, sd


@pytest.mark.parametrize("energy", ["FCR", "SNH", "SNHWL"])
def test_dot_converges_and_matches_newton(energy):
    mesh, cfg, sd = _scene("stretch", energy)

    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    dot = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float64), sd)
    st = dot.init_state()

    plan1 = partition.build_plan(mesh, 1, pad_elem_to=16, pad_n3_to=48)
    newton = NewtonStepper(System(mesh, cfg, plan1, dtype=jnp.float64), sd)
    sn = newton.init_state()

    tol = dot.system.target_g_res(1e-5)
    for _ in range(3):
        st, (stats, sys_e) = dot.step(st)
        sn, (stats_n, sys_e_n) = newton.step(sn)

    assert bool(jnp.isfinite(st.x).all())
    # both converged: to tolerance, or via the relative-energy-decrease
    # early stop (allowEDecRelTol, Optimizer.cpp:856-862 — dominant for SNH
    # whose rest energy has a large constant offset)
    assert float(stats.sqn_g) < 10 * tol or bool(stats.stopped)
    assert float(stats_n.sqn_g) < 10 * tol or bool(stats_n.stopped)
    # same physics: system energies and trajectories agree (the SNH
    # family's large constant rest-energy offset makes the 1e-3
    # relative-decrease stop positionally coarser, hence the wider band)
    np.testing.assert_allclose(float(sys_e), float(sys_e_n), rtol=1e-3)
    assert float(jnp.abs(st.x - sn.x).max()) < (2e-3 if energy == "FCR"
                                                else 6e-3)


def test_dot_twist_with_inversion_robustness():
    """Twist drives elements toward inversion; the SPD projection and
    flip-SVD must keep the solve stable."""
    mesh, cfg, sd = _scene("twist")
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    dot = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float64), sd)
    st = dot.init_state()
    for _ in range(5):
        st, (stats, _) = dot.step(st)
    assert bool(jnp.isfinite(st.x).all())
    assert float(stats.sqn_g) < 10 * dot.system.target_g_res(1e-5)


def test_hang_under_gravity_energy_dissipation():
    """Backward Euler dissipates: with only gravity forcing, the system
    energy (elastic + kinetic + potential) must not increase step over
    step (reference oracle: sysE log, Optimizer.cpp:1310-1328)."""
    mesh, cfg, sd = _scene("hang")
    plan = partition.build_plan(mesh, 2, pad_elem_to=16, pad_n3_to=48)
    dot = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float64), sd)
    st = dot.init_state()
    prev = None
    for _ in range(5):
        st, (stats, sys_e) = dot.step(st)
        e = float(sys_e)
        if prev is not None:
            assert e <= prev + 1e-6 * abs(prev)
        prev = e


def test_f32_pipeline_runs():
    """The GPU production dtype must run the same scene without NaNs and
    converge to the (f32-appropriate) tolerance."""
    mesh, cfg, sd = _scene("stretch")
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)
    dot = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float32), sd)
    st = dot.init_state()
    for _ in range(3):
        st, (stats, _) = dot.step(st)
    assert bool(jnp.isfinite(st.x).all())
    assert float(stats.sqn_g) < 10 * dot.system.target_g_res(1e-5)


def test_stale_h0_still_converges_to_same_physics():
    """h0Refresh policy (dot_tpu extension): skipping the end-of-step H0
    rebuild leaves a stale preconditioner, which may cost extra L-BFGS
    iterations but must converge to the same tolerance and physics (the
    reference's own H0 is already frozen within each step,
    DOTTimeStepper.cpp:343 — this extends the freeze across steps)."""
    mesh, cfg, sd = _scene("twist")
    plan = partition.build_plan(mesh, 4, pad_elem_to=16, pad_n3_to=48)

    fresh = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float64), sd)
    stale = DOTStepper(System(mesh, cfg, plan, dtype=jnp.float64), sd)
    sf, ss = fresh.init_state(), stale.init_state()
    tol = fresh.system.target_g_res(1e-5)
    for k in range(6):
        sf, (stf, ef) = fresh.step(sf)
        # refresh only after the first step; frames 1..5 run on frame-0
        # factors
        ss, (sts, es) = stale.step(ss, refresh=(k == 0))
    assert float(stf.sqn_g) < 10 * tol or bool(stf.stopped)
    assert float(sts.sqn_g) < 10 * tol or bool(sts.stopped)
    # same minimum within the tolerance-scale trajectory band: each step
    # stops anywhere inside the rel-tol ball, so a different (stale)
    # preconditioner picks a different point in the ball every frame and
    # the gap accumulates over the 6 frames — O(1e-3) relative is the
    # honest band for tol=1e-5 paths, not bit-equality
    np.testing.assert_allclose(float(es), float(ef), rtol=5e-3)
    assert float(jnp.abs(ss.x - sf.x).max()) < 5e-3
