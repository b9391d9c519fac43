"""Projected-Newton time stepper — the reference's gold-standard baseline
(Optimizer base class: src/TimeStepper/Optimizer.cpp:702-881).

Every inner iteration rebuilds the SPD-projected Hessian at the current
iterate and refactorizes (needRefactorize == true for both shipped
materials), then solves H p = -g exactly. Here "the matrix" is the P=1
dense assembly of the shared System, factorized by one (big) Cholesky —
no global sparse matrix, matching the framework's design.

Intended for parity/baseline runs on small/medium meshes; DOT is the
production path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .core import (System, SimState, StepStats, StaticPytree, F64,
                   INNER_ITER_CAP, REL_EDEC_STOP, STATS_CAP)
from .dot import line_search, _vdot
from ..scripts import make_step_fn


class NewtonStepper(StaticPytree):
    name = "Newton"

    def __init__(self, system: System, script_data, warm_start_opt=2):
        assert system.n_parts == 1, "Newton uses the whole-mesh dense system"
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = make_step_fn(script_data, system.dt)
        # the stepper is a pytree passed as the first jit ARGUMENT (see
        # StaticPytree); the state pytree is donated: without donation the
        # previous step's factors stay alive alongside the new ones and
        # the rebuild temporaries, OOMing large dense scenes (monkey18K)
        self._step = jax.jit(type(self)._step_impl, donate_argnums=(1,))

    def _step_impl(self, state: SimState, tol):
        sys = self.system
        anim = self._anim

        x, fixed, vel_sign, released, _bc = anim(
            state.x, state.fixed, state.vel_sign, state.released)

        x = sys.warm_start(self.warm_start_opt, x, state.v,
                           state.dx_elastic, fixed,
                           x_tilta=state.x_tilta)
        F, U, s, V = sys.fsvd(x)
        e = sys.energy(x, state.x_tilta, s)
        g = sys.gradient(x, state.x_tilta, fixed, F, U, s, V)
        sqn_g = _vdot(g, g)

        rows = jnp.zeros((STATS_CAP, 3), F64)
        rows = rows.at[0].set(jnp.stack([jnp.zeros((), F64),
                                         e.astype(F64), sqn_g.astype(F64)]))

        def cond(c):
            (x, e, g, sqn_g, it, stopped, n_ls, rows, svd) = c
            return jnp.logical_and(
                sqn_g > tol,
                jnp.logical_and(it < INNER_ITER_CAP,
                                jnp.logical_not(stopped)))

        def body(c):
            (x, e, g, sqn_g, it, stopped, n_ls, rows, svd) = c
            F, U, s, V = svd
            # refactorize at the current iterate (solve_oneStep,
            # Optimizer.cpp:702-749)
            elem_h = sys.element_hessians(U, s, V)
            Hd = sys.assemble_subdomains(elem_h, fixed)
            L, d = sys.factorize(Hd)
            p = sys.h0_apply(L, d, -g)

            x_new, e_new, svd_new, alpha, halv, failed = line_search(
                sys, x, p, e, state.x_tilta, jnp.asarray(1.0, sys.dtype),
                F0=F)
            stopped = jnp.logical_or(failed,
                                     (e - e_new) / e < REL_EDEC_STOP)
            x_new = jnp.where(failed, x, x_new)
            e_new = jnp.where(failed, e, e_new)

            Fn, Un, sn, Vn = svd_new
            g_new = sys.gradient(x_new, state.x_tilta, fixed,
                                 Fn, Un, sn, Vn)
            sqn_g = _vdot(g_new, g_new)
            it = it + 1
            row = jnp.stack([alpha.astype(F64), e_new.astype(F64),
                             sqn_g.astype(F64)])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (x_new, e_new, g_new, sqn_g, it, stopped,
                    n_ls + halv, rows, svd_new)

        init = (x, e, g, sqn_g, jnp.asarray(0, jnp.int32),
                jnp.asarray(False), jnp.asarray(0, jnp.int32), rows,
                (F, U, s, V))
        (x, e, g, sqn_g, it, stopped, n_ls, rows, svd) = \
            jax.lax.while_loop(cond, body, init)

        new_state = state._replace(fixed=fixed, vel_sign=vel_sign,
                                   released=released)
        new_state = sys.be_update(new_state, x)

        _, _, s_fin, _ = sys.fsvd(x)
        sys_e = sys.system_energy(x, state.x_n, s_fin)
        stats = StepStats(energy=e, sqn_g=sqn_g, inner_iters=it,
                          ls_halvings=n_ls, stopped=stopped, rows=rows)
        return new_state, (stats, sys_e)

    def init_state(self):
        return self.system.init_state(self.script_data)

    def restore(self, x, v, dxe):
        """Resumed-run state (Optimizer.cpp:126-177). Newton refactorizes
        at every inner iteration, so the init-time factors are never read
        and need no refresh here."""
        sys = self.system
        st = self.init_state()
        xj = jnp.asarray(x, sys.dtype)
        vj = jnp.asarray(v, sys.dtype)
        return st._replace(x=xj, x_n=jnp.copy(xj), v=vj,
                           x_tilta=sys.compute_x_tilta(xj, vj, st.fixed),
                           dx_elastic=jnp.asarray(dxe, sys.dtype))

    def step(self, state, rel_tol=1.0e-5):
        tol = jnp.asarray(self.system.target_g_res(rel_tol), F64)
        from .core import dedupe_for_donation
        return self._step(self, dedupe_for_donation(state), tol)
