"""Shared quasi-Newton (L-BFGS) stepping machinery.

One implementation of the two-loop recursion + Armijo line search + curvature
history + Backward-Euler update, parameterized by the implicit initializer
H0 (the only thing that differs between DOT and the LBFGS-{PD,H,HI,JH}
variants — reference: DOTTimeStepper.cpp:383-504, LBFGSTimeStepper.cpp:341-448).

Subclass contract:
  h0_apply(state, q)          -> search direction from -gradient-like q
  end_of_step(sys, x, fixed, state) -> state with refreshed H0 factors
  alpha0(sys, state, g, p)    -> initial line-search step (DOT: clamped
                                 -g.p/p^T H p, others: 1.0)
  on_bc_change(sys, x, fixed, state) -> state (refactor on Dirichlet change)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .core import (System, SimState, StepStats, StaticPytree, F64,
                   HIGHEST, LBFGS_HISTORY, INNER_ITER_CAP, LINE_SEARCH_CAP,
                   REL_EDEC_STOP, STATS_CAP)
from ..scripts import make_step_fn


def _vdot(a, b):
    # reduction in the field dtype (core module docstring: precision)
    return jnp.vdot(a.ravel(), b.ravel(), precision=HIGHEST)


def line_search(system: System, x0, p, e0, x_tilta, alpha0, F0=None,
                Fp=None):
    """Backtracking Armijo (c = 0: accept any non-increase) from alpha0
    (reference: Optimizer::lineSearch, Optimizer.cpp:751-881). Returns
    (x, E, accepted-trial SVD, alpha, halvings, failed).

    Fast path: F(x0 + a p) = F0 + a F(p) (F is linear in positions) and
    the inertia term is an exact quadratic in a, so each trial is purely
    elementwise (flip-SVD + Psi) — no gathers, no (nV, 3) traffic. Pass
    F0 (the deformation gradients at x0, e.g. from the previous accepted
    trial) to skip even the x0 gather.

    Dimension-generic: the flip-SVD is dispatched through
    system.svd_flip (3x3 SoA at dim 3, 2x2 at dim 2), so the same loop
    drives the 2D instantiation (dim2.System2D)."""
    if F0 is None:
        F0 = system.defgrad(x0)
    if Fp is None:
        Fp = system.defgrad(p)
    c0, c1, c2 = system.inertia_quad(x0, p, x_tilta)

    def trial(alpha):
        F = tuple(f0 + alpha * fp for f0, fp in zip(F0, Fp))
        U, s, V = system.svd_flip(F)
        e = system.elastic_energy_sigma(s) + (c0 + alpha * (c1 + alpha * c2))
        return (F, U, s, V), e

    svd1, e1 = trial(alpha0)

    # NaN-safe acceptance: `e > e0` is False for NaN (the reference's
    # C++ comparison has the same hazard and would accept a NaN state);
    # treat non-finite trial energies as "keep halving".
    def reject(e):
        return jnp.logical_not(e <= e0)

    def cond(c):
        alpha, e, _, k = c
        return jnp.logical_and(reject(e), k < LINE_SEARCH_CAP)

    def body(c):
        alpha, _, _, k = c
        alpha = alpha * 0.5
        svd, e = trial(alpha)
        return (alpha, e, svd, k + 1)

    alpha, e, svd, k = jax.lax.while_loop(
        cond, body, (alpha0, e1, svd1, jnp.asarray(0, jnp.int32)))
    failed = reject(e)
    x = x0 + alpha * p
    return x, e, svd, alpha, k, failed


class QuasiNewtonStepper(StaticPytree):
    name = "LBFGS"

    def __init__(self, system: System, script_data, warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = make_step_fn(script_data, system.dt)
        # The stepper (and its System) is itself a pytree and is passed
        # as the first jit ARGUMENT — the step program carries no plan
        # constants. The state pytree is donated: without donation the
        # previous step's factors stay alive alongside the new ones and
        # the rebuild temporaries, OOMing large scenes (monkey18K).
        self._step = jax.jit(type(self)._step_impl, donate_argnums=(1,))

    # ---- subclass hooks ------------------------------------------------
    def h0_apply(self, state, q):
        raise NotImplementedError

    def end_of_step(self, sys, x, fixed, state):
        return state

    def on_bc_change(self, sys, x, fixed, state):
        return self.end_of_step(sys, x, fixed, state)

    def alpha0_and_fp(self, sys, state, g, p):
        """(initial line-search step, F(p)) — one hook so steppers with an
        alpha-init (DOT) can share the corner gather of p between the
        quadratic form and the direction deformation gradients."""
        return jnp.asarray(1.0, sys.dtype), sys.defgrad(p)

    # --------------------------------------------------------------------
    def _two_loop(self, state, g, bufs):
        """Two-loop recursion around the implicit H0 apply
        (reference: DOTTimeStepper.cpp:386-467). Buffers are ordered
        oldest..newest along axis 0 with a validity mask.

        Batched formulation: the textbook recursion is 2m dependent
        full-vector reductions (each a serialized pass over the field);
        here every needed inner product is derived from THREE batched
        contractions — sq = S q0, G = S T^T, tr = T (H0 q) — plus O(m^2)
        scalar recurrences, because q_i and r_i only ever change by
        linear combinations of the history vectors. Algebraically
        identical to the recursion (same floating-point class: all big
        reductions stay in the field dtype)."""
        lb_s, lb_t, lb_rho, lb_valid = bufs
        m = LBFGS_HISTORY
        n = lb_s.shape[1] * lb_s.shape[2]
        S = lb_s.reshape(m, n)
        T = lb_t.reshape(m, n)
        q0 = -g.reshape(n)
        dt_ = q0.dtype
        hi = HIGHEST      # exact f32 products: these scalars drive
        # convergence decisions
        sq = jnp.matmul(S, q0, precision=hi)            # (m,)  s_i . q0
        G = jax.lax.dot_general(S, T, (((1,), (1,)), ((), ())),
                                preferred_element_type=dt_,
                                precision=hi)           # (m, m) s_i . t_j
        inv_rho = jnp.where(lb_valid > 0, 1.0 / lb_rho, 0.0) * lb_valid
        # loop 1 (newest -> oldest): q_i = q0 - sum_{j>i} k_j t_j, so
        # s_i . q_i = sq_i - sum_{j>i} k_j G[i, j]
        ks = [None] * m
        for i in reversed(range(m)):
            si_q = sq[i]
            for j in range(i + 1, m):
                si_q = si_q - ks[j] * G[i, j]
            ks[i] = si_q * inv_rho[i]
        k = jnp.stack(ks)                               # (m,)
        q = q0 - jnp.matmul(k, T, precision=hi)
        r = self.h0_apply(state, q.reshape(g.shape)).reshape(n)
        tr = jnp.matmul(T, r, precision=hi)             # (m,)  t_i . (H0 q)
        # loop 2 (oldest -> newest): r_i = H0q + sum_{j<i} c_j s_j, so
        # t_i . r_i = tr_i + sum_{j<i} c_j G[j, i]
        cs = [None] * m
        for i in range(m):
            ti_r = tr[i]
            for j in range(i):
                ti_r = ti_r + cs[j] * G[j, i]
            cs[i] = ks[i] - ti_r * inv_rho[i]
        r = r + jnp.matmul(jnp.stack(cs), S, precision=hi)
        return r.reshape(g.shape)

    @staticmethod
    def _push_history(bufs, s_new, t_new, rho_new):
        """Append the curvature pair only when t.s > 0
        (DOTTimeStepper.cpp:474-494)."""
        lb_s, lb_t, lb_rho, lb_valid = bufs
        accept = rho_new > 0.0

        def push(buf, new):
            return jnp.concatenate([buf[1:], new[None]], axis=0)

        lb_s = jnp.where(accept, push(lb_s, s_new), lb_s)
        lb_t = jnp.where(accept, push(lb_t, t_new), lb_t)
        lb_rho = jnp.where(accept, push(lb_rho, rho_new), lb_rho)
        lb_valid = jnp.where(accept,
                             push(lb_valid, jnp.ones((), lb_valid.dtype)),
                             lb_valid)
        return lb_s, lb_t, lb_rho, lb_valid

    # --------------------------------------------------------------------
    def _step_impl(self, state: SimState, tol, refresh=True):
        """One full time step. Called through jit with `self` as a pytree
        argument (see StaticPytree), so inside the trace `self` and
        `self.system` carry tracer leaves for every static buffer — no
        plan constants are baked into the compiled program.

        `refresh` (traced bool) gates the end-of-step H0 rebuild: the
        reference refactorizes every time step (DOTTimeStepper.cpp:343)
        because a CHOLMOD refactor is cheap next to its iteration cost;
        here the rebuild+factorization can be a large share of the
        frame, so the Simulator may extend the frozen preconditioner's
        lifetime across frames (config key h0Refresh).
        The convergence tolerance is untouched — staleness can only
        cost extra L-BFGS iterations, never accuracy."""
        sys = self.system
        sd = self.script_data
        anim = self._anim

        x, fixed, vel_sign, released, bc_changed = anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state = state._replace(fixed=fixed, vel_sign=vel_sign,
                               released=released)

        if sd.has_bc_change:
            # Dirichlet set changed mid-run -> refresh H0 with new masks
            # (reference: updatePrecondMtrAndFactorize)
            state = jax.lax.cond(
                bc_changed,
                lambda st: self.on_bc_change(sys, x, fixed, st),
                lambda st: st, state)

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

        # fresh history each time step (DOTTimeStepper.cpp:275-285)
        bufs = (jnp.zeros_like(state.lb_s), jnp.zeros_like(state.lb_t),
                jnp.ones_like(state.lb_rho), jnp.zeros_like(state.lb_valid))

        def cond(c):
            (x, e, g, Fc, sqn_g, bufs, it, stopped, n_ls, rows) = c
            return jnp.logical_and(
                sqn_g > tol,
                jnp.logical_and(it < INNER_ITER_CAP,
                                jnp.logical_not(stopped)))

        def body(c):
            (x, e, g, Fc, sqn_g, bufs, it, stopped, n_ls, rows) = c
            p = self._two_loop(state, g, bufs)
            a0, Fp = self.alpha0_and_fp(sys, state, g, p)

            # F at the current x is carried from the previous accepted
            # trial, so the line search gathers only p (shared with
            # the alpha-init via alpha0_and_fp)
            x_new, e_new, svd, alpha, halv, failed = line_search(
                sys, x, p, e, state.x_tilta, a0, F0=Fc, Fp=Fp)
            # relative-decrease early stop (Optimizer.cpp:856-862)
            stopped = jnp.logical_or(failed,
                                     (e - e_new) / e < REL_EDEC_STOP)
            x_new = jnp.where(failed, x, x_new)
            e_new = jnp.where(failed, e, e_new)

            Fn, Un, sn, Vn = svd
            g_new = sys.gradient(x_new, state.x_tilta, fixed,
                                 Fn, Un, sn, Vn)
            # on failure x reverted to x0, so keep the matching
            # pre-step gradient (the trial SVD would be inconsistent);
            # t_vec = 0 then also skips the history push via rho = 0
            g_new = jnp.where(failed, g, g_new)
            Fc = jax.tree.map(lambda a, b: jnp.where(failed, a, b),
                              Fc, Fn)

            s_vec = alpha * p
            t_vec = g_new - g
            rho = _vdot(t_vec, s_vec)
            bufs = self._push_history(bufs, s_vec, t_vec, rho)

            sqn_g = _vdot(g_new, g_new)
            it = it + 1
            row = jnp.stack([alpha.astype(F64), e_new.astype(F64),
                             sqn_g.astype(F64)])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (x_new, e_new, g_new, Fc, sqn_g, bufs, it, stopped,
                    n_ls + halv, rows)

        init = (x, e, g, F, sqn_g, bufs, jnp.asarray(0, jnp.int32),
                jnp.asarray(False), jnp.asarray(0, jnp.int32), rows)
        (x, e, g, _F, sqn_g, bufs, it, stopped, n_ls, rows) = \
            jax.lax.while_loop(cond, body, init)

        state = state._replace(lb_s=bufs[0], lb_t=bufs[1],
                               lb_rho=bufs[2], lb_valid=bufs[3])
        state = jax.lax.cond(
            refresh,
            lambda st: self.end_of_step(sys, x, fixed, st),
            lambda st: st, state)
        x_n_prev = state.x_n  # before the BE update rebinds it
        state = sys.be_update(state, x)

        _, _, s_fin, _ = sys.fsvd(x)
        sys_e = sys.system_energy(x, x_n_prev, s_fin)
        stats = StepStats(energy=e, sqn_g=sqn_g, inner_iters=it,
                          ls_halvings=n_ls, stopped=stopped, rows=rows)
        return state, (stats, sys_e)

    # --------------------------------------------------------------------
    def init_state(self):
        return self.system.init_state(self.script_data)

    def restore(self, x, v, dxe):
        """State for a resumed run (reference: Optimizer.cpp:126-177).

        Positions/velocity/dx_Elastic come from the status file; H0
        factors are refreshed at the restored positions via the same
        end_of_step hook each stepper already implements (steppers with
        x-independent factors, e.g. LBFGS-PD, keep their init-time one).
        """
        sys = self.system
        st = self.init_state()
        xj = jnp.asarray(x, sys.dtype)
        vj = jnp.asarray(v, sys.dtype)
        st = st._replace(x=xj, x_n=xj, v=vj,
                         x_tilta=sys.compute_x_tilta(xj, vj, st.fixed),
                         dx_elastic=jnp.asarray(dxe, sys.dtype))
        # jit the refresh (see System.rebuild_h0)
        return _refresh_jit(self, xj, st.fixed, st)

    def step(self, state, rel_tol=1.0e-5, refresh=True):
        from .core import dedupe_for_donation
        tol = jnp.asarray(self.system.target_g_res(rel_tol), F64)
        return self._step(self, dedupe_for_donation(state), tol,
                          jnp.asarray(bool(refresh)))


@jax.jit
def _refresh_jit(stepper, x, fixed, state):
    return stepper.end_of_step(stepper.system, x, fixed, state)
