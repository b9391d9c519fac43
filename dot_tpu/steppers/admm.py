"""ADMM-PD time stepper: per-element consensus ADMM on z ~= Dx (the
deformation-gradient copy), Overby-style fixed weights.

Reference: src/TimeStepper/ADMMTimeStepper.cpp —
  precompute      :109-201 (global M + D^T W D prefactorized once)
  fullyImplicit   :213-305 (xHat, u=0, z=Dx, iterate local/global, ||g||^2 test)
  zuUpdate_SV     :379-479 (per-element <=100-iter projected Newton on the
                            3-dof singular-value problem, then dual update)
  xUpdate         :557-627 (rhs = M xHat + D^T W (z - u), Dirichlet offsets,
                            dim-separated prefactorized solve)
  initWeights     :655-703 (OVERBYAPD: w_e = dt^2 * bulkModulus * vol_e)

Mapping: the local step is an embarrassingly-parallel batched 3-dof
Newton (vmapped while_loop over all elements at once); the global step is
one dense triangular-solve pair against the prefactored scalar matrix; the
Dirichlet offset term is applied matrix-free (A x_fixed via the same
element scatter used for the rhs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .core import System, StepStats, StaticPytree, F64, STATS_CAP
from .quasi_newton import _vdot
from ..kernels import soa
from ..materials import bulk_modulus
from ..scripts import make_step_fn

LOCAL_MAX_ITER = 100  # reference fail-safe (ADMMTimeStepper.cpp:385)
LOCAL_LS_CAP = 40


class ADMMState(NamedTuple):
    x: jax.Array
    x_n: jax.Array
    v: jax.Array
    x_tilta: jax.Array
    dx_elastic: jax.Array
    fixed: jax.Array
    vel_sign: jax.Array
    released: jax.Array
    chol: jax.Array    # (nV, nV) factor of equilibrated M + D^T W D
    equil: jax.Array   # (nV,)


def _solve_sym3(h6, g):
    """Solve the SPD 3x3 system H p = g via the adjugate (batched scalars)."""
    a, b, c, d, e, f = h6  # (00, 01, 02, 11, 12, 22)
    det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
    inv_det = 1.0 / det
    i00 = (d * f - e * e) * inv_det
    i01 = (c * e - b * f) * inv_det
    i02 = (b * e - c * d) * inv_det
    i11 = (a * f - c * c) * inv_det
    i12 = (b * c - a * e) * inv_det
    i22 = (a * d - b * b) * inv_det
    return (i00 * g[0] + i01 * g[1] + i02 * g[2],
            i01 * g[0] + i11 * g[1] + i12 * g[2],
            i02 * g[0] + i12 * g[1] + i22 * g[2])


def _solve_sym2(h3, g):
    """Solve the SPD 2x2 system H p = g (batched scalars)."""
    a, b, c = h3  # (00, 01, 11)
    inv_det = 1.0 / (a * c - b * b)
    return ((c * g[0] - b * g[1]) * inv_det,
            (a * g[1] - b * g[0]) * inv_det)


class ADMMPDStepper(StaticPytree):
    name = "ADMM"
    # dimension constants + kernel hooks; ADMMPD2D overrides them (the
    # reference stepper is dimension-templated, ADMMTimeStepper.cpp:736)
    DIM = 3
    N_CORNER = 4
    SIG_DIAG = (0, 3, 5)      # diagonal entries of the packed sym Hessian

    def __init__(self, system: System, script_data, max_iter=1000,
                 warm_start_opt=2):
        # reference forces warmStart 2 for ADMM-PD (Config.cpp:196-201)
        self.system = system
        self.script_data = script_data
        self.max_iter = max_iter
        self._anim = make_step_fn(script_data, system.dt)
        sys = system
        # Overby weights: dt^2 * bulkModulus * vol (zero on padded elems)
        self.w_e = (jnp.asarray(sys.dt_sq, sys.dtype) * self._vol()
                    * self._kappa())
        # the stepper is a pytree passed as the first jit ARGUMENT (see
        # StaticPytree); the state pytree is donated so the previous
        # step's buffers are reclaimed before the new ones materialize
        self._step = jax.jit(type(self)._step_impl, donate_argnums=(1,))

    def build_factor(self, fixed):
        """Prefactored global matrix M + D^T W D (eager entry)."""
        return self.system.build_pd_factor(fixed, self.w_e)

    # ---- dimension hooks ------------------------------------------------
    def _vol(self):
        return self.system.vol_w

    def _mat(self):
        return self.system.mat_soa

    def _kappa(self):
        """Bulk modulus (Energy::getBulkModulus, Energy.cpp:1273-1277)."""
        return bulk_modulus(self.system.u_e, self.system.lam_e)

    def _D_rows(self):
        return self.system.D_soa

    def _defgrad(self, x):
        sys = self.system
        return soa.defgrad_soa(x.T, sys.conn_cols, sys.g9)

    @staticmethod
    def _svd(f):
        return soa.svd3_flip_soa(f)

    @staticmethod
    def _make_pd(h):
        return soa.make_pd3_soa(h)

    @staticmethod
    def _solve_sym(h, g):
        return _solve_sym3(h, g)

    @staticmethod
    def _z_usv(U, s, V):
        """z = U diag(sigma) V^T as a dim^2 SoA tuple."""
        return tuple(
            U[3 * i + 0] * s[0] * V[3 * j + 0]
            + U[3 * i + 1] * s[1] * V[3 * j + 1]
            + U[3 * i + 2] * s[2] * V[3 * j + 2]
            for i in range(3) for j in range(3))

    # ------------------------------------------------------------------
    def _local_step(self, fD, uDz):
        """Batched DIM-dof singular-value-space projected Newton
        (reference: zuUpdate_SV). fD/uDz are matD tuples (Dx and dual u);
        returns (z_new matD, du matD)."""
        sys = self.system
        mat = self._mat()
        D = self.DIM
        dxu = tuple(fD[k] + uDz[k] for k in range(D * D))
        U, s_hat, V = self._svd(dxu)
        w = self.w_e
        vol_dtsq = self._vol() * jnp.asarray(sys.dt_sq, sys.dtype)
        u_lame, lam = sys.u_e, sys.lam_e

        def energy(s):
            d = tuple(s_hat[i] - s[i] for i in range(D))
            return (mat.psi(s, u_lame, lam) * vol_dtsq
                    + 0.5 * w * sum(di * di for di in d))

        def grad(s):
            g = mat.dpsi(s, u_lame, lam)
            return tuple(g[i] * vol_dtsq - w * (s_hat[i] - s[i])
                         for i in range(D))

        def hess(s):
            h = self._make_pd(mat.d2psi(s, u_lame, lam))
            h = list(x * vol_dtsq for x in h)
            for k in self.SIG_DIAG:
                h[k] = h[k] + w
            return tuple(h)

        def newton_body(carry):
            s, e0, active, it = carry
            g = grad(s)
            p = self._solve_sym(hess(s), tuple(-x for x in g))

            def ls_body(c):
                alpha, e, k = c
                alpha = jnp.where(e > e0, alpha * 0.5, alpha)
                s_try = tuple(s[i] + alpha * p[i] for i in range(D))
                return alpha, energy(s_try), k + 1

            def ls_cond(c):
                alpha, e, k = c
                return jnp.logical_and(jnp.any(e > e0), k < LOCAL_LS_CAP)

            one = jnp.ones_like(e0)
            s1 = tuple(s[i] + p[i] for i in range(D))
            alpha, e, _ = jax.lax.while_loop(
                ls_cond, ls_body, (one, energy(s1), jnp.asarray(0, jnp.int32)))
            s_new = tuple(jnp.where(active, s[i] + alpha * p[i], s[i])
                          for i in range(D))
            e_new = jnp.where(active, e, e0)
            # local convergence: |(E0-E)/E0| < 1e-3 * alpha (zuUpdate_SV:439)
            still = jnp.abs((e0 - e_new) / jnp.where(e0 == 0, 1.0, e0)) \
                >= 1.0e-3 * alpha
            active = jnp.logical_and(active, still)
            return s_new, e_new, active, it + 1

        def newton_cond(carry):
            _, _, active, it = carry
            return jnp.logical_and(jnp.any(active), it < LOCAL_MAX_ITER)

        active0 = jnp.ones_like(s_hat[0], bool)
        s0 = s_hat
        s_fin, _, _, _ = jax.lax.while_loop(
            newton_cond, newton_body,
            (s0, energy(s0), active0, jnp.asarray(0, jnp.int32)))

        z = self._z_usv(U, s_fin, V)
        du = tuple(dxu[k] - uDz[k] - z[k]
                   for k in range(D * D))  # Dx - z
        return z, du

    # ------------------------------------------------------------------
    def _apply_A(self, x):
        """Matrix-free (M + D^T W D) x — used for the Dirichlet offsets."""
        sys = self.system
        D, NC = self.DIM, self.N_CORNER
        f = self._defgrad(x)                            # linear in x
        Dr = self._D_rows()
        # per-corner contributions: sum_j D[c][j] * w * F[i][j]
        ge = [[sum(Dr[c][j] * (self.w_e * f[D * i + j])
                   for j in range(D)) for i in range(D)] for c in range(NC)]
        out = self._scatter(ge)
        return out + sys.mass[:, None] * x

    def _scatter(self, ge):
        """(nV, 3) scatter of per-corner, per-dim element values ge[c][i]
        (3D: sorted-segment scatter; the 2D subclass overrides)."""
        sys = self.system
        cols = []
        for d in range(3):
            vals = jnp.stack([ge[c][d] for c in range(4)],
                             axis=1).reshape(-1)[sys.scat_perm]
            acc = jax.ops.segment_sum(vals, sys.scat_segids,
                                      num_segments=sys.n_vert + 1,
                                      indices_are_sorted=True)
            cols.append(acc[:sys.n_vert])
        return jnp.stack(cols, axis=-1)

    # ------------------------------------------------------------------
    def _step_impl(self, state: ADMMState, tol):
        sys = self.system
        anim = self._anim
        sd = self.script_data

        x, fixed, vel_sign, released, bc_changed = anim(
            state.x, state.fixed, state.vel_sign, state.released)
        L, dd = state.chol, state.equil
        if sd.has_bc_change:
            L, dd = jax.lax.cond(
                bc_changed,
                lambda: sys._build_pd_factor(fixed, self.w_e),
                lambda: (L, dd))

        # xHat warm start (forced option 2)
        x = sys.warm_start(2, x, state.v, state.dx_elastic, fixed)
        m_xhat = sys.mass[:, None] * x
        free = jnp.logical_not(fixed)[:, None].astype(sys.dtype)
        x_fix = x * (1.0 - free)
        # Dirichlet offset: -(A x_fixed) on free rows (offset_fixVerts)
        offset = self._apply_A(x_fix)

        D, NC = self.DIM, self.N_CORNER
        DD = D * D
        f9 = self._defgrad(x)
        z = f9
        u9 = tuple(jnp.zeros_like(f9[0]) for _ in range(DD))

        F0, U0, s0, V0 = sys.fsvd(x)
        e = sys.energy(x, state.x_tilta, s0)
        g = sys.gradient(x, state.x_tilta, fixed, F0, U0, s0, V0)
        sqn_g = _vdot(g, g)
        rows = jnp.zeros((STATS_CAP, 3), F64)
        rows = rows.at[0].set(jnp.stack([jnp.zeros((), F64),
                                         e.astype(F64), sqn_g.astype(F64)]))

        def cond(c):
            (x, f9, z, u9, e, sqn_g, it, rows) = c
            return jnp.logical_and(sqn_g > tol, it < self.max_iter)

        def body(c):
            (x, f9, z, u9, e, sqn_g, it, rows) = c
            # local step + dual update
            z, du = self._local_step(f9, u9)
            u9 = tuple(u9[k] + du[k] for k in range(DD))
            # global step: rhs = M xHat + D^T W (z - u) - offsets
            Dr = self._D_rows()
            zmu = [[self.w_e * (z[D * i + j] - u9[D * i + j])
                    for j in range(D)] for i in range(D)]
            ge = [[sum(Dr[c][j] * zmu[i][j] for j in range(D))
                   for i in range(D)] for c in range(NC)]
            rhs = (m_xhat + self._scatter(ge) - offset) * free \
                + x * (1.0 - free)
            x = sys.pd_solve(L, dd, rhs)
            x = x * free + x_fix  # exact Dirichlet rows

            f9 = self._defgrad(x)
            # convergence check on the true gradient (redoSVD)
            F, U, s, V = sys.fsvd(x)
            g = sys.gradient(x, state.x_tilta, fixed, F, U, s, V)
            e = sys.energy(x, state.x_tilta, s)
            sqn_g = _vdot(g, g)
            it = it + 1
            row = jnp.stack([jnp.ones((), F64), e.astype(F64),
                             sqn_g.astype(F64)])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (x, f9, z, u9, e, sqn_g, it, rows)

        init = (x, f9, z, u9, e, sqn_g, jnp.asarray(0, jnp.int32), rows)
        (x, f9, z, u9, e, sqn_g, it, rows) = \
            jax.lax.while_loop(cond, body, init)

        state = state._replace(fixed=fixed, vel_sign=vel_sign,
                               released=released, chol=L, equil=dd)
        x_n_prev = state.x_n
        # BE update
        dx_el = x - state.x_tilta
        v = (x - state.x_n) / sys.dt
        x_tilta = sys._compute_x_tilta(x, v, fixed)
        state = state._replace(x=x,
                               x_n=jax.lax.optimization_barrier(x),
                               v=v, dx_elastic=dx_el,
                               x_tilta=x_tilta)
        _, _, s_fin, _ = sys.fsvd(x)
        sys_e = sys.system_energy(x, x_n_prev, s_fin)
        stats = StepStats(energy=e, sqn_g=sqn_g, inner_iters=it,
                          ls_halvings=jnp.asarray(0, jnp.int32),
                          stopped=(it >= self.max_iter), rows=rows)
        return state, (stats, sys_e)


    # ------------------------------------------------------------------
    def init_state(self):
        sys = self.system
        sd = self.script_data
        dtype = sys.dtype
        x = jnp.asarray(sd.x0, dtype)
        fixed = jnp.asarray(sd.fixed0)
        v = jnp.zeros((sys.n_vert, 3), dtype)
        L, d = self.build_factor(fixed)
        return ADMMState(
            x=x, x_n=jnp.copy(x), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=jnp.zeros((sys.n_vert, 3), dtype),
            fixed=fixed, vel_sign=jnp.asarray(1.0, dtype),
            released=jnp.asarray(False), chol=L, equil=d)

    def restore(self, x, v, dxe):
        """Resumed-run state (Optimizer.cpp:126-177). The prefactored
        global matrix M + D^T W D is position-independent (Overby
        weights at rest shape), so the init-time factor is kept."""
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
