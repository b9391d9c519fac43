"""The LBFGS-{PD, H, HI, JH} time steppers — L-BFGS with alternative
implicit initializers H0 (reference: src/TimeStepper/LBFGSTimeStepper.cpp,
D0Type at LBFGSTimeStepper.hpp:21-27):

  PD : H0 = M + dt^2 D^T W D with w_e = vol_e (2 mu_e + lambda_e), a fixed
       scalar (per-coordinate) SPD matrix built once and factorized once
       (precompute, LBFGSTimeStepper.cpp:113-194); dim-separated solves.
  H  : H0 = full start-of-step Hessian, refactorized after each time step
       (LBFGSTimeStepper.cpp:302-307). Here: the P=1 dense system.
  HI : reference uses an incomplete Cholesky of the same matrix
       (LBFGSTimeStepper.cpp:214-233). There is no batched incomplete
       sparse factorization here; the same role (cheaper, approximate factor of
       the same matrix) is played by a reduced-precision (bfloat16) dense
       Cholesky — documented substitution.
  JH : H0 = block-Jacobi Hessian over a disjoint NODE partition, per-block
       dense factors (LBFGSTimeStepper.cpp:70-95, 235-262, 380-394). Here:
       the subdomain machinery over a node-partition plan (dup == 1).

All share the quasi-Newton loop; none uses the DOT alpha-init (step size
starts at 1, reference gates ALPHAINIT on TST_DOT).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .core import System, LBFGS_HISTORY, F64
from .quasi_newton import QuasiNewtonStepper


class _RebuildH0(QuasiNewtonStepper):
    """H0 = assembled Hessian (dense subdomain machinery), refreshed after
    every time step."""

    def h0_apply(self, state, q):
        return self.system.h0_apply(state.chol, state.equil, q,
                                    kc=state.kc_chol, fixed=state.fixed)

    def end_of_step(self, sys, x, fixed, state):
        elem_h, L, d, kc = sys._rebuild_h0(x, fixed)
        return state._replace(elem_h=elem_h, chol=L, equil=d, kc_chol=kc)


class LBFGSH(_RebuildH0):
    """LBFGS-H: whole-mesh Hessian initializer (use a P=1 plan)."""
    name = "LBFGSH"


class LBFGSHI(_RebuildH0):
    """LBFGS-HI: same matrix, cheaper approximate factorization (bf16).
    Construct the System with factor_dtype=jnp.bfloat16."""
    name = "LBFGSHI"


class LBFGSJH(_RebuildH0):
    """LBFGS-JH: disjoint node-partition block-Jacobi initializer (use a
    node plan from partition.build_node_plan)."""
    name = "LBFGSJH"


class LBFGSPD(QuasiNewtonStepper):
    """LBFGS-PD: fixed Laplacian-type initializer, one scalar Cholesky at
    precompute, reused for all steps and all three coordinates."""
    name = "LBFGSPD"

    def init_state(self):
        sys = self.system
        sd = self.script_data
        dtype = sys.dtype
        x = jnp.asarray(sd.x0, dtype)
        fixed = jnp.asarray(sd.fixed0)
        v = jnp.zeros((sys.n_vert, 3), dtype)
        x_tilta = sys.compute_x_tilta(x, v, fixed)
        L, d = sys.build_pd_factor(fixed)
        m = LBFGS_HISTORY
        from .core import SimState
        return SimState(
            x=x, x_n=jnp.copy(x), v=v, x_tilta=x_tilta,
            dx_elastic=jnp.zeros((sys.n_vert, 3), dtype), fixed=fixed,
            vel_sign=jnp.asarray(1.0, dtype), released=jnp.asarray(False),
            elem_h=jnp.zeros((1, 1), dtype),  # unused (no alpha-init)
            chol=L, equil=d,
            lb_s=jnp.zeros((m, sys.n_vert, 3), dtype),
            lb_t=jnp.zeros((m, sys.n_vert, 3), dtype),
            lb_rho=jnp.ones((m,), dtype),
            lb_valid=jnp.zeros((m,), dtype))

    def h0_apply(self, state, q):
        return self.system.pd_solve(state.chol, state.equil, q)

    def end_of_step(self, sys, x, fixed, state):
        return state  # fixed initializer, never refactorized

    def on_bc_change(self, sys, x, fixed, state):
        # traced path: sys is the traced System (the host plan was built
        # at init_state time, so its index arrays ride in as leaves)
        L, d = sys._build_pd_factor(fixed)
        return state._replace(chol=L, equil=d)
