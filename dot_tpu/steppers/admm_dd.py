"""ADMM-DD time stepper: overlapping-subdomain consensus ADMM.

Reference: src/TimeStepper/ADMMDDTimeStepper.cpp (USE_GW path, the default):
  fullyImplicit          :595-701  (initPrimal/initDual -> loop: subdomainSolve,
                                    boundaryConsensusSolve(1.8), dualSolve,
                                    global ||g||^2 test; weights+consensus
                                    refreshed at step end)
  initPrimal             :703-735  (local copies + local xHat)
  initDual               :736-796  (u = W^{-1} (g_global - g_local) at interfaces)
  initWeights_fast       :894-1033 (W_s = missing mass + missing-element 3x3
                                    blocks, incl. interface-interface off-diag)
  subdomainSolve         :1107-1232 (1 local Newton iter per ADMM iter on the
                                    augmented local energy; H refresh every 20)
  boundaryConsensusSolve :1254-1344 (solve sum_s W_s dz = residual, relax 1.8)
  dualSolve              :1345-1368

On `inexactSolve` (Config key, ADMMDDTimeStepper.cpp:1125-1137): the
reference scales the LOCAL Newton tolerance by the global residual ratio —
but its ADMM loop always calls subdomainSolve(localMaxIter=1,
localMinIter=1, ...) (line 636), and the early-exit test
`(sqn_g_local < localTol) && (j >= localMinIter)` can never trigger within
a single iteration, so the flag is a no-op at the shipped operating point.
This implementation runs the same one local Newton iteration per ADMM
iteration unconditionally, which is exactly the reference behavior with or
without the flag; additionally, in a lockstep batched program a masked
per-subdomain skip would save no wall-clock anyway.

Mapping highlights:
- the augmented local Hessian (local elasticity + local mass + W_s) uses
  the same compact-block assembly machinery as DOT; on banded plans it is
  assembled and factorized RCM-block-tridiagonally (assemble_own_btd_flat
  + _factorize_btd) and every local solve is a banded matmul scan — the
  dense (P, n3, n3) factor + per-iteration dense triangular solves were
  the ADMM-DD cost floor;
- the local line search is linearized (F(xl + a p) = F(xl) + a F(p);
  inertia and W-augmentation are exact quadratics in a), so trials are
  elementwise SVD + psi only;
- W_s and the consensus matrix are assembled from the SAME completion-tuple
  values via two additional static scatter plans;
- local states evolve as padded (P*Nmax, 3) copies; all P local Newton
  solves, line searches, and the consensus solve run batched inside one
  jitted while_loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .core import System, StepStats, StaticPytree, F64, HIGHEST, STATS_CAP
from .quasi_newton import _vdot
from ..kernels import soa
from ..scripts import make_step_fn

ADMM_ITER_CAP = 1000   # ADMMDDTimeStepper.cpp:632
ADMM_CHUNK = 100       # max ADMM iterations per device program execution,
                       # with a host-side convergence check between chunks
                       # (a frame can need up to ADMM_ITER_CAP iterations;
                       # folding the chunks into one while_loop is
                       # ROADMAP D3)
H_REFRESH_EVERY = 20   # ADMMDDTimeStepper.cpp:637
RELAX = 1.8            # over-relaxation (boundaryConsensusSolve arg)
LS_CAP = 64


class ADMMDDState(NamedTuple):
    x: jax.Array
    x_n: jax.Array
    v: jax.Array
    x_tilta: jax.Array
    dx_elastic: jax.Array
    fixed: jax.Array
    vel_sign: jax.Array
    released: jax.Array
    elem_h: jax.Array      # (144, nEp) element Hessians at last converged x
    w_vals: jax.Array      # (nUW,) COMPACT interface weight entries (the
                           # sparsity is the completion-tuple pattern; a
                           # dense (P, n3, n3) W would cost 2.6 GiB at
                           # monkey18K and OOM the chip)
    cons_chol: jax.Array   # (ns3, ns3) consensus factor
    cons_equil: jax.Array  # (ns3,)


class ADMMDDStepper(StaticPytree):
    name = "ADMMDD"

    def __init__(self, system: System, script_data, admm_plan,
                 warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self.ap = admm_plan
        self._anim = make_step_fn(script_data, system.dt)
        sys = system
        ap = admm_plan
        self.conn_local = tuple(jnp.asarray(ap.conn_local[:, c].copy())
                                for c in range(4))
        self.lscat_perm = jnp.asarray(ap.lscat_perm)
        self.lscat_segids = jnp.asarray(ap.lscat_segids)
        self.mass_local = jnp.asarray(ap.mass_local, sys.dtype)
        self.is_dual = jnp.asarray(ap.is_dual)
        self.owner_flat = jnp.asarray(
            ap.owner_part.astype(np.int64) * ap.mass_local.shape[1]
            + ap.owner_local)
        self.shared_ids = jnp.asarray(ap.shared_ids)
        self.l2shared = jnp.asarray(ap.l2shared)
        self.n_shared = ap.n_shared
        self.ns3 = ap.ns3
        self.w_perm = jnp.asarray(ap.w_perm)
        self.w_stage1 = jnp.asarray(ap.w_stage1)
        self.w_udest = jnp.asarray(ap.w_udest)
        n3_ = sys.n3
        ud = np.asarray(ap.w_udest, np.int64)
        w_sbd = ud // (n3_ * n3_)
        w_rowdof = ud % (n3_ * n3_) // n3_
        w_coldof = ud % n3_
        self._w_row = jnp.asarray((w_sbd * n3_ + w_rowdof).astype(np.int32))
        self._w_col = jnp.asarray((w_sbd * n3_ + w_coldof).astype(np.int32))
        self._w_isdiag = jnp.asarray((w_rowdof == w_coldof)
                                     .astype(np.float32))
        self.c_perm = jnp.asarray(ap.c_perm)
        self.c_stage1 = jnp.asarray(ap.c_stage1)
        self.c_udest = jnp.asarray(ap.c_udest)
        # banded augmented local Hessian (production path at scale): the
        # dense (P, n3, n3) factor + per-iteration dense triangular solves
        # were the ADMM-DD cost floor (~GBs of factor traffic per
        # iteration at monkey18K); the RCM-banded block-tridiagonal factor
        # cuts both the every-20-iteration refactor and each solve to the
        # band (reference analog: CHOLMOD's fill-reducing factorization
        # of the proxy, ADMMDDTimeStepper.cpp:1201-1232)
        self.banded_local = ap.w_band_dest is not None
        if self.banded_local:
            self.w_band_dest = jnp.asarray(ap.w_band_dest)
            self.md_band_diag = jnp.asarray(ap.md_band_diag)
        self.comp_gather = jnp.asarray(ap.comp_gather)
        self.mass_dif = jnp.asarray(ap.mass_dif, sys.dtype)
        self.nmax = ap.mass_local.shape[1]
        # (P,) line-search alphas broadcast to the flattened local layout
        am = np.repeat(np.arange(sys.n_parts), self.nmax)
        self._alpha_map = jnp.asarray(np.concatenate([am, [0]]))[:, None]
        # the ADMM loop runs in bounded chunks (ADMM_CHUNK) with a
        # host-side convergence check between device executions. The
        # chunk donates its carry (the per-subdomain factors dominate its
        # footprint).
        # The stepper itself is a pytree passed as the first jit ARGUMENT
        # (see StaticPytree) so no plan constants enter the programs.
        self._prelude = jax.jit(type(self)._prelude_impl)
        self._chunk = jax.jit(type(self)._chunk_impl, donate_argnums=(2,))
        self._finale = jax.jit(type(self)._finale_impl)

    def update_weights(self, x, fixed):
        """Eager entry for init/restore (jitted; self rides as a pytree)."""
        return _update_weights_jit(self, x, fixed)

    # ------------------------------------------------------------------
    # weights + consensus (reference: initWeights_fast + consensus solver)
    # ------------------------------------------------------------------
    def _update_weights(self, x, fixed):
        """W_s dense (local dofs) + factorized consensus matrix, from the
        element Hessians at x. Also returns elem_h for the local solves."""
        sys = self.system
        _, U, s, V = sys.fsvd(x)
        elem_h = sys.element_hessians(U, s, V)  # (144, nEp)
        vals = elem_h.reshape(-1)[self.comp_gather]  # (nC, 3, 3)

        # zero completion blocks whose row or col vertex is fixed
        # (initWeights_fast skips fixed dual verts and fixed columns)
        P, n3 = sys.n_parts, sys.n3
        free3 = self._free3(fixed)  # (P, n3) 0/1

        flat = vals.reshape(-1)
        w_sorted = flat[self.w_perm]
        w_vals = jax.ops.segment_sum(w_sorted, self.w_stage1,
                                     num_segments=len(self.w_udest),
                                     indices_are_sorted=True)
        # W stays COMPACT: masking and the mass-diff diagonal are applied
        # inside w_matvec/w_add_dense at use time (free masks depend on
        # the current Dirichlet set anyway)

        # consensus matrix over shared dofs
        c_sorted = flat[self.c_perm]
        c_compact = jax.ops.segment_sum(c_sorted, self.c_stage1,
                                        num_segments=len(self.c_udest),
                                        indices_are_sorted=True)
        C = jnp.zeros((self.ns3 * self.ns3,), sys.dtype).at[self.c_udest].set(
            c_compact, indices_are_sorted=True, unique_indices=True)
        C = C.reshape(self.ns3, self.ns3)
        # mass-diff diagonal mapped to shared dofs
        md_flat = self.mass_dif.reshape(-1)
        sh = self.l2shared.reshape(-1)
        md_sh = jnp.zeros((self.n_shared + 1,), sys.dtype).at[sh].add(md_flat)
        cidx = jnp.arange(self.ns3)
        C = C.at[cidx, cidx].add(jnp.repeat(md_sh, 3))
        # masks: fixed shared verts + the dump slot get identity rows
        sfree = jnp.concatenate(
            [jnp.logical_not(fixed[self.shared_ids]).astype(sys.dtype),
             jnp.zeros((1,), sys.dtype)])
        f3 = jnp.repeat(sfree, 3)
        C = C * f3[:, None] * f3[None, :]
        C = C.at[cidx, cidx].add(1.0 - f3)

        d = jnp.sqrt(C[cidx, cidx])
        dinv = 1.0 / d
        Lc = jnp.linalg.cholesky(
            sys._to_factor_dtype(C * dinv[:, None] * dinv[None, :]))
        return elem_h, w_vals, Lc, d

    # ---- compact-W operators (the dense (P, n3, n3) W never exists) ----
    def _w_masked(self, w_vals, free3f):
        return w_vals * free3f[self._w_row] * free3f[self._w_col]

    def _md3f(self, free3f):
        """Masked mass-diff diagonal as a flat (P*n3,) vector."""
        md = jnp.repeat(self.mass_dif, 3, axis=-1).reshape(-1)
        return md * free3f

    def w_matvec(self, w_vals, free3f, aug):
        """y = W @ aug, (P, n3) -> (P, n3), masked to free rows/cols
        (reference role: the dense W einsum matvecs)."""
        sys = self.system
        P, n3 = sys.n_parts, sys.n3
        af = aug.reshape(-1)
        v = self._w_masked(w_vals, free3f) * af[self._w_col]
        y = jax.ops.segment_sum(v, self._w_row, num_segments=P * n3,
                                indices_are_sorted=True)
        y = y + self._md3f(free3f) * af
        return y.reshape(P, n3)

    def w_add_dense(self, Hd, w_vals, free3f):
        """Hd + W for the augmented local Hessian (local_h_factor)."""
        sys = self.system
        P, n3 = sys.n_parts, sys.n3
        flat = Hd.reshape(-1).at[self.w_udest].add(
            self._w_masked(w_vals, free3f),
            indices_are_sorted=True, unique_indices=True)
        Hd = flat.reshape(P, n3, n3)
        idx = jnp.arange(n3)
        return Hd.at[:, idx, idx].add(self._md3f(free3f).reshape(P, n3))

    def w_diag(self, w_vals, free3f):
        """(P*n3,) diagonal of the masked W (for the initDual identity
        fix-up on zero-diagonal rows)."""
        sys = self.system
        v = self._w_masked(w_vals, free3f) * self._w_isdiag.astype(sys.dtype)
        d = jax.ops.segment_sum(v, self._w_row,
                                num_segments=sys.n_parts * sys.n3,
                                indices_are_sorted=True)
        return d + self._md3f(free3f)

    def _free3(self, fixed):
        sys = self.system
        free = jnp.logical_and(sys.local_valid,
                               jnp.logical_not(fixed[sys.l2g]))
        return jnp.repeat(free.astype(sys.dtype), 3, axis=-1)

    # ------------------------------------------------------------------
    # local (per-subdomain) energy / gradient on padded local states
    # ------------------------------------------------------------------
    def _local_fsvd(self, xl_flat):
        """Local deformation gradients at xl_flat ((P*Nmax + 1, 3) local
        positions + dump row). Row gathers: (nEp, 3) corner ROWS from the
        (n, 3) layout, the same form as System.corner_rows."""
        rows = [xl_flat[self.conn_local[c]] for c in range(4)]
        pe = tuple(rows[c][:, i] for c in range(4) for i in range(3))
        return self.system.defgrad_from_corners(pe)

    def _local_energies(self, xl_flat, xhat_flat, z, u_loc, wpack, sigma):
        """(P,) augmented local energies (computeEnergyVal_subdomain).
        wpack = (compact W values, flat free mask)."""
        sys = self.system
        psi_w = sys.mat_soa.psi(sigma, sys.u_e, sys.lam_e) * sys.vol_w
        e_el = jnp.sum(psi_w.reshape(sys.n_parts, -1), axis=1) * sys.dt_sq
        d = (xl_flat - xhat_flat)[:-1].reshape(sys.n_parts, self.nmax, 3)
        e_in = 0.5 * jnp.sum(self.mass_local[..., None] * d * d, axis=(1, 2))
        aug = self._aug_vec(xl_flat, z, u_loc)        # (P, n3)
        Wa = self.w_matvec(wpack[0], wpack[1], aug)
        e_aug = 0.5 * jnp.sum(aug * Wa, axis=1)
        return e_el + e_in + e_aug

    def _aug_vec(self, xl_flat, z, u_loc):
        """(P, n3): x_local - z_global + u at local dof layout (only dual
        columns of W are nonzero, so no masking is needed)."""
        sys = self.system
        zg = z[sys.l2g]  # (P, Nmax, 3)
        xl = xl_flat[:-1].reshape(sys.n_parts, self.nmax, 3)
        return (xl - zg + u_loc).reshape(sys.n_parts, sys.n3)

    def _local_gradient(self, xl_flat, xhat_flat, z, u_loc, wpack, fixed,
                        f9, U, s, V):
        sys = self.system
        ge = soa.element_gradient_soa(sys.mat_soa, f9, U, s, V, sys.D_soa,
                                      sys.u_e, sys.lam_e, sys.vol_w)
        # ONE unsorted row scatter-add of (nEp*4, 3) corner-gradient rows
        # (the same ~4x win over three per-dim sorted segment-sum passes
        # as System.gradient; padded elements route to the dump row)
        # axis-0 stack (contiguous lane writes) + one tiled transpose —
        # a minor-axis stack of long lanes emits strided 4-byte writes
        vals = jnp.stack([ge[c][i] for c in range(4)
                          for i in range(3)]).T       # (nEp, 12)
        conn_s = jnp.stack(self.conn_local, axis=1).reshape(-1)
        acc = jnp.zeros((sys.n_parts * self.nmax + 1, 3), sys.dtype).at[
            conn_s].add(vals.reshape(-1, 3))
        g = acc[:-1].reshape(sys.n_parts, self.nmax, 3) \
            * jnp.asarray(sys.dt_sq, sys.dtype)
        d = (xl_flat - xhat_flat)[:-1].reshape(sys.n_parts, self.nmax, 3)
        g = g + self.mass_local[..., None] * d
        aug = self._aug_vec(xl_flat, z, u_loc)
        g = g + self.w_matvec(wpack[0], wpack[1], aug).reshape(
            sys.n_parts, self.nmax, 3)
        free = self._free3(fixed).reshape(sys.n_parts, self.nmax, 3)
        return g * free

    # ------------------------------------------------------------------
    def _to_flat(self, xl):
        sys = self.system
        return jnp.concatenate(
            [xl.reshape(sys.n_parts * self.nmax, 3),
             jnp.zeros((1, 3), sys.dtype)], axis=0)

    def _local_h_factor(self, xl_flat, wpack, fixed, svd=None):
        """Augmented local Hessian = DOT assembly (local + completion
        values replaced by W's) — here: local elasticity + local mass +
        W, identity at fixed/pad rows. Pass `svd` = (U, s, V) at xl_flat
        (the chunk loop carries it) to skip the re-decomposition."""
        sys = self.system
        if svd is None:
            f9 = self._local_fsvd(xl_flat)
            U, s, V = soa.svd3_flip_soa(f9)
        else:
            f9 = None
            U, s, V = svd
        elem_h = sys.element_hessians(U, s, V)
        # local-only assembly: reuse the global plan but subtract the
        # completion contribution is wrong; instead assemble local-only
        # via the DOT plan minus completion == assemble with W added:
        # DOT assembly includes completion blocks built from the SAME
        # element Hessians; ADMM wants completion from the *frozen*
        # weight matrices W. Assemble DOT-style (local+completion at
        # current local state) is NOT what the reference does, so:
        # assemble local-only then add W.
        if self.banded_local:
            P, bs, nb = sys.n_parts, sys.band_bs, sys.band_nb
            flat = sys.assemble_own_btd_flat(elem_h, fixed,
                                             self.mass_local)
            # W rides the same drop-mode scatter as the assembly: upper
            # block-neighbor entries vanish (the Cholesky reads the lower
            # triangle only, matching the dense path's behavior)
            flat = flat.at[self.w_band_dest].add(
                self._w_masked(wpack[0], wpack[1]), mode="drop")
            flat = flat.at[self.md_band_diag].add(self._md3f(wpack[1]))
            diag_sz = P * nb * bs * bs
            diag = flat[:diag_sz].reshape(nb, P, bs, bs)
            sub = flat[diag_sz:].reshape(nb - 1, P, bs, bs)
            L, d = sys.factorize((diag, sub))
        else:
            Hd = sys.assemble_subdomains_local_only(elem_h, fixed,
                                                    self.mass_local)
            Hd = self.w_add_dense(Hd, wpack[0], wpack[1])
            L, d = sys.factorize(Hd)
        return (f9, U, s, V), L, d

    def _prelude_impl(self, state: ADMMDDState, tol):
        sys = self.system
        sd = self.script_data
        anim = self._anim
        P, n3, nmax = sys.n_parts, sys.n3, self.nmax
        to_flat = self._to_flat
        x, fixed, vel_sign, released, bc_changed = anim(
            state.x, state.fixed, state.vel_sign, state.released)

        elem_h, wv = state.elem_h, state.w_vals
        Lc, dc = state.cons_chol, state.cons_equil
        if sd.has_bc_change:
            elem_h, wv, Lc, dc = jax.lax.cond(
                bc_changed,
                lambda: self._update_weights(x, fixed),
                lambda: (elem_h, wv, Lc, dc))
        wpack = (wv, self._free3(fixed).reshape(-1))

        # initPrimal: global warm start, local copies, local xHat
        x = sys.warm_start(self.warm_start_opt, x, state.v,
                           state.dx_elastic, fixed,
                           x_tilta=state.x_tilta)
        xhat_g = jnp.where(fixed[:, None], x, state.x_tilta)
        xl = x[sys.l2g] * sys.local_valid[..., None]
        xhat_l = xhat_g[sys.l2g] * sys.local_valid[..., None]
        xl_flat = to_flat(xl)
        xhat_flat = to_flat(xhat_l)
        z = x
        u_loc = jnp.zeros((P, nmax, 3), sys.dtype)

        # global gradient & energy
        F0, U0, s0, V0 = sys.fsvd(x)
        e = sys.energy(x, state.x_tilta, s0)
        g = sys.gradient(x, state.x_tilta, fixed, F0, U0, s0, V0)
        sqn_g = _vdot(g, g)

        # initDual: u = W^{-1} (g_global - g_local) on interface dofs
        lf9 = self._local_fsvd(xl_flat)
        lU, ls_, lV = soa.svd3_flip_soa(lf9)
        g_loc = self._local_gradient(xl_flat, xhat_flat, z,
                                     jnp.zeros_like(u_loc), wpack, fixed,
                                     lf9, lU, ls_, lV)
        rhs_u = (g[sys.l2g] * sys.local_valid[..., None] - g_loc)
        rhs_u = rhs_u * self.is_dual[..., None]
        # solve (W + I_offdual) u = rhs via CG on the compact operator
        # (the reference prefactorizes dense W per subdomain,
        # ADMMDDTimeStepper.cpp:736-796; materializing (P, n3, n3)
        # just for this init would cost 2.6 GiB at monkey18K. W is
        # SPD on the dual dofs + identity elsewhere — CG to 1e-9
        # gives an initialization-grade dual identical in practice)
        free3 = self._free3(fixed)
        dual3 = jnp.repeat(self.is_dual.astype(sys.dtype), 3, axis=-1) \
            * free3
        wd = self.w_diag(wpack[0], wpack[1])        # (P*n3,)
        fix1 = jnp.where(
            (wd.reshape(P, n3) == 0.0) & (dual3 > 0.0), 1.0, 0.0)

        def wsolve_mv(v):                           # (P, n3) -> (P, n3)
            y = self.w_matvec(wpack[0], wpack[1], v)
            return y + v * (1.0 - dual3) + v * fix1

        b = rhs_u.reshape(P, n3)

        def cg_body(c):
            xk, rk, pk, rs, it = c
            Ap = wsolve_mv(pk)
            alpha = rs / jnp.vdot(pk.ravel(), Ap.ravel(),
                                  precision=HIGHEST)
            xk = xk + alpha * pk
            rk = rk - alpha * Ap
            rs_new = jnp.vdot(rk.ravel(), rk.ravel(), precision=HIGHEST)
            pk = rk + (rs_new / rs) * pk
            return xk, rk, pk, rs_new, it + 1

        x0 = jnp.zeros_like(b)
        r0 = b
        rs0 = jnp.vdot(r0.ravel(), r0.ravel(), precision=HIGHEST)

        def cg_cond(c):
            # relative stop: ||r|| < 1e-5 ||r0|| (squared 1e-10) — an
            # initialization-grade dual; terminates by convergence in f32
            # instead of silently hitting the iteration cap
            _, _, _, rs, it = c
            return jnp.logical_and(rs > 1e-10 * rs0, it < 200)
        uw, _, _, _, _ = jax.lax.while_loop(
            cg_cond, cg_body, (x0, r0, r0, rs0,
                               jnp.asarray(0, jnp.int32)))
        u_loc = uw.reshape(P, nmax, 3) * dual3.reshape(P, nmax, 3)

        # initial local Hessian factors (refreshed every 20 iters); the
        # SVD at the initial local state seeds the F-carry (the chunk
        # loop updates F linearly along the accepted step, F(x + a p) =
        # F(x) + a F(p), so the per-iteration local re-gather+SVD of the
        # old loop disappears)
        _, L0, d0 = self._local_h_factor(xl_flat, wpack, fixed,
                                         svd=(lU, ls_, lV))

        rows = jnp.zeros((STATS_CAP, 3), F64)
        rows = rows.at[0].set(jnp.stack([jnp.zeros((), F64),
                                         e.astype(F64), sqn_g.astype(F64)]))

        env = (fixed, vel_sign, released, wv, wpack[1], xhat_flat,
               Lc, dc, state.x_tilta)
        carry = (xl_flat, z, u_loc, L0, d0, e, sqn_g,
                 jnp.asarray(0, jnp.int32), rows, lf9, lU, ls_, lV)
        return env, carry

    def _chunk_impl(self, env, carry, tol):
        sys = self.system
        P, n3, nmax = sys.n_parts, sys.n3, self.nmax
        to_flat = self._to_flat
        (fixed, _vs, _rl, wv, free3f, xhat_flat, Lc, dc, x_tilta) = env
        wpack = (wv, free3f)
        it0 = carry[7]

        def cond(c):
            sqn_g, it = c[6], c[7]
            return jnp.logical_and(
                jnp.logical_and(sqn_g > tol, it < ADMM_ITER_CAP),
                it - it0 < ADMM_CHUNK)

        def body(c):
            (xl_flat, z, u_loc, L, d, e, sqn_g, it, rows,
             f9, U, s, V) = c
            # H refresh every 20 iterations (SVD comes from the carry)
            L, d = jax.lax.cond(
                it % H_REFRESH_EVERY == 0,
                lambda: self._local_h_factor(xl_flat, wpack, fixed,
                                             svd=(U, s, V))[1:],
                lambda: (L, d))

            # --- one local Newton iteration with line search -------
            # (f9, U, s, V) at the current xl ride in the carry
            gl = self._local_gradient(xl_flat, xhat_flat, z, u_loc,
                                      wpack, fixed, f9, U, s, V)
            r = -gl.reshape(P, n3) / d
            zz = sys.solve_local(L, r)      # dense or block-tridiagonal
            p = (zz.astype(sys.dtype) / d).reshape(P, nmax, 3)
            p = p * self._free3(fixed).reshape(P, nmax, 3)

            # Linearized local line search: F(xl + a p) = F(xl) + a F(p)
            # (F is linear in positions) and both the inertia and the
            # W-augmentation terms are exact quadratics in a, so each
            # trial is purely elementwise (flip-SVD + psi) — no gathers
            # and no W matvecs inside the trial loop (the same fast path
            # as quasi_newton.line_search; reference trials re-evaluate
            # computeEnergyVal_subdomain, ADMMDDTimeStepper.cpp:1174-1199).
            p_flat = to_flat(p)
            fp9 = self._local_fsvd(p_flat)
            ml = self.mass_local[..., None]
            d0 = (xl_flat - xhat_flat)[:-1].reshape(P, nmax, 3)
            c0 = 0.5 * jnp.sum(ml * d0 * d0, axis=(1, 2))
            c1 = jnp.sum(ml * d0 * p, axis=(1, 2))
            c2 = 0.5 * jnp.sum(ml * p * p, axis=(1, 2))
            aug0 = self._aug_vec(xl_flat, z, u_loc)
            pa = p.reshape(P, n3)
            Wa0 = self.w_matvec(wpack[0], wpack[1], aug0)
            Wpa = self.w_matvec(wpack[0], wpack[1], pa)
            a0c = 0.5 * jnp.sum(aug0 * Wa0, axis=1)
            a1c = 0.5 * (jnp.sum(pa * Wa0, axis=1)
                         + jnp.sum(aug0 * Wpa, axis=1))
            a2c = 0.5 * jnp.sum(pa * Wpa, axis=1)
            n_slab = sys.n_elem_p // P

            def trial_e(alpha):
                ae = jnp.repeat(alpha.astype(sys.dtype), n_slab)
                ff = tuple(f + ae * fp for f, fp in zip(f9, fp9))
                _, ss, _ = soa.svd3_flip_soa(ff)
                psi_w = sys.mat_soa.psi(ss, sys.u_e, sys.lam_e) * sys.vol_w
                e_el = jnp.sum(psi_w.reshape(P, -1), axis=1) * sys.dt_sq
                return (e_el + c0 + alpha * (c1 + alpha * c2)
                        + a0c + alpha * (a1c + alpha * a2c))

            psi0 = sys.mat_soa.psi(s, sys.u_e, sys.lam_e) * sys.vol_w
            e0 = (jnp.sum(psi0.reshape(P, -1), axis=1) * sys.dt_sq
                  + c0 + a0c)

            def ls_body(cc):
                alpha, ee, k = cc
                alpha = jnp.where(ee > e0, alpha * 0.5, alpha)
                ee = trial_e(alpha)
                return alpha, ee, k + 1

            def ls_cond(cc):
                _, ee, k = cc
                return jnp.logical_and(jnp.any(ee > e0), k < LS_CAP)

            a1 = jnp.ones((P,), sys.dtype)
            e1 = trial_e(a1)
            alpha, _, _ = jax.lax.while_loop(
                ls_cond, ls_body, (a1, e1, jnp.asarray(0, jnp.int32)))
            xl_flat = xl_flat + alpha[self._alpha_map] * p_flat
            # F-carry update: F is linear in positions, so the accepted
            # step updates the carried deformation gradients without a
            # re-gather; one SVD refreshes (U, s, V) for the next
            # gradient/Hessian
            ae_fin = jnp.repeat(alpha.astype(sys.dtype), n_slab)
            f9 = tuple(f + ae_fin * fp for f, fp in zip(f9, fp9))
            U, s, V = soa.svd3_flip_soa(f9)

            # --- boundary consensus solve (relax 1.8) --------------
            xl = xl_flat[:-1].reshape(P, nmax, 3)
            zg = z[sys.l2g]
            zk = zg  # resultVk == z before the update within this iter
            aug = (RELAX * xl + (1.0 - RELAX) * zk + u_loc - zg)
            aug = aug.reshape(P, n3)
            t = self.w_matvec(wpack[0], wpack[1],
                              aug).reshape(P * nmax, 3)
            rhs_sh = jnp.zeros((self.n_shared + 1, 3), sys.dtype)
            rhs_sh = rhs_sh.at[self.l2shared.reshape(-1)].add(t)
            rhs_sh = rhs_sh.at[self.n_shared].set(0.0)
            rhs_sh = jnp.where(fixed[self.shared_ids][:, None],
                               0.0, rhs_sh[:self.n_shared])
            rhs_full = jnp.concatenate(
                [rhs_sh, jnp.zeros((1, 3), sys.dtype)]).reshape(self.ns3)
            rc = (rhs_full / dc)[:, None].astype(sys._solve_dtype)
            yc = jax.lax.linalg.triangular_solve(Lc, rc, left_side=True,
                                                 lower=True)
            zc = jax.lax.linalg.triangular_solve(Lc, yc, left_side=True,
                                                 lower=True,
                                                 transpose_a=True)
            dz = (zc[:, 0].astype(sys.dtype) / dc).reshape(-1, 3)

            z_new = z
            # interior verts: owner's local copy
            z_owner = xl_flat[self.owner_flat]
            is_sh = jnp.zeros((sys.n_vert,), bool).at[self.shared_ids].set(True)
            z_new = jnp.where(is_sh[:, None], z, z_owner)
            z_new = z_new.at[self.shared_ids].add(dz[:self.n_shared])

            # --- dual update (stepSize 1, relax 1.8) ----------------
            zg_new = z_new[sys.l2g]
            du = (RELAX * xl + (1.0 - RELAX) * zk - zg_new) \
                * self.is_dual[..., None]
            u_loc = u_loc + du

            # --- global convergence check ---------------------------
            F, Ug, sg, Vg = sys.fsvd(z_new)
            gg = sys.gradient(z_new, x_tilta, fixed, F, Ug, sg, Vg)
            ee = sys.energy(z_new, x_tilta, sg)
            sqn = _vdot(gg, gg)
            it = it + 1
            row = jnp.stack([jnp.ones((), F64), ee.astype(F64),
                             sqn.astype(F64)])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (xl_flat, z_new, u_loc, L, d, ee, sqn, it, rows,
                    f9, U, s, V)

        return jax.lax.while_loop(cond, body, carry)

    def _finale_impl(self, state, env, carry):
        sys = self.system
        (fixed, vel_sign, released, wv, free3f, xhat_flat,
         Lc, dc, x_tilta) = env
        (xl_flat, z, u_loc, L0, d0, e, sqn_g, it, rows) = carry[:9]
        x = z
        # refresh weights + consensus factor for the next step
        elem_h, wv, Lc, dc = self._update_weights(x, fixed)

        state = state._replace(fixed=fixed, vel_sign=vel_sign,
                               released=released, elem_h=elem_h,
                               w_vals=wv, cons_chol=Lc, cons_equil=dc)
        x_n_prev = state.x_n
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
                          stopped=(it >= ADMM_ITER_CAP), rows=rows)
        return state, (stats, sys_e)

    # ------------------------------------------------------------------
    def init_state(self):
        sys = self.system
        sd = self.script_data
        dtype = sys.dtype
        x = jnp.asarray(sd.x0, dtype)
        fixed = jnp.asarray(sd.fixed0)
        v = jnp.zeros((sys.n_vert, 3), dtype)
        elem_h, wv, Lc, dc = self.update_weights(x, fixed)
        return ADMMDDState(
            x=x, x_n=jnp.copy(x), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=jnp.zeros((sys.n_vert, 3), dtype),
            fixed=fixed, vel_sign=jnp.asarray(1.0, dtype),
            released=jnp.asarray(False),
            elem_h=elem_h, w_vals=wv, cons_chol=Lc, cons_equil=dc)

    def restore(self, x, v, dxe):
        """Resumed-run state (Optimizer.cpp:126-177): interface weights,
        element Hessians, and the consensus factor are refreshed at the
        restored positions."""
        sys = self.system
        st = self.init_state()
        xj = jnp.asarray(x, sys.dtype)
        vj = jnp.asarray(v, sys.dtype)
        elem_h, wv, Lc, dc = self.update_weights(xj, st.fixed)
        return st._replace(x=xj, x_n=jnp.copy(xj), v=vj,
                           x_tilta=sys.compute_x_tilta(xj, vj, st.fixed),
                           dx_elastic=jnp.asarray(dxe, sys.dtype),
                           elem_h=elem_h, w_vals=wv,
                           cons_chol=Lc, cons_equil=dc)

    def step(self, state, rel_tol=1.0e-5):
        tol = jnp.asarray(self.system.target_g_res(rel_tol), F64)
        tol_f = float(self.system.target_g_res(rel_tol))
        env, carry = self._prelude(self, state, tol)
        while True:
            carry = self._chunk(self, env, carry, tol)
            sqn_g, it = jax.device_get((carry[6], carry[7]))
            if not (float(sqn_g) > tol_f and int(it) < ADMM_ITER_CAP):
                break
        return self._finale(self, state, env, carry)


@jax.jit
def _update_weights_jit(stepper, x, fixed):
    return stepper._update_weights(x, fixed)
