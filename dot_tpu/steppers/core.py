"""Device-side system assembly shared by all time steppers.

`System` owns the static device buffers (padded, element-reordered) and the
pure functions every stepper composes: incremental-potential energy,
gradient, element Hessians, dense subdomain assembly, batched Cholesky
factorization and the H0 apply (solve + duplicate-average).

This replaces the reference's LinSysSolver/CHOLMOD layer wholesale
(reference: src/LinSysSolver/*): there is never a global sparse matrix —
Hessians live as (nE, 12, 12) element blocks, subdomain matrices as padded
dense (P, n3, n3) or RCM-banded block-tridiagonal buffers factorized by
one batched Cholesky.

Precision policy:
- fields and compute run in `dtype` (f32 on an accelerator, f64 on the
  CPU); the energy, gradient-norm and L-BFGS inner-product reductions run
  in that same dtype (XLA's tree reductions keep their relative error
  near eps * log n, far below the 1e-3 relative-decrease stop); only the
  diagnostic system energy and the per-iteration stats rows are f64;
- matrices are Jacobi-equilibrated before the Cholesky;
- every dot_general with f32 operands names `HIGHEST`, so no backend
  may lower it to reduced-precision passes (TF32 or bf16): the exact
  path (fast=False: Newton, LBFGS-H, the PD factor) is exact f32, and so
  are the preconditioner's solves;
- reduced precision enters only as an explicit bf16 cast: the
  preconditioner factorizations' bulk GEMMs (the SYRK / Schur updates
  with `fast`) take bf16 inputs with f32 accumulation, and the
  preconditioner factors are stored in `apply_dtype` (bf16 by default
  for f32 runs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import soa
from ..materials import get_material

F64 = jnp.float64
HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Static-pytree infrastructure: System (and the steppers) register as JAX
# pytrees whose jax.Array attributes are the leaves. Jitted entry points take
# the System/stepper object as an ARGUMENT, so the static plan/element
# buffers are threaded through jit as arguments — never baked into the
# compiled program as constants. This is what (a) keeps the compiled
# program small and its compile time independent of the mesh at 765K-tet
# scale, (b) makes the statics shardable across a device mesh (the element and
# subdomain axes can carry jax.sharding annotations), and (c) keeps
# donation bookkeeping predictable.
# ---------------------------------------------------------------------------
def _is_leafset(v):
    """True if v is a jax.Array or a (nested) tuple/list of them — the
    attribute kinds that become pytree leaves."""
    if isinstance(v, jax.Array):
        return True
    if isinstance(v, (tuple, list)):
        return len(v) > 0 and all(_is_leafset(x) for x in v)
    return False


_PYTREE_INTERNAL = ("_host", "_child_names")


def _static_children(obj):
    # copies produced by unflatten carry the recorded child-name tuple:
    # JAX re-flattens trees whose leaves it replaced with non-array
    # stand-ins (ArgInfo, ShapeDtypeStruct, tracers), so flatten must be
    # STRUCTURAL there — only the original host detects its children by
    # content.
    names = vars(obj).get("_child_names")
    if names is not None:
        return names
    return tuple(k for k in sorted(vars(obj))
                 if k not in _PYTREE_INTERNAL
                 and (_is_leafset(vars(obj)[k])
                      or isinstance(vars(obj)[k], StaticPytree)))


def _static_flatten_with_keys(obj):
    names = _static_children(obj)
    kids = [(jax.tree_util.GetAttrKey(k), vars(obj)[k]) for k in names]
    # aux carries the ORIGINAL host object (stable across flatten ->
    # unflatten -> flatten round trips, which jit relies on for treedef
    # equality); identity of the host keeps distinct Systems distinct
    return kids, (getattr(obj, "_host", obj), names)


def _static_flatten(obj):
    names = _static_children(obj)
    return ([vars(obj)[k] for k in names],
            (getattr(obj, "_host", obj), names))


def _static_unflatten(aux, children):
    obj, names = aux
    new = object.__new__(type(obj))
    new.__dict__.update(obj.__dict__)
    new.__dict__.update(dict(zip(names, children)))
    new._host = obj
    new._child_names = names
    return new


class StaticPytree:
    """Base class whose subclasses auto-register as (keyed) pytrees:
    jax.Array attributes (and nested tuples/lists of them, and nested
    StaticPytree attributes) flatten to leaves with GetAttrKey paths;
    everything else (meshes, configs, host plans, floats, functions)
    rides along as aux data. aux equality is object identity, so passing
    the same instance to a jitted function hits the trace cache."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        jax.tree_util.register_pytree_with_keys(
            cls, _static_flatten_with_keys, _static_unflatten,
            _static_flatten)


# Reference constants
GRAVITY_Y = -9.80665           # Optimizer.cpp:109
LBFGS_HISTORY = 5              # DOTTimeStepper.cpp:45
INNER_ITER_CAP = 10000         # Optimizer.cpp:662
LINE_SEARCH_CAP = 64           # reference halves literally to fp zero
REL_EDEC_STOP = 1.0e-3         # Optimizer.cpp:856-862 (allowEDecRelTol)
STATS_CAP = INNER_ITER_CAP + 16  # per-step iterStats rows kept on device:
# covers the reference's full 10000-iteration Newton cap so iterStats.txt
# carries EVERY inner iteration (Optimizer.cpp:666-693); ~240 KB f64 on
# device, downloaded once per frame


class BTDFactor(NamedTuple):
    """Block-tridiagonal Cholesky factor of the RCM-banded subdomain
    matrices: per-block INVERTED diagonal factors (so the per-iteration
    solves are batched matmuls, not latency-bound triangular solves) and
    the sub-diagonal coupling blocks."""
    linv: jax.Array   # (nb, P, bs, bs) L_kk^{-1} (scan-major)
    sub: jax.Array    # (nb-1, P, bs, bs) L_{k+1,k}


class CRFactor(NamedTuple):
    """Block CYCLIC-REDUCTION factorization of the same SPD
    block-tridiagonal systems (equivalent to Cholesky under the odd-even
    nested-dissection permutation, so SPD-stable). The sequential
    block-scan factorization runs nb dependent Cholesky+TRSM stages,
    each a dependent kernel launch; cyclic reduction eliminates all ODD
    blocks of a level at once with batched GEMMs, recursing on the halved
    even system: ~log2(nb) dependent stages for both the factorization and
    the solves. Per eliminated odd block j (D_j = L L^T, Li = L^{-1}):
      levels[l] = (Li_j, G_lo = Li S_{j-1}, G_hi = Li S_j^T)
    and the <=4-block root system keeps the scan factorization."""
    levels: tuple     # per level: (Li, G_lo, G_hi) each (n_odd, P, bs, bs)
    root: BTDFactor   # factor of the final reduced system (nb_root <= 4)


class SimState(NamedTuple):
    """Dynamic simulation state (one pytree, donated through steps)."""
    x: jax.Array           # (nV, 3) positions
    x_n: jax.Array         # (nV, 3) previous step positions
    v: jax.Array           # (nV, 3) velocities
    x_tilta: jax.Array     # (nV, 3) inertia predictor
    dx_elastic: jax.Array  # (nV, 3)
    fixed: jax.Array       # (nV,) bool
    vel_sign: jax.Array    # () script turning sign
    released: jax.Array    # () bool rubberBandPull release happened
    elem_h: jax.Array      # (nEp, 12, 12) frozen element Hessians
    chol: jax.Array        # (P, n3, n3) factor of equilibrated H0
    equil: jax.Array       # (P, n3) equilibration sqrt-diagonals
    lb_s: jax.Array        # (m, nV, 3) L-BFGS s history (oldest..newest)
    lb_t: jax.Array        # (m, nV, 3) L-BFGS t history
    lb_rho: jax.Array      # (m,) t.s
    lb_valid: jax.Array    # (m,) 0/1
    # two-level H0 coarse factor (Lc (6P, 6P), dc (6P,)) or None when the
    # coarse space is off (see System._coarse_factor); None keeps the
    # pytree structure of small-partition runs unchanged
    kc_chol: tuple = None


class StepStats(NamedTuple):
    energy: jax.Array       # () final incremental potential
    sqn_g: jax.Array        # () final ||g||^2
    inner_iters: jax.Array  # () int
    ls_halvings: jax.Array  # () int accumulated
    stopped: jax.Array      # () bool (line search / rel-decrease stop)
    rows: jax.Array         # (STATS_CAP, 3) per-iteration (alpha, E, ||g||^2)


class System(StaticPytree):
    def __init__(self, mesh, cfg, plan, dtype=jnp.float32,
                 factor_dtype=None, apply_dtype=None):
        self.mesh = mesh
        self.cfg = cfg
        self.plan = plan
        self.dtype = dtype
        self.factor_dtype = factor_dtype or dtype
        # storage dtype of the quasi-Newton H0 factors for the per-
        # iteration applies (the factorization itself runs in f32/f64):
        # bf16 halves the HBM traffic of the solve matvecs at ~1e-3
        # direction error — preconditioner-grade, like the reference's
        # incomplete-Cholesky option. f64 runs stay exact.
        if apply_dtype is None:
            apply_dtype = (jnp.bfloat16 if self.factor_dtype
                           in (jnp.float32, jnp.bfloat16) else None)
        self.apply_dtype = apply_dtype
        self.material = get_material(cfg.energy)
        self.dt = float(cfg.dt)
        self.dt_sq = self.dt * self.dt
        self.n_vert = mesh.n_vert
        self.n_parts = plan.n_parts if plan is not None else 0
        self.n3 = plan.n3 if plan is not None else 0
        self.banded = False
        p = plan

        # ---- padded, reordered element arrays -------------------------
        if p is not None:
            src = p.elem_src
            valid = p.elem_valid
        else:
            n_pad = (-(-mesh.n_elem // 256)) * 256
            src = np.zeros(n_pad, np.int32)
            src[:mesh.n_elem] = np.arange(mesh.n_elem, dtype=np.int32)
            valid = np.zeros(n_pad, bool)
            valid[:mesh.n_elem] = True
        conn = mesh.conn[src].astype(np.int32)
        conn_gather = np.where(valid[:, None], conn, 0)
        conn_scatter = np.where(valid[:, None], conn, mesh.n_vert)
        rti = mesh.rest_tri_inv[src] * valid[:, None, None]
        vol_w = (mesh.tri_weight * mesh.vol)[src] * valid
        u = mesh.u[src]
        lam = mesh.lam[src]

        self.conn_g = jnp.asarray(conn_gather)
        self.conn_s = jnp.asarray(conn_scatter)
        self._conn_scatter_np = conn_scatter   # host copy (PD band plan)
        # contiguous per-corner index vectors (gathers from column slices
        # of the lane-padded (N, 4) layout are ~3x slower)
        self.conn_cols = tuple(jnp.asarray(conn_gather[:, c].copy())
                               for c in range(4))
        self.vol_w = jnp.asarray(vol_w, dtype)
        self.u_e = jnp.asarray(u, dtype)
        self.lam_e = jnp.asarray(lam, dtype)
        self.n_elem_p = conn.shape[0]
        # SoA statics: restTriInv components and corner basis D
        # (computed in host numpy, uploaded once)
        self.g9 = tuple(jnp.asarray(rti[:, i, j], dtype)
                        for i in range(3) for j in range(3))
        D = np.concatenate([-rti.sum(axis=-2, keepdims=True), rti], axis=-2)
        self.D_soa = [[jnp.asarray(D[:, c, j], dtype) for j in range(3)]
                      for c in range(4)]
        self.mat_soa = soa.SOA_MATERIALS[self.material.name]

        # vertex scatter plan over the reordered connectivity
        flat = conn_scatter.ravel()
        perm = np.argsort(flat, kind="stable")
        self.scat_perm = jnp.asarray(perm.astype(np.int32))
        self.scat_segids = jnp.asarray(flat[perm].astype(np.int32))

        # ---- global fields --------------------------------------------
        self.mass = jnp.asarray(mesh.mass, dtype)
        grav = np.zeros(3)
        if cfg.with_gravity:
            grav[1] = GRAVITY_Y
        self.gravity = jnp.asarray(grav, dtype)
        self.grav_dt_sq = jnp.asarray(grav * self.dt_sq, dtype)

        # ---- subdomain plan buffers ------------------------------------
        self.use_coarse = False
        if p is None:
            self._finish_init()
            return
        # RCM-banded block-tridiagonal storage (0/None => dense)
        self.band_bs = int(getattr(p, "band_bs", 0) or 0)
        self.band_nb = int(getattr(p, "band_nb", 0) or 0)
        self.banded = self.band_nb >= 3
        if self.banded:
            self.band_dest = jnp.asarray(p.band_dest)
            self.band_ub_row = jnp.asarray(p.band_ub_row)
            self.band_ub_col = jnp.asarray(p.band_ub_col)
            self.band_diag_ub = jnp.asarray(p.band_diag_ub)
            self.band_pad_diag = jnp.asarray(p.band_pad_diag)
            # bf16-band low-memory rebuild + subdomain-scan assembly for
            # huge bands (the full-size f32 scatter is what runs out of
            # memory on large-blockSize H0s). Preconditioner path only.
            # The 2 GiB gate was sized for a 16 GiB device and has not
            # been re-decided on the H100 (ROADMAP Queue 1.7).
            band_f32 = (2 * self.band_nb - 1) * self.band_bs \
                * self.band_bs * 4 * self.n_parts
            self._chunk = None
            if (band_f32 > 2 << 30 and self.n_parts > 1
                    and self.factor_dtype in (jnp.float32, jnp.bfloat16)):
                self._chunk = True
        self.l2g = jnp.asarray(p.local_to_global)
        self.local_valid = jnp.asarray(p.local_valid)
        self.mass_img = jnp.asarray(mesh.mass[p.local_to_global]
                                    * p.local_valid, dtype)
        self.dup = jnp.asarray(np.maximum(p.dup, 1), dtype)

        # ---- two-level H0 coarse space ---------------------------------
        # Per-subdomain rigid modes Z (6 per part: 3 translations + 3
        # rotations about the part centroid); the H0 apply adds
        # Z Kc^{-1} Z^T with Kc = Z^T (dt^2 K + M) Z rebuilt alongside the
        # fine factors. Classic two-level DD: the one-level H0 (reference
        # DOTTimeStepper.cpp:618-797 has no coarse grid) degrades as the
        # subdomain count grows — iterations/frame triple from 6 to ~130
        # parts in blockSize mode — because no subdomain solve sees the
        # global low-frequency error. The 6P-dim coarse solve restores
        # them at negligible cost ((6P)^2 dense factor, P <= a few
        # hundred). No reference counterpart by design.
        cw = int(getattr(cfg, "coarse", -1))
        self.use_coarse = (p.part is not None
                           and (cw == 1 or (cw == -1 and p.n_parts >= 16)))
        if self.use_coarse:
            own = np.zeros(mesh.n_vert, np.int32)
            own[mesh.conn.ravel()] = np.repeat(
                p.part, 4).astype(np.int32)          # owner part per vert
            cnt = np.bincount(own, minlength=p.n_parts).astype(np.float64)
            csum = np.zeros((p.n_parts, 3))
            np.add.at(csum, own, mesh.V_rest)
            cent = csum / np.maximum(cnt, 1.0)[:, None]
            xc = mesh.V_rest - cent[own]
            sc = float(np.abs(xc).max()) or 1.0      # condition rot modes
            self.coarse_own = jnp.asarray(own)
            self.coarse_xc = jnp.asarray(xc / sc, dtype)
            # per-corner owner in padded element order (pads -> part 0;
            # their elem_h rows are zero so they contribute nothing)
            self.coarse_own_e = tuple(
                jnp.asarray(own[conn_gather[:, c]].copy())
                for c in range(4))
            # uniform/mixed element split: interior elements (all four
            # corners owned by one part — the bulk) contribute one fused
            # per-element 6x6 to the (p, p) diagonal coarse block, so the
            # 16 per-pair (nEp, 36) stack+scatter passes collapse to one;
            # only boundary-straddling elements walk the 16-pair path,
            # gathered through a compact static index list
            own_e_np = own[conn_gather]                      # (nEp, 4)
            uniform = ((own_e_np[:, 0] == own_e_np[:, 1])
                       & (own_e_np[:, 0] == own_e_np[:, 2])
                       & (own_e_np[:, 0] == own_e_np[:, 3]))
            PP = p.n_parts * p.n_parts
            uid = np.where(uniform,
                           own_e_np[:, 0].astype(np.int64)
                           * (p.n_parts + 1), PP)
            self.coarse_uid = jnp.asarray(uid.astype(np.int32))
            mixed = np.where(~uniform)[0]
            n_mix = max(8, -(-len(mixed) // 256) * 256)
            mix_pad = np.zeros(n_mix, np.int64)
            mix_pad[:len(mixed)] = mixed
            self.coarse_mix_rows = tuple(
                jnp.asarray((mix_pad * 16 + k).astype(np.int32))
                for k in range(16))
            mids = own_e_np[mix_pad]                         # (nMix, 4)
            dump = np.zeros(n_mix, bool)
            dump[len(mixed):] = True
            self.coarse_mix_ids = tuple(tuple(
                jnp.asarray(np.where(
                    dump, PP, mids[:, a].astype(np.int64) * p.n_parts
                    + mids[:, b]).astype(np.int32))
                for b in range(4)) for a in range(4))
            self.coarse_mix_conn = tuple(
                jnp.asarray(conn_gather[mix_pad, c].copy())
                for c in range(4))
        # BLOCK-level assembly plan: gather contiguous 9-wide rows of the
        # block-major element-Hessian buffer in dest-sorted tuple order
        assert 16 * self.n_elem_p < 2**31
        src_block = (p.asm_elem.astype(np.int64) * 16
                     + p.asm_a * 4 + p.asm_b)
        self.asm_src_block = jnp.asarray(
            src_block[p.asm_tuple_perm].astype(np.int32))
        self.asm_block_stage1 = jnp.asarray(p.asm_block_stage1)
        # Subdomain-scan assembly plan for blockSize-scale meshes: the
        # flat gather+segment_sum over ~15M 9-wide rows gathers from one
        # large operand and reduces into one large destination. A
        # lax.scan over subdomains keeps both sides small: OWN-element
        # entries gather from the subdomain's contiguous element slab and
        # reduce into its own ~17K-block compact slice; interface-
        # completion entries (elements owned by neighbors) keep the
        # global gather but share the small per-subdomain reduction.
        # Which of the two forms wins on the GPU, and where, is open
        # (ROADMAP Queue 1.7).
        self.asm_own_idx = None
        if getattr(self, "_chunk", None) is not None:
            self._build_scan_assembly(p)
        self.asm_ub_dest = jnp.asarray(p.asm_ub_dest)
        self.n_unique_blocks = int(p.asm_ub_dest.shape[0]) // 9
        self.gath_perm = jnp.asarray(p.gath_perm)
        self.gath_segids = jnp.asarray(p.gath_segids)
        if getattr(p, "own_udest", None) is not None:
            # own-element-only plan (ADMM-DD local Hessians); scalar-level,
            # indices into the block-major (144, nEp) buffer
            n_own = p.n_own
            i3 = np.arange(3)
            comp = ((p.asm_a[:n_own, None, None] * 4
                     + p.asm_b[:n_own, None, None]) * 9
                    + i3[None, :, None] * 3 + i3[None, None, :])
            gidx = comp.astype(np.int64) * self.n_elem_p \
                + p.asm_elem[:n_own, None, None].astype(np.int64)
            self.own_gather_idx = jnp.asarray(
                gidx.reshape(-1)[p.own_perm].astype(np.int32))
            self.own_stage1 = jnp.asarray(p.own_stage1)
            self.own_udest = jnp.asarray(p.own_udest)
            self.n_own_unique = int(p.own_udest.shape[0])
        if getattr(p, "own_band_dest", None) is not None:
            # BLOCK-level own plan with banded destinations (ADMM-DD local
            # Hessians on banded plans; mirrors _assemble_btd)
            n_own = p.n_own
            self.own_src_block = jnp.asarray(
                src_block[:n_own][p.own_block_perm].astype(np.int32))
            self.own_block_stage1 = jnp.asarray(p.own_block_stage1)
            self.own_band_dest = jnp.asarray(p.own_band_dest)
            self.own_ub_row = jnp.asarray(p.own_ub_row)
            self.own_ub_col = jnp.asarray(p.own_ub_col)
            self.own_diag_ub = jnp.asarray(p.own_diag_ub)
            self.n_own_ub = int(p.own_ub_row.shape[0])
        self._finish_init()

    def _finish_init(self):
        # block-major component -> (row dof, col dof) tables for the
        # quadratic form
        rows, cols = [], []
        for a in range(4):
            for b in range(4):
                for i in range(3):
                    for j in range(3):
                        rows.append(a * 3 + i)
                        cols.append(b * 3 + j)
        self._qf_row = jnp.asarray(np.asarray(rows, np.int32))
        self._qf_col = jnp.asarray(np.asarray(cols, np.int32))
        self._qf_row_host = tuple(rows)
        self._qf_col_host = tuple(cols)
        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()
        self._sqnorm_l = self.mesh.sqnorm_face_area_sums

    # jitted entry points for host-side (eager) callers — calling the
    # SoA kernels op-by-op would dispatch hundreds of tiny programs, so
    # anything used outside the steppers' jitted step goes through these. The System rides through jit as a pytree ARGUMENT
    # (module-level jits), never as baked-in closure constants.
    def rebuild_h0(self, x, fixed):
        return _rebuild_h0_jit(self, x, fixed)

    def compute_x_tilta(self, x_n, v, fixed):
        return _x_tilta_jit(self, x_n, v, fixed)

    def build_pd_factor(self, fixed, w=None):
        _ = self.pd_band_plan   # host-side plan build before the trace
        return _pd_factor_jit(self, fixed, w)

    # ------------------------------------------------------------------
    def _compute_sqnorm_h_rest(self):
        """||dP/dF(I)||_F^2 with the first element's Lame params, no SPD
        projection. At F = I the rotated-basis M *is* dP/dF. Pure numpy —
        the SoA material formulas are plain arithmetic."""
        one = np.ones(1)
        u0 = np.asarray([self.mesh.u[0]])
        l0 = np.asarray([self.mesh.lam[0]])
        s1 = (one, one, one)
        a = self.mat_soa.d2psi(s1, u0, l0)
        dpsi = self.mat_soa.dpsi(s1, u0, l0)
        bl = self.mat_soa.b_left(s1, u0, l0)
        # ||M||_F^2 = ||A||_F^2 + sum_k 2 (L+R)^2 + 2 (L-R)^2
        na = (a[0] ** 2 + 2 * a[1] ** 2 + 2 * a[2] ** 2 + a[3] ** 2
              + 2 * a[4] ** 2 + a[5] ** 2)
        tot = na
        for k, (ci, cj) in enumerate(((0, 1), (1, 2), (2, 0))):
            r = (dpsi[ci] + dpsi[cj]) / (2.0 * (s1[ci] + s1[cj]))
            tot = tot + 2 * (bl[k] + r) ** 2 + 2 * (bl[k] - r) ** 2
        return float(tot[0])

    def target_g_res(self, rel_tol):
        """targetGRes = eps^2 ||H_rest||^2 ||l||^2 (nFree/nV) dt^4
        (reference: computeCharNormSq; energyParamSum == 1)."""
        n_free = self.n_vert - int(np.count_nonzero(self.mesh.fixed_mask))
        # NOTE: the reference evaluates nFree with the *initial* fixed set
        # of the Mesh at stepper-construction time; scripts set it before.
        return (rel_tol * rel_tol * self._sqnorm_H_rest * self._sqnorm_l
                * (n_free / self.n_vert) * self.dt_sq * self.dt_sq)

    # ------------------------------------------------------------------
    # energy / gradient / hessian
    # ------------------------------------------------------------------
    def corner_rows(self, x):
        """Per-corner (nEp, 3) row gathers of x: one gather of 3-wide rows
        from the (nV, 3) layout per corner instead of per-component
        scalar gathers from (3, nV) vectors. Every corner gather goes
        through here."""
        return [x[self.conn_cols[c]] for c in range(4)]

    @staticmethod
    def _corners_soa(rows):
        """4 x (nEp, 3) corner rows -> 12-tuple of (nEp,), order c*3+i."""
        return tuple(rows[c][:, i] for c in range(4) for i in range(3))

    @staticmethod
    def svd_flip(f):
        """Batched flip-SVD of SoA deformation gradients (the dimension
        hook used by the generic quasi-Newton line search)."""
        return soa.svd3_flip_soa(f)

    def fsvd(self, x):
        """SoA deformation gradients + flip-SVD for all elements."""
        f = self.defgrad(x)
        U, s, V = soa.svd3_flip_soa(f)
        return f, U, s, V

    def energy(self, x, x_tilta, sigma):
        """Incremental potential: dt^2 sum w Psi + 1/2 ||x - xt||_M^2
        (reference: Optimizer::computeEnergyVal, Optimizer.cpp:1183-1218)."""
        psi_w = self.mat_soa.psi(sigma, self.u_e, self.lam_e) * self.vol_w
        # reductions in the compute dtype (module docstring: precision)
        e_el = self.dt_sq * jnp.sum(psi_w)
        d = x - x_tilta
        e_in = 0.5 * jnp.sum(self.mass * jnp.sum(d * d, axis=-1))
        return e_el + e_in

    def energy_at(self, x, x_tilta):
        _, _, s, _ = self.fsvd(x)
        return self.energy(x, x_tilta, s), s

    # ---- line-search fast path ---------------------------------------
    # F is homogeneous linear in positions (F = Xt @ restTriInv, edge
    # differences), so F(x0 + a p) = F(x0) + a F(p); and the inertia term
    # is an exact quadratic in a. One gather of p per line search replaces
    # a gather of x per TRIAL, and trials become purely elementwise
    # (SVD + psi).
    def defgrad(self, x):
        """SoA deformation gradients (9-tuple of (nEp,)) at positions (or
        homogeneous direction vectors) x."""
        return self.defgrad_from_corners(self.gather_corners(x))

    def gather_corners(self, x):
        """12-tuple of (nEp,) per-element corner values, order c*3+i —
        the shared gather feeding both the alpha-init quadratic form and
        the line-search direction deformation gradients. Built from 4 row
        gathers (see corner_rows)."""
        return self._corners_soa(self.corner_rows(x))

    def defgrad_from_corners(self, pe):
        """F (9-tuple) from pre-gathered corner values (12, nEp)."""
        e = [[pe[(k + 1) * 3 + i] - pe[i] for i in range(3)]
             for k in range(3)]
        g = self.g9
        return tuple(
            e[0][i] * g[j] + e[1][i] * g[3 + j] + e[2][i] * g[6 + j]
            for i in range(3) for j in range(3))

    def elastic_energy_sigma(self, sigma):
        """dt^2 sum w Psi(sigma) (the elastic half of `energy`)."""
        psi_w = self.mat_soa.psi(sigma, self.u_e, self.lam_e) * self.vol_w
        return self.dt_sq * jnp.sum(psi_w)

    def inertia_quad(self, x0, p, x_tilta):
        """(c0, c1, c2) with  1/2||x0 + a p - xt||_M^2 = c0 + a c1 + a^2 c2."""
        d0 = x0 - x_tilta
        c0 = 0.5 * jnp.sum(self.mass * jnp.sum(d0 * d0, axis=-1))
        c1 = jnp.sum(self.mass * jnp.sum(d0 * p, axis=-1))
        c2 = 0.5 * jnp.sum(self.mass * jnp.sum(p * p, axis=-1))
        return c0, c1, c2

    def gradient(self, x, x_tilta, fixed, F, U, sigma, V):
        """(nV, 3), zero at fixed vertices (Optimizer.cpp:1220-1256).

        The vertex accumulation is ONE unsorted row scatter-add of
        (nEp*4, 3) corner-gradient rows: all 3 dims ride one scatter
        instead of three per-dim perm-gather + sorted-segment-sum
        passes."""
        ge = soa.element_gradient_soa(self.mat_soa, F, U, sigma, V,
                                      self.D_soa, self.u_e, self.lam_e,
                                      self.vol_w)
        # axis-0 stack (contiguous lane writes) + one tiled transpose —
        # stacking lanes on a minor axis emits strided 4-byte writes
        vals = jnp.stack([ge[c][i] for c in range(4)
                          for i in range(3)]).T       # (nEp, 12)
        acc = jnp.zeros((self.n_vert + 1, 3), self.dtype).at[
            self.conn_s.reshape(-1)].add(vals.reshape(-1, 3))
        g = acc[:self.n_vert] * jnp.asarray(self.dt_sq, self.dtype)
        g = g + self.mass[:, None] * (x - x_tilta)
        return jnp.where(fixed[:, None], 0.0, g)

    # element-Hessian storage order: BLOCK-MAJOR — component
    # (a*4+b)*9 + i*3+j holds H[(a,i),(b,j)] so each corner-pair 3x3 block
    # is 9 contiguous rows; the assembly gather then moves contiguous
    # 9-wide rows instead of 13M single scalars.
    @staticmethod
    def _block_major_order():
        order = []
        for a in range(4):
            for b in range(4):
                for i in range(3):
                    for j in range(3):
                        order.append((a * 3 + i) * 12 + b * 3 + j)
        return order

    def element_hessians(self, U, sigma, V):
        """(144, nEp) SPD-projected element Hessians, dt^2-scaled,
        block-major component order (see _block_major_order)."""
        H = soa.element_hessian_soa(self.mat_soa, U, sigma, V, self.D_soa,
                                    self.u_e, self.lam_e, self.vol_w,
                                    project_spd=True)
        Hb = [H[r] for r in self._block_major_order()]
        return jnp.stack(Hb) * jnp.asarray(self.dt_sq, self.dtype)

    # ------------------------------------------------------------------
    # dense subdomain assembly + batched Cholesky
    # ------------------------------------------------------------------
    def _build_scan_assembly(self, p):
        """Host-side build of the per-subdomain scan-assembly arrays (see
        the design note at the call site in __init__)."""
        n_parts = self.n_parts
        N_loc = self.n3 // 3
        src_block = (p.asm_elem.astype(np.int64) * 16
                     + p.asm_a * 4 + p.asm_b)
        sb_sorted = src_block[p.asm_tuple_perm].astype(np.int64)
        st1 = np.asarray(p.asm_block_stage1).astype(np.int64)
        ub_row = np.asarray(p.band_ub_row).astype(np.int64)
        ub_col = np.asarray(p.band_ub_col).astype(np.int64)
        ub_sbd = (ub_row // N_loc).astype(np.int64)
        # LOWER-triangle-only: every consumer of the banded H0 reads the
        # factors, and the whole factorization chain (Jacobi scaling,
        # lax.linalg cholesky/triangular_solve, full SYRK downdates) only
        # reads the lower triangle of the diag blocks — strict-upper
        # vertex blocks (37% of the assembly entries; their band dests
        # are either the dead upper half of a diag block or dropped
        # upper-neighbor slots) are never read, so they are not summed.
        keep = (ub_row % N_loc >= ub_col % N_loc)[st1]
        sb_sorted = sb_sorted[keep]
        st1 = st1[keep]
        e_sbd = ub_sbd[st1]
        m_slab = 16 * p.elem_pad
        own_m = (sb_sorted // m_slab) == e_sbd
        ub_starts = np.searchsorted(ub_sbd, np.arange(n_parts + 1))
        nub_max = int(np.diff(ub_starts).max())
        ub_local = np.arange(len(ub_sbd)) - ub_starts[ub_sbd]
        self.asm_pad2compact = jnp.asarray(
            (ub_sbd * nub_max + ub_local).astype(np.int32))

        # scan GROUP size: the largest divisor of P <= 8 — fewer scan
        # steps amortize the per-step dispatch of the two segment_sums
        # (133 single-subdomain steps paid ~1-2 ms each) while keeping
        # the gathered slab small enough to stay fast
        G = max(g for g in range(1, 9) if n_parts % g == 0)
        n_groups = n_parts // G
        self._asm_G = G

        def pack(mask, local_src):
            sbd_e = e_sbd[mask]
            grp_e = sbd_e // G
            # segment id LOCAL to the group: subdomain-in-group offset
            # nub_max + within-subdomain rank (padded layout preserved)
            seg_l = ((sbd_e % G) * nub_max
                     + st1[mask] - ub_starts[sbd_e]).astype(np.int32)
            src_v = local_src[mask].astype(np.int32)
            starts_e = np.searchsorted(grp_e, np.arange(n_groups + 1))
            A = int(np.diff(starts_e).max())
            A = max(512, -(-A // 512) * 512)
            # pads: source row 0 (real data), dump segment G*nub_max —
            # the dump row is sliced off, so no value masking is needed
            idx = np.zeros((n_groups, A), np.int32)
            seg = np.full((n_groups, A), G * nub_max, np.int32)
            for q in range(n_groups):
                s0, s1 = starts_e[q], starts_e[q + 1]
                idx[q, :s1 - s0] = src_v[s0:s1]
                seg[q, :s1 - s0] = seg_l[s0:s1]
            return jnp.asarray(idx), jnp.asarray(seg)

        self.asm_own_idx, self.asm_own_seg = pack(
            own_m, sb_sorted - (e_sbd // G) * (G * m_slab))
        self.asm_comp_idx, self.asm_comp_seg = pack(~own_m, sb_sorted)
        self._asm_nub_max = nub_max
        self._asm_m_slab = m_slab
        # lower-triangle subset of the band scatter: upper unique blocks
        # hold zeros under this assembly, so scattering them only moves
        # zeros over zeros (~40% of the scalar scatter volume)
        low = (ub_row % N_loc) >= (ub_col % N_loc)
        self.band_low_sel = jnp.asarray(
            np.where(low)[0].astype(np.int32))
        bd = np.asarray(p.band_dest).reshape(-1, 9)
        self.band_low_dest = jnp.asarray(bd[low].reshape(-1))

    def _assembly_compact(self, elem_h):
        """Stage 1 of assembly: gather 9-wide block rows in dest order and
        reduce duplicate (sbd, row, col) blocks with one sorted
        segment-sum. Returns the compact unique-block values.

        At blockSize scale (`_chunk` set) the gather+reduce runs as a
        lax.scan over subdomains (see __init__) — ~10x faster than the
        flat form at 755K tets."""
        eh_rows = elem_h.T.reshape(-1, 9)            # (nEp*16, 9) contiguous
        if self.asm_own_idx is None:
            rows = eh_rows[self.asm_src_block]       # (nAsm, 9)
            return jax.ops.segment_sum(rows, self.asm_block_stage1,
                                       num_segments=self.n_unique_blocks,
                                       indices_are_sorted=True)
        G = self._asm_G
        nubp = G * self._asm_nub_max + 1
        slabs = eh_rows.reshape(self.n_parts // G, G * self._asm_m_slab, 9)

        def body(c, xs):
            slab, oi, os_, ci, cs = xs
            own = jax.ops.segment_sum(slab[oi], os_, num_segments=nubp,
                                      indices_are_sorted=True)
            comp = jax.ops.segment_sum(eh_rows[ci], cs, num_segments=nubp,
                                       indices_are_sorted=True)
            return c, own[:-1] + comp[:-1]

        _, out = jax.lax.scan(body, 0.0, (slabs, self.asm_own_idx,
                                          self.asm_own_seg,
                                          self.asm_comp_idx,
                                          self.asm_comp_seg))
        return out.reshape(-1, 9)[self.asm_pad2compact]

    def _free3(self, fixed):
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        return jnp.repeat(free.astype(self.dtype), 3, axis=-1)  # (P, n3)

    def assemble_subdomains(self, elem_h, fixed):
        """Subdomain Hessians with interface completion, lumped mass on
        free dofs, identity rows for fixed/padding (reference:
        DOTTimeStepper::fillInDecomposedHessians). Dense (P, n3, n3), or
        block-tridiagonal (diag, sub) when the plan is RCM-banded."""
        if self.banded:
            return self._assemble_btd(elem_h, fixed)
        P, n3 = self.n_parts, self.n3
        compact = self._assembly_compact(elem_h)
        # stage 2: unique-destination scatter-set of the blocks' scalars
        Hd = jnp.zeros((P * n3 * n3,), self.dtype).at[self.asm_ub_dest].set(
            compact.reshape(-1), unique_indices=True).reshape(P, n3, n3)

        f3 = self._free3(fixed)
        Hd = Hd * f3[:, :, None] * f3[:, None, :]
        diag = jnp.repeat(self.mass_img, 3, axis=-1) * f3 + (1.0 - f3)
        idx = jnp.arange(n3)
        Hd = Hd.at[:, idx, idx].add(diag)
        return Hd

    def _band_compact(self, elem_h, fixed):
        """Finished compact unique-block values for the banded scatter:
        stage-1 reduction + fixed-dof masking + lumped mass / identity
        diagonals. Everything downstream of this is just a scatter —
        the compact set is ~nnz-sized (MBs) while the padded band is
        GBs, which is what the chunked rebuild exploits."""
        compact = self._assembly_compact(elem_h)       # (nUB, 9)
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        freef = free.astype(self.dtype).reshape(-1)    # (P*nmax,)
        mask = freef[self.band_ub_row] * freef[self.band_ub_col]
        compact = compact * mask[:, None]
        dslot = self.band_ub_row[self.band_diag_ub]
        dvals = (self.mass_img.reshape(-1) * freef + (1.0 - freef))[dslot]
        return compact.at[self.band_diag_ub[:, None],
                          jnp.asarray([0, 4, 8])].add(dvals[:, None])

    def _assemble_btd(self, elem_h, fixed):
        """Block-tridiagonal assembly: same two-stage plan, scattered into
        the flat [diag | sub] banded buffer (upper-neighbor entries are
        dropped out of bounds — their transpose lives in `sub`).

        Fixed-vertex masking and the mass/identity diagonal are applied to
        the COMPACT unique-block values before the scatter (a few MB)
        instead of full passes over the banded buffer; padding rows get
        their unit diagonal from a small static scatter."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        compact = self._band_compact(elem_h, fixed)    # (nUB, 9)

        diag_sz = P * nb * bs * bs
        total = diag_sz + P * (nb - 1) * bs * bs
        # no unique_indices promise here: all dropped upper-neighbor
        # entries share the same out-of-bounds index (`total`), which
        # would violate the uniqueness contract even under drop mode
        flat = jnp.zeros((total,), self.dtype).at[self.band_dest].set(
            compact.reshape(-1), mode="drop")
        flat = flat.at[self.band_pad_diag].set(1.0, unique_indices=True)
        # scan-major: the factorization's lax.scan consumes these views
        # directly (no transposed copies)
        diag = flat[:diag_sz].reshape(nb, P, bs, bs)
        sub = flat[diag_sz:].reshape(nb - 1, P, bs, bs)
        return diag, sub

    def _to_factor_dtype(self, Hn):
        """bfloat16 'factor dtype' means: round the matrix to bf16 and
        factorize in f32 (Cholesky itself has no bf16 kernel) — the
        reduced-precision analog of the reference's incomplete Cholesky
        (LBFGS-HI, LBFGSTimeStepper.cpp:214-233)."""
        if self.factor_dtype == jnp.bfloat16:
            return Hn.astype(jnp.bfloat16).astype(jnp.float32)
        return Hn.astype(self.factor_dtype)

    @property
    def _solve_dtype(self):
        return (jnp.float32 if self.factor_dtype == jnp.bfloat16
                else self.factor_dtype)

    def assemble_subdomains_local_only(self, elem_h, fixed, mass_local):
        """Per-subdomain Hessians from OWN elements only (no interface
        completion) with the subdomain lumped mass — the elasticity+mass
        part of ADMM-DD's augmented local Hessian
        (reference: computeHessianProxy_subdomain, ADMMDDTimeStepper.cpp:1540+)."""
        P, n3 = self.n_parts, self.n3
        flat = elem_h.reshape(-1)[self.own_gather_idx]
        compact = jax.ops.segment_sum(flat, self.own_stage1,
                                      num_segments=self.n_own_unique,
                                      indices_are_sorted=True)
        Hd = jnp.zeros((P * n3 * n3,), self.dtype).at[self.own_udest].set(
            compact, indices_are_sorted=True,
            unique_indices=True).reshape(P, n3, n3)
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        f3 = jnp.repeat(free.astype(self.dtype), 3, axis=-1)
        Hd = Hd * f3[:, :, None] * f3[:, None, :]
        diag = jnp.repeat(mass_local, 3, axis=-1) * f3 + (1.0 - f3)
        idx = jnp.arange(n3)
        return Hd.at[:, idx, idx].add(diag)

    def assemble_own_btd_flat(self, elem_h, fixed, mass_local):
        """Banded local-only assembly (ADMM-DD's augmented local Hessian,
        elasticity+mass part): same two-stage compact-block scheme as
        _assemble_btd restricted to OWN-element tuples, with the
        subdomain lumped mass on free diagonals and unit fixed/padding
        rows. Returns the FLAT [diag | sub] banded buffer so the caller
        can scatter-add W before factorization
        (reference: computeHessianProxy_subdomain,
        ADMMDDTimeStepper.cpp:1540+)."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        eh_rows = elem_h.T.reshape(-1, 9)
        rows = eh_rows[self.own_src_block]
        compact = jax.ops.segment_sum(rows, self.own_block_stage1,
                                      num_segments=self.n_own_ub,
                                      indices_are_sorted=True)
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        freef = free.astype(self.dtype).reshape(-1)
        mask = freef[self.own_ub_row] * freef[self.own_ub_col]
        compact = compact * mask[:, None]
        dslot = self.own_ub_row[self.own_diag_ub]
        dvals = (mass_local.reshape(-1) * freef + (1.0 - freef))[dslot]
        compact = compact.at[self.own_diag_ub[:, None],
                             jnp.asarray([0, 4, 8])].add(dvals[:, None])
        diag_sz = P * nb * bs * bs
        total = diag_sz + P * (nb - 1) * bs * bs
        flat = jnp.zeros((total,), self.dtype).at[self.own_band_dest].set(
            compact.reshape(-1), mode="drop")
        return flat.at[self.band_pad_diag].set(1.0, unique_indices=True)

    def factorize(self, Hd):
        """Jacobi-equilibrated batched Cholesky (exact in factor_dtype).
        Returns (L, d); L is a BTDFactor for banded input."""
        if isinstance(Hd, tuple):
            return self._factorize_btd(*Hd, fast=False)
        idx = jnp.arange(self.n3)
        d = jnp.sqrt(Hd[:, idx, idx])
        dinv = 1.0 / d
        Hn = self._to_factor_dtype(Hd * dinv[:, :, None] * dinv[:, None, :])
        L = jnp.linalg.cholesky(Hn)
        return L, d

    def _factorize_btd(self, diag, sub, fast, allow_cr=True):
        """Block-tridiagonal Cholesky with Jacobi equilibration:
          L_kk L_kk^T = D_k - S_{k-1} S_{k-1}^T,  S_k = A_{k+1,k} L_kk^{-T}
        (a lax.scan over the block index; with `fast`, the trailing SYRK
        updates — the flops bulk — run as bf16 GEMMs with f32
        accumulation, preconditioner-grade like factorize_fast). The
        diagonal factors are then inverted (batched TRSM against I) so
        every solve is a batched matmul instead of a latency-bound
        triangular solve. Exact banded factorization: RCM keeps all
        coupling inside the band, Cholesky fill stays inside it too
        (the CHOLMOD supernodal role, CHOLMODSolver.cpp:136-163)."""
        nb, P, bs = diag.shape[0], diag.shape[1], diag.shape[2]
        i = jnp.arange(bs)
        d = jnp.sqrt(diag[:, :, i, i])                # (nb, P, bs)
        dinv = 1.0 / d
        use_bf16 = fast and self.factor_dtype in (jnp.float32, jnp.bfloat16)
        fdt = self._solve_dtype
        # low-memory regime: when the H0 factors are stored bf16 anyway
        # (the f32 quasi-Newton default), keep the SCAN INPUTS and OUTPUTS
        # bf16 too and upcast per block inside the body. Halves the
        # factorization's peak device memory (the 765K-tet bar's banded
        # buffers are ~9 GiB in f32) at preconditioner-grade precision —
        # same class as the bf16 SYRK + bf16 factor storage.
        lowmem = (fast and self.apply_dtype == jnp.bfloat16
                  and self.factor_dtype in (jnp.float32, jnp.bfloat16))
        out_dt = self.apply_dtype if (fast and self.apply_dtype is not None) \
            else fdt
        eye = jnp.eye(bs, dtype=fdt)

        def factor(shift, bf16_syrk):
            # equilibration fused into the scan-input construction; the
            # inputs arrive SCAN-MAJOR (nb, P, bs, bs) straight from
            # assembly, so there are no transposed copies, and each
            # diagonal factor is inverted IN the scan — peak footprint is
            # ~3x the banded storage (what lets whole-mesh Newton fit
            # monkey18K-class bands in HBM)
            dg = (diag * dinv[:, :, :, None]
                  * dinv[:, :, None, :]).astype(fdt) + shift * eye
            sb = (sub * dinv[1:, :, :, None]
                  * dinv[:-1, :, None, :]).astype(fdt)
            if not fast and self.factor_dtype == jnp.bfloat16:
                # exact-path bf16 emulation: round the equilibrated
                # inputs like the dense exact path does (LBFGS-HI keeps
                # the same effective factor precision banded or dense)
                dg = self._to_factor_dtype(dg)
                sb = self._to_factor_dtype(sb)
            if lowmem:
                dg = dg.astype(jnp.bfloat16)
                sb = sb.astype(jnp.bfloat16)

            def chol_inv(Dk):
                # symmetrize_input=False: reads the lower triangle only
                # (LAPACK potrf semantics) — required with the lower-
                # triangle-only scan assembly (the upper halves of the
                # diag blocks are never filled) and skips a full
                # (A + A^T)/2 pass over the band either way
                Lk = jax.lax.linalg.cholesky(Dk, symmetrize_input=False)
                Li = jax.lax.linalg.triangular_solve(
                    Lk, jnp.broadcast_to(eye, (P, bs, bs)),
                    left_side=True, lower=True)
                return Lk, Li

            def body(Dk, inp):
                Sk, Dn = inp
                Sk = Sk.astype(fdt)    # per-block upcast (no-op unless
                Dn = Dn.astype(fdt)    # lowmem keeps the stack bf16)
                Lk, Li = chol_inv(Dk)
                Ls = jax.lax.linalg.triangular_solve(
                    Lk, Sk, left_side=False, lower=True, transpose_a=True)
                if bf16_syrk:
                    Lb = Ls.astype(jnp.bfloat16)
                    upd = jax.lax.dot_general(
                        Lb, Lb, (((2,), (2,)), ((0,), (0,))),
                        preferred_element_type=jnp.float32).astype(fdt)
                else:
                    upd = jax.lax.dot_general(
                        Ls, Ls, (((2,), (2,)), ((0,), (0,))),
                        preferred_element_type=fdt, precision=HIGHEST)
                return Dn - upd, (Li.astype(out_dt), Ls.astype(out_dt))

            Dlast, (Lis, Lss) = jax.lax.scan(body, dg[0].astype(fdt),
                                             (sb, dg[1:]))
            _, Lilast = chol_inv(Dlast)
            return BTDFactor(linv=jnp.concatenate(
                [Lis, Lilast[None].astype(out_dt)], 0), sub=Lss)

        # cyclic reduction for the quasi-Newton preconditioner factors on
        # deep bands: the scan's nb dependent Cholesky stages are a chain
        # of dependent launches; CR runs ~log2(nb) batched stages (see
        # CRFactor). The exact path keeps the scan, and so do bands whose
        # f32 materialization is large (the 765K-tet whole-mesh class
        # that needs the bf16 low-memory scan) — CR builds at f32 with
        # ~1.5x the band as level storage. The nb >= 8 and 1.5 GiB gates
        # were sized for a 16 GiB device and have not been re-decided on
        # the H100 (ROADMAP Queue 1.8).
        band_f32_bytes = (2 * nb - 1) * P * bs * bs * 4
        use_cr = (allow_cr and fast and nb >= 8
                  and band_f32_bytes < (3 << 30) // 2)

        def build(shift, bf16_gemm):
            if use_cr:
                dg = (diag * dinv[:, :, :, None]
                      * dinv[:, :, None, :]).astype(fdt) + shift * eye
                sb = (sub * dinv[1:, :, :, None]
                      * dinv[:-1, :, None, :]).astype(fdt)
                return self._cr_build(dg, sb, fdt, out_dt, bf16_gemm)
            return factor(shift, bf16_gemm)

        fac = build(0.0, use_bf16)
        if fast:
            # robustness tiers for the PRECONDITIONER factors only:
            # exact-f32 retry, then Levenberg-shifted (tau=1e-4 on the
            # unit-diagonal equilibrated matrix) — same as the dense fast
            # path. The exact (fast=False) factorization surfaces NaN
            # instead, like dense factorize(): Newton's NaN-safe line
            # search is the reference-parity response to a non-SPD step.
            def bad(f):
                return jnp.asarray([jnp.isnan(leaf).any()
                                    for leaf in jax.tree.leaves(f)]).any()

            def tiered(_):
                f1 = build(0.0, False)
                return jax.lax.cond(bad(f1),
                                    lambda _: build(1.0e-4, False),
                                    lambda _: f1, None)

            fac = jax.lax.cond(bad(fac), tiered, lambda _: fac, None)
            # (factors already emitted in out_dt = apply_dtype in-scan)
        return fac, jnp.swapaxes(d, 0, 1).reshape(P, nb * bs)

    # ---- block cyclic reduction (CRFactor) -----------------------------
    @staticmethod
    def _bmm(a, b, ta=False, bf16=False, out=None):
        """Batched (n, P, bs, bs) @ (n, P, bs, X); optional transpose of
        a's matrix dims and bf16 input rounding (f32 accumulation)."""
        acc = jnp.float32 if bf16 else a.dtype
        if bf16:
            a = a.astype(jnp.bfloat16)
            b = b.astype(jnp.bfloat16)
        lhs_c = (2,) if ta else (3,)
        r = jax.lax.dot_general(
            a, b, ((lhs_c, (2,)), ((0, 1), (0, 1))),
            preferred_element_type=acc, precision=HIGHEST)
        return r if out is None else r.astype(out)

    def _cr_build(self, dg, sb, fdt, out_dt, bf16_gemm):
        """CRFactor from EQUILIBRATED scan-major (nb, P, bs, bs) inputs:
        eliminate odd blocks level by level with batched GEMMs until the
        reduced system is <= 4 blocks, then scan-factor the root."""
        P, bs = dg.shape[1], dg.shape[2]
        eye = jnp.eye(bs, dtype=fdt)
        levels = []
        while dg.shape[0] > 4:
            m = dg.shape[0]
            n_odd = m // 2
            n_even = m - n_odd
            Dodd = dg[1::2]
            Slo = sb[0::2][:n_odd]                       # A[j, j-1]
            Shi = sb[1::2]                               # A[j+1, j]
            if Shi.shape[0] < n_odd:                     # last odd = nb-1
                Shi = jnp.concatenate(
                    [Shi, jnp.zeros((1, P, bs, bs), fdt)], axis=0)
            L = jnp.linalg.cholesky(Dodd.reshape(-1, bs, bs))
            Li = jax.lax.linalg.triangular_solve(
                L, jnp.broadcast_to(eye, (n_odd * P, bs, bs)),
                left_side=True, lower=True).reshape(n_odd, P, bs, bs)
            G_lo = self._bmm(Li, Slo)
            G_hi = self._bmm(Li, jnp.swapaxes(Shi, 2, 3))
            A = self._bmm(G_lo, G_lo, ta=True, bf16=bf16_gemm, out=fdt)
            B = self._bmm(G_hi, G_hi, ta=True, bf16=bf16_gemm, out=fdt)
            C = self._bmm(G_hi, G_lo, ta=True, bf16=bf16_gemm, out=fdt)
            nd = dg[0::2]
            nd = nd.at[:n_odd].add(-A)                   # right neighbor
            nd = nd.at[1:].add(-B[:n_even - 1])          # left neighbor
            sb = -C[:n_even - 1]
            dg = nd
            levels.append((Li.astype(out_dt), G_lo.astype(out_dt),
                           G_hi.astype(out_dt)))

        # root: scan-factor the (<= 4)-block system (pre-inverted diags)
        def chol_inv_root(Dk):
            Lk = jnp.linalg.cholesky(Dk)
            return Lk, jax.lax.linalg.triangular_solve(
                Lk, jnp.broadcast_to(eye, (P, bs, bs)),
                left_side=True, lower=True)

        nbr = dg.shape[0]
        lis, lss = [], []
        Dk = dg[0]
        for k in range(nbr):
            Lk, Lik = chol_inv_root(Dk)
            lis.append(Lik.astype(out_dt))
            if k + 1 < nbr:
                Ls = jax.lax.linalg.triangular_solve(
                    Lk, sb[k], left_side=False, lower=True,
                    transpose_a=True)
                lss.append(Ls.astype(out_dt))
                upd = jax.lax.dot_general(
                    Ls, Ls, (((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=fdt, precision=HIGHEST)
                Dk = dg[k + 1] - upd
        root = BTDFactor(
            linv=jnp.stack(lis),
            sub=(jnp.stack(lss) if lss
                 else jnp.zeros((0, P, bs, bs), out_dt)))
        return CRFactor(levels=tuple(levels), root=root)

    def _cr_solve(self, fac, r):
        """Solve against a CRFactor: log-depth forward reduction onto the
        root, root scan solve, log-depth back substitution. r is (Pb, n)
        or (Pb, n, k) like _btd_solve."""
        lv0 = fac.levels[0][0]
        Pb, bs = lv0.shape[1], lv0.shape[2]
        single = r.ndim == 2
        if single:
            r = r[..., None]
        k = r.shape[-1]
        nb = r.shape[1] // bs
        sdt = self._solve_dtype
        rT = jnp.swapaxes(r.astype(sdt).reshape(Pb, nb, bs, k), 0, 1)

        def mm(a, b, ta=False):
            return jax.lax.dot_general(
                a.astype(sdt), b, (((2,) if ta else (3,), (2,)),
                                   ((0, 1), (0, 1))),
                preferred_element_type=sdt, precision=HIGHEST)

        stack = []
        for (Li, G_lo, G_hi) in fac.levels:
            m = rT.shape[0]
            n_odd = m // 2
            n_even = m - n_odd
            z = mm(Li, rT[1::2])                         # Li r_odd
            re = rT[0::2]
            re = re.at[:n_odd].add(-mm(G_lo, z, ta=True))
            re = re.at[1:].add(-mm(G_hi, z, ta=True)[:n_even - 1])
            stack.append((z, m))
            rT = re

        # root solve (scan factor with nb_root blocks, pre-inverted)
        root = fac.root
        nbr = rT.shape[0]
        ys = []
        y_prev = None
        for i in range(nbr):
            t = rT[i]
            if i > 0:
                t = t - jnp.einsum("pij,pjk->pik",
                                   root.sub[i - 1].astype(sdt), y_prev,
                                   preferred_element_type=sdt,
                                   precision=HIGHEST)
            y_prev = jnp.einsum("pij,pjk->pik", root.linv[i].astype(sdt),
                                t, preferred_element_type=sdt,
                                precision=HIGHEST)
            ys.append(y_prev)
        xs = [None] * nbr
        z_next = None
        for i in reversed(range(nbr)):
            t = ys[i]
            if i + 1 < nbr:
                t = t - jnp.einsum("pji,pjk->pik",
                                   root.sub[i].astype(sdt), z_next,
                                   preferred_element_type=sdt,
                                   precision=HIGHEST)
            z_next = jnp.einsum("pji,pjk->pik", root.linv[i].astype(sdt),
                                t, preferred_element_type=sdt,
                                precision=HIGHEST)
            xs[i] = z_next
        xT = jnp.stack(xs)

        for (Li, G_lo, G_hi), (z, m) in zip(reversed(fac.levels),
                                            reversed(stack)):
            n_odd = m // 2
            n_even = m - n_odd
            x_a = xT[:n_odd]                             # even i = (j-1)/2
            x_b = jnp.concatenate(
                [xT[1:], jnp.zeros((n_odd - xT.shape[0] + 1, Pb, bs, k),
                                   xT.dtype)], axis=0)[:n_odd]
            t = z - mm(G_lo, x_a) - mm(G_hi, x_b)
            x_odd = mm(Li, t, ta=True)                   # Li^T t
            full = jnp.zeros((m, Pb, bs, k), xT.dtype)
            full = full.at[0::2].set(xT).at[1::2].set(x_odd)
            xT = full

        out = jnp.swapaxes(xT, 0, 1).reshape(Pb, nb * bs, k)
        return out[..., 0] if single else out

    def factorize_fast(self, Hd):
        """Preconditioner-grade batched Cholesky: right-looking blocked
        factorization whose trailing (SYRK) updates — the flops bulk —
        run as bf16 GEMMs with f32 accumulation. Used for the
        quasi-Newton H0 factors (never for Newton's exact solves); the
        equilibrated matrix keeps the bf16 rounding benign."""
        if isinstance(Hd, tuple):
            return self._factorize_btd(*Hd, fast=True)
        if self.factor_dtype not in (jnp.float32, jnp.bfloat16):
            return self.factorize(Hd)  # f64 parity runs stay exact
        n3 = self.n3
        blk = 768 if n3 % 768 == 0 else 384
        if n3 % blk != 0 or n3 <= blk:
            return self.factorize(Hd)
        idx = jnp.arange(n3)
        d = jnp.sqrt(Hd[:, idx, idx])
        dinv = 1.0 / d
        A = (Hd * dinv[:, :, None] * dinv[:, None, :]).astype(jnp.float32)
        nb = n3 // blk
        # work on a shrinking trailing submatrix so at most ~one full-size
        # temporary is live (the unrolled full-size variant OOMs at 2.4GB/copy)
        panels = []
        for k in range(nb):
            Akk = A[:, :blk, :blk]
            Lkk = jnp.linalg.cholesky(Akk)
            if (k + 1) * blk < n3:
                Pnl = jax.lax.linalg.triangular_solve(
                    Lkk, A[:, blk:, :blk], left_side=False, lower=True,
                    transpose_a=True)
                Pb = Pnl.astype(jnp.bfloat16)
                upd = jax.lax.dot_general(
                    Pb, Pb, (((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)
                A = A[:, blk:, blk:] - upd
                panels.append(jnp.concatenate([Lkk, Pnl], axis=1))
            else:
                panels.append(Lkk)
        # assemble L: panel k occupies rows k*blk.. of column block k
        P_ = Hd.shape[0]
        L = jnp.zeros((P_, n3, n3), jnp.float32)
        for k, pnl in enumerate(panels):
            L = jax.lax.dynamic_update_slice(L, pnl, (0, k * blk, k * blk))
        L = L.astype(self._solve_dtype)

        # Robustness tiers: the bf16 trailing updates can push nearly
        # singular trailing blocks indefinite (observed on extreme-twist
        # states) -> NaN factors. Fall back to the exact f32 Cholesky,
        # then to a Levenberg-shifted one (tau=1e-4 on the unit-diagonal
        # equilibrated matrix barely perturbs the preconditioner).
        # The normalized matrix is (re)built INSIDE the fallback branch:
        # materializing it unconditionally kept a second full-size buffer
        # live on the happy path (2.6 GiB at monkey18K).

        def exact(_):
            Hn0 = Hd * dinv[:, :, None] * dinv[:, None, :]
            L1 = jnp.linalg.cholesky(self._to_factor_dtype(Hn0))

            def shifted(_):
                eye = jnp.eye(n3, dtype=Hn0.dtype) * 1.0e-4
                return jnp.linalg.cholesky(
                    self._to_factor_dtype(Hn0 + eye))

            return jax.lax.cond(jnp.isnan(L1).any(), shifted,
                                lambda _: L1, None)

        L = jax.lax.cond(jnp.isnan(L).any(), exact, lambda _: L, None)
        return L, d

    def solve_local(self, L, r):
        """Solve the factored subdomain systems against equilibrated
        right-hand sides r (Pb, n3) -> (Pb, n3). Dispatches dense
        triangular solves vs the block-tridiagonal matmul scans."""
        if isinstance(L, CRFactor):
            return self._cr_solve(L, r)
        if isinstance(L, BTDFactor):
            return self._btd_solve(L, r)
        rr = r[..., None].astype(self._solve_dtype)
        y = jax.lax.linalg.triangular_solve(L, rr, left_side=True, lower=True)
        z = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                            transpose_a=True)
        return z[..., 0]

    def _btd_solve(self, fac, r):
        """Forward/backward substitution over the block-tridiagonal factor
        as two lax.scans of batched matmuls (the diagonal factors are
        pre-inverted):  y_k = Linv_k (r_k - S_{k-1} y_{k-1}),
                        z_k = Linv_k^T (y_k - S_k^T z_{k+1}).
        r may be (Pb, n) or (Pb, n, k) for multi-rhs (dim-separated)."""
        nb, Pb, bs = fac.linv.shape[0], fac.linv.shape[1], fac.linv.shape[2]
        single = r.ndim == 2
        if single:
            r = r[..., None]
        k = r.shape[-1]
        rT = jnp.swapaxes(r.astype(self._solve_dtype).reshape(Pb, nb, bs, k),
                          0, 1)                       # (nb, Pb, bs, k)
        LiT = fac.linv                                # (nb, Pb, bs, bs)
        ST = fac.sub                                  # (nb-1, Pb, bs, bs)
        zpad = jnp.zeros_like(ST[:1])
        S_prev = jnp.concatenate([zpad, ST], axis=0)  # S_prev[k] = S_{k-1}
        S_next = jnp.concatenate([ST, zpad], axis=0)  # S_next[k] = S_k

        def mv(A, v):
            return jnp.einsum("pij,pjk->pik", A, v,
                              preferred_element_type=self._solve_dtype,
                              precision=HIGHEST)

        def mtv(A, v):
            return jnp.einsum("pji,pjk->pik", A, v,
                              preferred_element_type=self._solve_dtype,
                              precision=HIGHEST)

        def fwd(y_prev, inp):
            Li, rk, S = inp
            y = mv(Li, rk - mv(S, y_prev))
            return y, y

        _, ys = jax.lax.scan(fwd, jnp.zeros_like(rT[0]), (LiT, rT, S_prev))

        def bwd(z_next, inp):
            Li, yk, S = inp
            z = mtv(Li, yk - mtv(S, z_next))
            return z, z

        _, zs = jax.lax.scan(bwd, jnp.zeros_like(rT[0]), (LiT, ys, S_next),
                             reverse=True)
        out = jnp.swapaxes(zs, 0, 1).reshape(Pb, nb * bs, k)
        return out[..., 0] if single else out

    def h0_apply(self, L, d, rhs, kc=None, fixed=None):
        """Per-subdomain backsolve + duplicate averaging
        (reference: DOTTimeStepper::solve_oneStep, DOTTimeStepper.cpp:406-450),
        plus the additive coarse correction Z Kc^{-1} Z^T when a coarse
        factor `kc` is supplied (two-level H0; see _coarse_factor)."""
        P = self.n_parts
        r = rhs[self.l2g] * self.local_valid[..., None]   # (P, N, 3)
        r = r.reshape(P, self.n3) / d
        z = self.solve_local(L, r)
        p_l = (z.astype(self.dtype) / d).reshape(P, -1, 3)
        flatv = p_l.reshape(-1, 3)[self.gath_perm]
        acc = jax.ops.segment_sum(flatv, self.gath_segids,
                                  num_segments=self.n_vert + 1,
                                  indices_are_sorted=True)[:self.n_vert]
        fine = acc[:self.n_vert] / self.dup[:, None]
        if kc is None:
            return fine
        return fine + self._coarse_apply(kc, rhs, fixed)

    def local_gather_one(self, q, l2g_i, valid_i):
        """(nV, 3) -> (n3,) local rhs of ONE subdomain (GSDD sweep)."""
        r = q[l2g_i] * valid_i[:, None]
        return r.reshape(self.n3)

    def local_scatter_one(self, z, l2g_i, valid_i):
        """(n3,) local solution -> zero-extended (nV, 3) direction.
        Padded local slots carry l2g == 0; route them to the dump row
        (n_vert) so they cannot clobber vertex 0's solved direction."""
        p_l = z.reshape(-1, 3) * valid_i[:, None]
        idx = jnp.where(valid_i, l2g_i, self.n_vert)
        p = jnp.zeros((self.n_vert + 1, 3), self.dtype).at[idx].set(p_l)
        return p[:self.n_vert]

    def _coarse_apply(self, kc, rhs, fixed):
        """Z Kc^{-1} Z^T rhs: restrict to the 6P rigid coarse dofs
        (segment sums by owner part), solve the tiny equilibrated dense
        factor, prolong back. Zero rows/cols at fixed vertices keep the
        direction inside the free subspace."""
        Lc, dc = kc
        freef = jnp.logical_not(fixed).astype(self.dtype)[:, None]
        r = (rhs * freef).astype(self.dtype)
        t = jax.ops.segment_sum(r, self.coarse_own,
                                num_segments=self.n_parts)     # (P, 3)
        m = jax.ops.segment_sum(jnp.cross(self.coarse_xc, r),
                                self.coarse_own,
                                num_segments=self.n_parts)     # (P, 3)
        rc = (jnp.concatenate([t, m], axis=1).reshape(-1, 1) / dc[:, None])
        y = jax.lax.linalg.triangular_solve(
            Lc, rc.astype(Lc.dtype), left_side=True, lower=True)
        y = jax.lax.linalg.triangular_solve(
            Lc, y, left_side=True, lower=True, transpose_a=True)
        yc = (y.astype(self.dtype) / dc[:, None]).reshape(self.n_parts, 6)
        yt = yc[:, :3][self.coarse_own]
        yr = yc[:, 3:][self.coarse_own]
        return (yt + jnp.cross(yr, self.coarse_xc)) * freef

    def _coarse_factor(self, elem_h, fixed):
        """Equilibrated dense Cholesky of Kc = Z^T (dt^2 K + M) Z, the
        Galerkin coarse matrix over per-subdomain rigid modes. Built from
        the SAME SPD-projected element Hessians as the fine factors (one
        einsum + scatter-add per corner pair), so H0_2level = H0_fine^{-1}
        + Z Kc^{-1} Z^T stays SPD. Returns (Lc (6P, 6P), dc (6P,))."""
        P = self.n_parts
        freev = jnp.logical_not(fixed).astype(self.dtype)      # (nV,)
        # SoA throughout: every per-element/per-vertex quantity stays a
        # 1-D vector and the tiny 3x3/6x6 tensor indices stay python
        # lists, except for the two (nEp, 12, k) contractions below.
        def smat(x):
            # S(x)[j][k] = (e_k x x)_j — columns are the rotation modes
            x0, x1, x2 = x
            z = jnp.zeros_like(x0)
            return [[z, x2, -x1], [-x2, z, x0], [x1, -x0, z]]

        # uniform (single-owner) elements: per-element M = B^T H_e B as
        # TWO batched contractions into the (p, p) diagonal blocks. A lane
        # formulation of this build has ~1300 elementwise ops over 144
        # input lanes — beyond XLA's fusion operand budget, so each op
        # becomes its own pass over memory. Mixed boundary
        # elements walk the per-pair path on a compact gathered slice
        # (ids -> the dump segment P*P for the uniform/pad lanes).
        xs_u, fs_u = [], []
        for c in range(4):
            idx = self.conn_cols[c]
            xs_u.append([self.coarse_xc[idx, k] for k in range(3)])
            fs_u.append(freev[idx])
        # H as (nEp, 12, 12) in (a, i) x (b, j) order
        Ht = jnp.stack([elem_h[(a * 4 + b) * 9 + i * 3 + j]
                        for a in range(4) for i in range(3)
                        for b in range(4) for j in range(3)]) \
            .T.reshape(-1, 12, 12)
        # B as (nEp, 12, 6): rows (b, j), cols [I | S(x_b)], fs_b-scaled
        bcols = []
        for b in range(4):
            Sb = smat(xs_u[b])
            for j in range(3):
                z = jnp.zeros_like(fs_u[b])
                row = [z, z, z, z, z, z]
                row[j] = fs_u[b]
                for k in range(3):
                    row[3 + k] = fs_u[b] * Sb[j][k]
                bcols.extend(row)
        B = jnp.stack(bcols).T.reshape(-1, 12, 6)
        # broadcast-multiply-reduce, NOT dot_general: millions of tiny
        # (12x12) matmuls make a poor batched GEMM, while mul+reduce
        # fuses into two elementwise passes
        tmp = jnp.sum(Ht[:, :, :, None] * B[:, :, None, :], axis=1)
        Me = jnp.sum(B[:, :, None, :] * tmp[:, :, :, None], axis=1)
        Kc = jax.ops.segment_sum(Me.reshape(-1, 36), self.coarse_uid,
                                 num_segments=P * P + 1)

        # mixed path: per-corner B blocks (nMix, 3, 6) once, then per
        # pair (a <= b) two mul-reduce contractions; the (b, a)
        # contribution is the transposed restack of the same values.
        # (The previous per-pair lane form was ~800 tiny ops — pure
        # dispatch overhead, like the uniform path before the rewrite.)
        eh_rows = elem_h.T.reshape(-1, 9)                  # (nEp*16, 9)
        Bm = []
        for c in range(4):
            idx = self.coarse_mix_conn[c]
            xc = [self.coarse_xc[idx, k] for k in range(3)]
            fc = freev[idx]
            Sc = smat(xc)
            cols = []
            for j in range(3):
                z = jnp.zeros_like(fc)
                row = [z, z, z, z, z, z]
                row[j] = fc
                for k in range(3):
                    row[3 + k] = fc * Sc[j][k]
                cols.extend(row)
            Bm.append(jnp.stack(cols).T.reshape(-1, 3, 6))
        tperm = jnp.asarray([n * 6 + m for m in range(6) for n in range(6)])
        for a in range(4):
            for b in range(a, 4):
                Hab = eh_rows[self.coarse_mix_rows[a * 4 + b]] \
                    .reshape(-1, 3, 3)                     # (nMix, 3, 3)
                tmp = jnp.sum(Hab[:, :, :, None] * Bm[b][:, None, :, :],
                              axis=2)                      # (nMix, 3, 6)
                vals = jnp.sum(Bm[a][:, :, :, None] * tmp[:, :, None, :],
                               axis=1).reshape(-1, 36)     # (nMix, 36)
                Kc = Kc + jax.ops.segment_sum(
                    vals, self.coarse_mix_ids[a][b], num_segments=P * P + 1)
                if b > a:
                    Kc = Kc + jax.ops.segment_sum(
                        vals[:, tperm], self.coarse_mix_ids[b][a],
                        num_segments=P * P + 1)
        Kc = Kc[:P * P].reshape(P, P, 6, 6)
        # lumped-mass term on the diagonal blocks: sum_v m_v B_v^T B_v =
        # m [I, S; S^T, S^T S] (matches the fine assembly's mass on free
        # diagonals)
        fm = freev * self.mass                                 # (nV,)
        zv = jnp.zeros_like(fm)
        Sv = smat([self.coarse_xc[:, k] for k in range(3)])
        top = [[(fm if i == j else zv) for j in range(3)]
               + [fm * Sv[i][k] for k in range(3)] for i in range(3)]
        bot = [[fm * Sv[j][k] for j in range(3)]
               + [fm * (Sv[0][k] * Sv[0][l] + Sv[1][k] * Sv[1][l]
                        + Sv[2][k] * Sv[2][l]) for l in range(3)]
               for k in range(3)]
        mv = jnp.stack([r[n] for r in top + bot
                        for n in range(6)]).T                  # (nV, 36)
        Md = jax.ops.segment_sum(mv, self.coarse_own, num_segments=P)
        Kc = Kc.at[jnp.arange(P), jnp.arange(P)].add(
            Md.reshape(P, 6, 6))
        K = Kc.transpose(0, 2, 1, 3).reshape(6 * P, 6 * P)
        K = 0.5 * (K + K.T)
        # Jacobi equilibration + small shift: rows of fully-fixed parts
        # are ~zero — the unit shift on the equilibrated matrix turns
        # them into identity rows (their coarse correction is ~0)
        diag = jnp.diagonal(K)
        dc = jnp.sqrt(jnp.maximum(diag, 1e-12 * jnp.max(diag)))
        Kn = K / dc[:, None] / dc[None, :]
        Lc = jnp.linalg.cholesky(
            Kn.astype(self._solve_dtype)
            + (1e-4 * jnp.eye(6 * P, dtype=self._solve_dtype)))
        # NaN tier (matches factorize_fast's robustness contract): a
        # bigger shift rescues indefiniteness from f32 roundoff
        Lc = jnp.where(
            jnp.isnan(Lc).any(),
            jnp.linalg.cholesky(
                Kn.astype(self._solve_dtype)
                + 0.05 * jnp.eye(6 * P, dtype=self._solve_dtype)),
            Lc)
        return Lc, dc

    def _rebuild_h0(self, x, fixed):
        """Element Hessians at x + assemble + factorize (one call site for
        precompute, end-of-step update, and BC changes). Returns
        (elem_h, L, d, kc) — kc is the coarse factor or None."""
        _, U, s, V = self.fsvd(x)
        elem_h = self.element_hessians(U, s, V)
        kc = self._coarse_factor(elem_h, fixed) if self.use_coarse else None
        if getattr(self, "_chunk", None) is not None:
            L, d = self._rebuild_banded_chunked(elem_h, fixed)
            return elem_h, L, d, kc
        Hd = self.assemble_subdomains(elem_h, fixed)
        L, d = self.factorize_fast(Hd)
        return elem_h, L, d, kc

    def _rebuild_banded_chunked(self, elem_h, fixed):
        """blockSize-scale banded rebuild: equilibrate the COMPACT
        unique-block values (the dof diagonal is read straight out of the
        compact set), round to bf16, scatter ONCE into a full-size bf16
        band, and run ONE batched lowmem scan factorization over all P
        subdomains. The f32 full band (5+ GB at 755K tets) never exists —
        that is what the round-4 part-axis chunk loop bought, but the
        chunks serialized nchunks*nb dependent Cholesky stages; the bf16
        band halves the storage AND restores the single nb-stage scan
        with batch P, at the same preconditioner-grade precision as the
        lowmem path (bf16 rounding after f32 equilibration)."""
        P, bs, nb = self.n_parts, self.band_bs, self.band_nb
        N = self.n3 // 3
        compact = self._band_compact(elem_h, fixed)       # (nUB, 9)
        # dof diagonal / Jacobi scale from the compact diagonal blocks
        dvals = compact[self.band_diag_ub][:, jnp.asarray([0, 4, 8])]
        dslot = self.band_ub_row[self.band_diag_ub]
        d2 = jnp.ones((P * N, 3), self.dtype).at[dslot].set(
            dvals, unique_indices=True)                   # pads/fixed -> 1
        d = jnp.sqrt(d2.reshape(P, N * 3))
        dinv = (1.0 / d).reshape(P * N, 3)
        sr = dinv[self.band_ub_row]                       # (nUB, 3)
        sc = dinv[self.band_ub_col]
        compact = compact * (sr[:, :, None] * sc[:, None, :]).reshape(-1, 9)

        bdt = (jnp.bfloat16 if self.apply_dtype == jnp.bfloat16
               else self._solve_dtype)
        diag_sz = P * nb * bs * bs
        total = diag_sz + P * (nb - 1) * bs * bs
        vals_low = compact[self.band_low_sel].astype(bdt)
        flat = jnp.zeros((total,), bdt).at[self.band_low_dest].set(
            vals_low.reshape(-1), mode="drop")
        flat = flat.at[self.band_pad_diag].set(1.0, unique_indices=True)
        dg = flat[:diag_sz].reshape(nb, P, bs, bs)
        sb = flat[diag_sz:].reshape(nb - 1, P, bs, bs)

        use_bf16 = self.factor_dtype in (jnp.float32, jnp.bfloat16)
        fac = self._btd_scan_equilibrated(dg, sb, 0.0, use_bf16)

        def bad(f):
            return jnp.asarray([jnp.isnan(leaf).any()
                                for leaf in jax.tree.leaves(f)]).any()

        def tiered(_):
            f1 = self._btd_scan_equilibrated(dg, sb, 0.0, False)
            return jax.lax.cond(
                bad(f1),
                lambda _: self._btd_scan_equilibrated(dg, sb, 1.0e-4,
                                                      False),
                lambda _: f1, None)

        fac = jax.lax.cond(bad(fac), tiered, lambda _: fac, None)
        return fac, d

    def _btd_scan_equilibrated(self, dg, sb, shift, bf16_syrk):
        """Block-tridiagonal Cholesky scan over PRE-EQUILIBRATED
        (possibly bf16) scan-major inputs; the shift rides into each
        upcast diag block (the factorize_fast robustness-tier analog).
        Same math as _factorize_btd's scan body."""
        P, bs = dg.shape[1], dg.shape[2]
        fdt = self._solve_dtype
        out_dt = self.apply_dtype or fdt
        eye = jnp.eye(bs, dtype=fdt)
        sh = jnp.asarray(shift, fdt) * eye

        def chol_inv(Dk):
            Lk = jax.lax.linalg.cholesky(Dk, symmetrize_input=False)
            Li = jax.lax.linalg.triangular_solve(
                Lk, jnp.broadcast_to(eye, (P, bs, bs)),
                left_side=True, lower=True)
            return Lk, Li

        def body(Dk, inp):
            Sk, Dn = inp
            Sk = Sk.astype(fdt)
            Dn = Dn.astype(fdt) + sh
            Lk, Li = chol_inv(Dk)
            Ls = jax.lax.linalg.triangular_solve(
                Lk, Sk, left_side=False, lower=True, transpose_a=True)
            if bf16_syrk:
                Lb = Ls.astype(jnp.bfloat16)
                upd = jax.lax.dot_general(
                    Lb, Lb, (((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32).astype(fdt)
            else:
                upd = jax.lax.dot_general(
                    Ls, Ls, (((2,), (2,)), ((0,), (0,))),
                    preferred_element_type=fdt, precision=HIGHEST)
            return Dn - upd, (Li.astype(out_dt), Ls.astype(out_dt))

        Dlast, (Lis, Lss) = jax.lax.scan(body, dg[0].astype(fdt) + sh,
                                         (sb, dg[1:]))
        _, Lilast = chol_inv(Dlast)
        return BTDFactor(linv=jnp.concatenate(
            [Lis, Lilast[None].astype(out_dt)], 0), sub=Lss)

    # ------------------------------------------------------------------
    # warm start (Optimizer::initX, Optimizer.cpp:441-582)
    # ------------------------------------------------------------------
    def warm_start(self, option, x, v, dx_elastic, fixed, x_tilta=None):
        free = jnp.logical_not(fixed)[:, None]
        if option == 0:
            return x
        if option == 1:
            d = self.dt * v
        elif option == 2:
            d = self.dt * v + self.grav_dt_sq
        elif option == 3:
            d = self.dt * v + self.grav_dt_sq + dx_elastic
        elif option == 4:
            d = self.dt * v + self.grav_dt_sq + 0.5 * dx_elastic
        elif option == 5:
            # Jacobi-preconditioned first step (Optimizer.cpp:545-582):
            # d_i = -g_i / H_ii at the last-timestep configuration
            F, U, s, V = self.fsvd(x)
            g = self.gradient(x, x_tilta, fixed, F, U, s, V)
            elem_h = self.element_hessians(U, s, V)
            d = -g / self.hessian_diag(elem_h)
        else:
            raise NotImplementedError(f"warmStart {option}")
        return x + jnp.where(free, d, 0.0)

    def hessian_diag(self, elem_h):
        """(nV, 3) diagonal of mass + dt^2-weighted elastic Hessian
        (the computePrecondMtr diagonal read by warmStart 5,
        Optimizer.cpp:545-582). Block-major comp (c*4+c)*9 + 4i is the
        (corner c, coord i) diagonal entry."""
        cols = []
        for i in range(3):
            vals = jnp.stack([elem_h[(c * 4 + c) * 9 + 4 * i]
                              for c in range(4)],
                             axis=1).reshape(-1)[self.scat_perm]
            acc = jax.ops.segment_sum(vals, self.scat_segids,
                                      num_segments=self.n_vert + 1,
                                      indices_are_sorted=True)
            cols.append(acc[:self.n_vert])
        return jnp.stack(cols, axis=-1) + self.mass[:, None]

    # ------------------------------------------------------------------
    def quadratic_form(self, elem_h, p, pe=None):
        """p^T H_tr p including mass diagonal (alpha-init,
        Optimizer.cpp:1075-1093). elem_h is the block-major (144, nEp)
        SoA buffer; pass pre-gathered corners pe to reuse the gather."""
        if pe is None:
            pe = self.gather_corners(p)
        # ONE fused multiply-reduce over the whole (144, nEp) buffer: the
        # row/col corner values are expanded by two 144-row gathers from
        # the 12-row pe array (contiguous row copies), so the contraction
        # is a single elementwise-multiply + full reduction instead of a
        # 144-long sequential accumulation chain (each chain step its own
        # serialized pass over memory)
        pe_arr = jnp.stack(pe)                      # (12, nEp)
        pr = pe_arr[self._qf_row]                   # (144, nEp)
        pc = pe_arr[self._qf_col]
        q_el = jnp.sum(elem_h * pr * pc)
        q_m = jnp.sum(self.mass[:, None] * p * p)
        return q_el + q_m

    def system_energy(self, x, x_n, sigma):
        """Diagnostic total energy: elastic + kinetic + potential
        (reference: computeSystemEnergy, Optimizer.cpp:1310-1328)."""
        psi_w = self.mat_soa.psi(sigma, self.u_e, self.lam_e) * self.vol_w
        e = jnp.sum(psi_w.astype(F64))
        d = (x - x_n).astype(F64)
        e += jnp.sum(self.mass.astype(F64)
                     * (0.5 * jnp.sum(d * d, axis=-1) / self.dt_sq
                        - (x.astype(F64) @ self.gravity.astype(F64))))
        return e

    # ------------------------------------------------------------------
    # LBFGS-PD fixed initializer: M + dt^2 D^T W D, scalar per coordinate
    # (reference: LBFGSTimeStepper::precompute, LBFGSTimeStepper.cpp:113-194)
    # ------------------------------------------------------------------
    @property
    def pd_band_plan(self):
        """Lazy whole-mesh scalar RCM-banded plan for the PD matrix (None
        for meshes too small to band). Built host-side once; its index
        arrays are attached as device-array attributes so they enter
        jitted programs as pytree-leaf ARGUMENTS, not constants."""
        if not hasattr(self, "_pd_band_plan"):
            from .. import partition
            self._pd_band_plan = partition.build_pd_band_plan(
                self._conn_scatter_np, self.n_vert)
        bp = self._pd_band_plan
        if bp is not None and "pd_dest" not in self.__dict__:
            self.pd_dest = jnp.asarray(bp.dest)
            self.pd_diag_dest = jnp.asarray(bp.diag_dest)
            self.pd_pad_dest = jnp.asarray(bp.pad_dest)
            self.pd_perm = jnp.asarray(bp.perm)
        return bp

    def _pd_pair_vals(self, w, free):
        """(16, nEp) per-element (a, b) scalar values w_e sum_i D_a.D_b,
        masked to free x free vertex pairs."""
        if w is None:
            # LBFGS-PD weights: vol * (2 mu + lambda) (LBFGSTimeStepper.cpp:144)
            w = self.vol_w * (2.0 * self.u_e + self.lam_e) \
                * jnp.asarray(self.dt_sq, self.dtype)
        fr = [free[self.conn_cols[c]] for c in range(4)]
        return jnp.stack([
            w * sum(self.D_soa[a][i] * self.D_soa[b][i] for i in range(3))
            * fr[a] * fr[b]
            for a in range(4) for b in range(4)])

    def _build_pd_factor(self, fixed, w=None):
        nv = self.n_vert
        free = jnp.logical_not(fixed).astype(self.dtype)
        bp = self.pd_band_plan
        if bp is not None:
            vals = self._pd_pair_vals(w, free)
            flat = jnp.zeros((bp.total,), self.dtype).at[
                self.pd_dest].add(vals, mode="drop")
            mvals = self.mass * free + (1.0 - free)
            flat = flat.at[self.pd_diag_dest].add(
                mvals, unique_indices=True)
            flat = flat.at[self.pd_pad_dest].set(
                1.0, unique_indices=True)
            diag_sz = bp.nb * bp.bs * bp.bs
            # scan-major with P = 1 (same linear buffer as P-major)
            diag = flat[:diag_sz].reshape(bp.nb, 1, bp.bs, bp.bs)
            sub = flat[diag_sz:].reshape(bp.nb - 1, 1, bp.bs, bp.bs)
            return self._factorize_btd(diag, sub, fast=False)
        # dense fallback (small meshes)
        B = jnp.zeros(((nv + 1) * (nv + 1),), self.dtype)
        vals = self._pd_pair_vals(w, free)
        for a in range(4):
            for b in range(4):
                idx = (self.conn_s[:, a].astype(jnp.int64) * (nv + 1)
                       + self.conn_s[:, b])
                B = B.at[idx].add(vals[a * 4 + b])
        B = B.reshape(nv + 1, nv + 1)[:nv, :nv]
        diag = self.mass * free + (1.0 - free)
        B = B.at[jnp.arange(nv), jnp.arange(nv)].add(diag)
        d = jnp.sqrt(B[jnp.arange(nv), jnp.arange(nv)])
        dinv = 1.0 / d
        L = jnp.linalg.cholesky(
            self._to_factor_dtype(B * dinv[:, None] * dinv[None, :]))
        return L, d

    def pd_solve(self, L, d, rhs):
        """Dim-separated solves against the fixed PD factor (reference:
        Optimizer::dimSeparatedSolve, Optimizer.cpp:883-1020)."""
        if isinstance(L, BTDFactor):
            bp = self.pd_band_plan
            perm = self.pd_perm
            rp = jnp.zeros((bp.nv_p, 3), self.dtype).at[perm].set(rhs)
            rp = rp / d[0][:, None]
            z = self._btd_solve(L, rp[None])[0]
            z = z.astype(self.dtype) / d[0][:, None]
            return z[perm]
        r = (rhs / d[:, None]).astype(self._solve_dtype)
        y = jax.lax.linalg.triangular_solve(L, r, left_side=True, lower=True)
        z = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                            transpose_a=True)
        return z.astype(self.dtype) / d[:, None]

    # ------------------------------------------------------------------
    def init_state(self, script_data):
        """Initial SimState (reference: Optimizer ctor + precompute)."""
        dtype = self.dtype
        x = jnp.asarray(script_data.x0, dtype)
        fixed = jnp.asarray(script_data.fixed0)
        v = jnp.zeros((self.n_vert, 3), dtype)
        x_tilta = self.compute_x_tilta(x, v, fixed)
        elem_h, L, d, kc = self.rebuild_h0(x, fixed)
        m = LBFGS_HISTORY
        return SimState(
            x=x, x_n=jnp.copy(x), v=v, x_tilta=x_tilta,
            dx_elastic=jnp.zeros((self.n_vert, 3), dtype),
            fixed=fixed,
            vel_sign=jnp.asarray(1.0, dtype),
            released=jnp.asarray(False),
            elem_h=elem_h, chol=L, equil=d,
            lb_s=jnp.zeros((m, self.n_vert, 3), dtype),
            lb_t=jnp.zeros((m, self.n_vert, 3), dtype),
            lb_rho=jnp.ones((m,), dtype),
            lb_valid=jnp.zeros((m,), dtype),
            kc_chol=kc,
        )

    def _compute_x_tilta(self, x_n, v, fixed):
        """x~ = x^n + dt v + dt^2 g (free), x^n (fixed)
        (reference: computeXTilta, Optimizer.cpp:584-610)."""
        return jnp.where(fixed[:, None], x_n,
                         x_n + self.dt * v + self.grav_dt_sq)

    def be_update(self, state, x_new):
        """Backward-Euler end-of-step update (Optimizer.cpp:354-361)."""
        dx_el = x_new - state.x_tilta
        v = (x_new - state.x_n) / self.dt
        x_tilta = self.compute_x_tilta(x_new, v, state.fixed)
        # optimization_barrier keeps x_n a DISTINCT output buffer (jit
        # would otherwise alias the duplicated output, breaking the next
        # step's donation)
        return state._replace(x=x_new,
                              x_n=jax.lax.optimization_barrier(x_new),
                              v=v, dx_elastic=dx_el, x_tilta=x_tilta)


def dedupe_for_donation(state):
    """Copy any pytree leaf that shares a device buffer with an earlier
    leaf. be_update returns x and x_n from the same value, so jit dedupes
    them into ONE buffer — donating that state would otherwise fail
    ('attempt to donate the same buffer twice' / backend InvalidArgument).
    The occasional (nV, 3) copy is trivial next to the factor memory
    donation reclaims."""
    seen = set()

    def f(a):
        if isinstance(a, jax.Array):
            p = a.unsafe_buffer_pointer()
            if p in seen:
                return jnp.copy(a)
            seen.add(p)
        return a

    return jax.tree.map(f, state)


# ---------------------------------------------------------------------------
# Module-level jitted entries: the System rides through as a pytree
# argument (see StaticPytree), so these share one trace per (shapes,
# System identity) and bake no plan constants into the program.
# ---------------------------------------------------------------------------
@jax.jit
def _rebuild_h0_jit(sys, x, fixed):
    return sys._rebuild_h0(x, fixed)


@jax.jit
def _x_tilta_jit(sys, x_n, v, fixed):
    return sys._compute_x_tilta(x_n, v, fixed)


@jax.jit
def _pd_factor_jit(sys, fixed, w):
    return sys._build_pd_factor(fixed, w)
