"""2D (DIM=2) simulation pipeline: triangle meshes, sigma-space energies,
projected-Newton time stepping, scene scripts, and the per-run output
contract.

The reference is dimension-templated: `Mesh<2>` builds triangle meshes
from 2D primitives (grid / square / rectangle / spikes / Sharkey /
cylinder, Mesh.cpp:110-435), the energies carry dim==2 branches
(Energy.cpp, FixedCoRotEnergy.cpp, StableNHEnergy.cpp), SPD projection
uses makePD2d (IglUtils.hpp:276-308), and the same Optimizer outer loop
drives 6-dof triangle elements. The shipped binary is DIM=3; this module
restores the 2D source capability:

- geometry/kernels: `kernels/soa2d.py` (2x2 flip-SVD, sigma-space
  materials, 6x6 SPD element Hessians, SoA lanes);
- positions stay (nV, 3) with a frozen z row so the AnimScripter
  (`scripts.py`), OBJ/status writers, and renderer are reused verbatim
  (the reference's 2D viewer path draws the same z=0 plane);
- the solver operates on the 2 nV in-plane dofs: dense equilibrated
  Cholesky refactorized every Newton iteration (needRefactorize,
  FixedCoRotEnergy.cpp:285-295) — 2D scenes are orders of magnitude
  smaller than the tet scenes, so the dense whole-mesh factor is the
  right shape (one batched factorization, no partitioning needed).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import mesh_gen, scripts
from . import io as meshio
from .kernels import soa2d
from .steppers.admm import ADMMPDStepper, _solve_sym2
from .steppers.core import (F64, HIGHEST, GRAVITY_Y, INNER_ITER_CAP,
                            LINE_SEARCH_CAP, REL_EDEC_STOP, STATS_CAP,
                            StaticPytree, StepStats)

_GEN_2D = {
    "grid": mesh_gen.grid_2d,
    "square": mesh_gen.square_2d,
    "rectangle": mesh_gen.rectangle_2d,
    "cylinder": mesh_gen.cylinder_2d,
    "spikes": mesh_gen.spikes_2d,
    "Sharkey": mesh_gen.sharkey_2d,
}


def is_2d_shape(shape: str) -> bool:
    return shape in _GEN_2D


class Mesh2D:
    """Triangle mesh state (reference: Mesh<2>, Mesh.cpp:110-435,
    552-700 for the dim-generic features)."""

    def __init__(self, V, F, border=None, ym=1.0e5, pr=0.4, rho=1000.0):
        V = np.asarray(V, np.float64)
        if V.shape[1] == 2:
            V = np.concatenate([V, np.zeros((len(V), 1))], axis=1)
        F = np.asarray(F, np.int64)
        # positive orientation (reference checks det > 0, Mesh.cpp:788+)
        e1 = V[F[:, 1], :2] - V[F[:, 0], :2]
        e2 = V[F[:, 2], :2] - V[F[:, 0], :2]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        flip = det < 0
        F[flip] = F[flip][:, [0, 2, 1]]

        self.V = V
        self.V_rest = V.copy()
        self.conn = F
        self.SF = F                    # surface == the mesh itself in 2D
        self.n_vert = len(V)
        self.n_elem = len(F)

        X0 = np.stack([V[F[:, 1], :2] - V[F[:, 0], :2],
                       V[F[:, 2], :2] - V[F[:, 0], :2]], axis=-1)
        det = np.linalg.det(X0)
        assert (det > 0).all(), "degenerate triangle in 2D mesh"
        self.rest_tri_inv = np.linalg.inv(X0)
        self.area = det / 2.0          # vol analog (Mesh.cpp:620-640)
        self.rho = rho
        self.mass = np.zeros(self.n_vert)
        np.add.at(self.mass, F.ravel(),
                  np.repeat(self.area * rho / 3.0, 3))
        self.set_lame(ym, pr)

        # characteristic-tolerance length field: per-vertex sums of
        # opposite-edge lengths (the dim-2 "face areas",
        # computeCharNormSq analog, Optimizer.cpp:612-651)
        p = V[F]
        ls = np.zeros(self.n_vert)
        for c, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
            ls_e = np.linalg.norm(p[:, j, :2] - p[:, i, :2], axis=-1)
            np.add.at(ls, F[:, c], ls_e)
        self.sqnorm_face_area_sums = float(np.sum(ls * ls))

        self.border_verts = (border if border is not None
                             else [np.empty(0, np.int64)] * 2)
        self.fixed_mask = np.zeros(self.n_vert, bool)

    def set_lame(self, ym, pr):
        self.ym, self.pr = ym, pr
        self.u = np.full(self.n_elem, ym / (2.0 * (1.0 + pr)))
        self.lam = np.full(self.n_elem,
                           ym * pr / ((1.0 + pr) * (1.0 - 2.0 * pr)))

    @property
    def bbox(self):
        return np.stack([self.V.min(axis=0), self.V.max(axis=0)])

    def find_border_verts(self, handle_ratio):
        lo, hi = self.V[:, 0].min(), self.V[:, 0].max()
        rng = hi - lo
        self.border_verts = [
            np.where(self.V[:, 0] < lo + rng * handle_ratio)[0],
            np.where(self.V[:, 0] > hi - rng * handle_ratio)[0],
        ]
        return self.border_verts

    @classmethod
    def from_config(cls, cfg):
        """Build the scene's 2D primitive (reference: Mesh.cpp:110-435
        via main.cpp shape dispatch; `resolution` = target element
        count, `size` = extent)."""
        gen = _GEN_2D[cfg.shape]
        V, F, border = gen(size=cfg.size, elem_amt=cfg.resolution)
        mesh = cls(V, F, border=border, ym=cfg.ym, pr=cfg.pr, rho=cfg.rho)
        if not len(border[0]):
            mesh.find_border_verts(cfg.handle_ratio)
        return mesh


class Sim2DState(NamedTuple):
    x: jax.Array           # (nV, 3), z frozen at 0
    x_n: jax.Array
    v: jax.Array
    x_tilta: jax.Array
    dx_elastic: jax.Array
    fixed: jax.Array
    vel_sign: jax.Array
    released: jax.Array


class Plan2D(NamedTuple):
    """Static 2D decomposition plan: RCB element partition, overlapping
    local vertex maps, interface-completion assembly tuples, and dense
    scatter destinations. The 2D analog of partition.SubdomainPlan
    (reference partition semantics: DOTTimeStepper.cpp:618-797 at DIM=2
    via the dimension template DOTTimeStepper.cpp:853) — dense-only,
    because 2D scenes are orders of magnitude smaller than the tet
    scenes (a few-hundred-dof subdomain matrix is one small batched
    factorization)."""
    n_parts: int
    n_local_max: int
    n2: int                       # 2 * n_local_max (padded)
    part: np.ndarray              # (nE,)
    local_to_global: np.ndarray   # (P, N) i32, pad -> 0
    local_valid: np.ndarray       # (P, N) bool
    dup: np.ndarray               # (nV,)
    asm_src: np.ndarray           # (nTup*4,) flat index into elem_h (36*nE)
    asm_dest: np.ndarray          # (nTup*4,) flat dest into (P*n2*n2)
    gath_perm: np.ndarray         # (P*N,)
    gath_segids: np.ndarray       # (P*N,)


def _completion_tuples_2d(conn, part, locals_, g2l, dup, n_parts, n_vert):
    """Interface-completion tuples at dim 2: for (subdomain p, shared
    local vertex v, incident element e NOT owned by p, corner a of e at
    v) the missing diagonal block (a, a) at (lv, lv) plus off-diagonal
    blocks toward the element's other corners that are also local to p
    (reference: fillInDecomposedHessians, DOTTimeStepper.cpp:694-788 at
    DIM=2; the same tuples weight ADMM-DD's interface matrices,
    ADMMDDTimeStepper.cpp:894-1033)."""
    if n_parts <= 1:
        z = np.empty(0, np.int32)
        return z, np.empty(0, np.int64), z, z, z, z
    flat = conn.ravel()
    order = np.argsort(flat, kind="stable")
    inc_elem = order // 3
    inc_corner = (order % 3).astype(np.int32)
    starts = np.searchsorted(flat[order], np.arange(n_vert + 1))
    deg = (starts[1:] - starts[:-1]).astype(np.int64)
    is_shared = dup > 1
    pr_l, vr_l = [], []
    for p in range(n_parts):
        sv = locals_[p][is_shared[locals_[p]]]
        pr_l.append(np.full(len(sv), p, np.int32))
        vr_l.append(sv.astype(np.int64))
    pv_p = np.concatenate(pr_l)
    pv_v = np.concatenate(vr_l)
    reps = deg[pv_v]
    pair_p = np.repeat(pv_p, reps)
    idx = (np.repeat(starts[pv_v], reps)
           + (np.arange(reps.sum()) - np.repeat(
               np.cumsum(reps) - reps, reps)))
    pair_e = inc_elem[idx]
    pair_a = inc_corner[idx]
    keep = part[pair_e] != pair_p
    pair_p, pair_e, pair_a = pair_p[keep], pair_e[keep], pair_a[keep]
    pair_v = np.repeat(pv_v, reps)[keep]
    lv = g2l[pair_p, pair_v]
    b3 = np.arange(3, dtype=np.int32)
    w = conn[pair_e][:, b3]
    lw = g2l[pair_p[:, None], w]
    okb = (lw >= 0) & (b3[None, :] != pair_a[:, None])
    okb[np.arange(len(pair_a)), pair_a] = True     # diagonal (a, a)
    lw[np.arange(len(pair_a)), pair_a] = lv
    pi, bj = np.nonzero(okb)
    return (pair_p[pi], pair_e[pi].astype(np.int64), pair_a[pi],
            bj.astype(np.int32), lv[pi], lw[pi, bj])


def build_plan_2d(mesh: Mesh2D, n_parts: int) -> Plan2D:
    """Partition the triangle mesh and emit the full static assembly plan
    with DOT's interface completion: each subdomain's matrix carries, for
    every shared (interface) vertex, the missing diagonal + interface-
    interface off-diagonal 2x2 blocks of elements owned by OTHER
    subdomains, so each local factor sees the full stencil
    (reference: fillInDecomposedHessians, DOTTimeStepper.cpp:618-797).

    The partition is recursive coordinate bisection over triangle
    centroids — near-optimal on these small planar meshes (the reference
    uses METIS k-way; RCB's planar cuts match it on 2D geometry)."""
    from .partition import rcb_partition

    conn = mesh.conn.astype(np.int64)
    n_elem, n_vert = mesh.n_elem, mesh.n_vert
    if n_parts <= 1:
        part = np.zeros(n_elem, np.int32)
        n_parts = 1
    else:
        cent = mesh.V_rest[conn].mean(axis=1)
        part = rcb_partition(cent, n_parts)

    by_part = [np.where(part == p)[0] for p in range(n_parts)]
    assert all(len(e) for e in by_part), "empty 2D subdomain"
    locals_ = [np.unique(conn[e].ravel()) for e in by_part]
    g2l = np.full((n_parts, n_vert), -1, np.int32)
    for p, l in enumerate(locals_):
        g2l[p, l] = np.arange(len(l), dtype=np.int32)
    dup = np.zeros(n_vert, np.int32)
    for l in locals_:
        dup[l] += 1

    # own-element tuples: all 9 corner pairs per triangle
    own_sbd = np.repeat(part, 9).astype(np.int32)
    own_elem = np.repeat(np.arange(n_elem, dtype=np.int64), 9)
    corners = np.indices((3, 3)).reshape(2, 9).T
    own_a = np.tile(corners[:, 0], n_elem).astype(np.int32)
    own_b = np.tile(corners[:, 1], n_elem).astype(np.int32)
    own_row = g2l[own_sbd, conn[own_elem, own_a]]
    own_col = g2l[own_sbd, conn[own_elem, own_b]]

    c_sbd, c_elem, c_a, c_b, c_row, c_col = _completion_tuples_2d(
        conn, part, locals_, g2l, dup, n_parts, n_vert)

    asm_sbd = np.concatenate([own_sbd, c_sbd]).astype(np.int64)
    asm_elem = np.concatenate([own_elem, c_elem])
    asm_a = np.concatenate([own_a, c_a]).astype(np.int64)
    asm_b = np.concatenate([own_b, c_b]).astype(np.int64)
    asm_row = np.concatenate([own_row, c_row]).astype(np.int64)
    asm_col = np.concatenate([own_col, c_col]).astype(np.int64)

    return _finish_plan_2d(n_parts, n_elem, n_vert, part, locals_, dup,
                           asm_sbd, asm_elem, asm_a, asm_b, asm_row,
                           asm_col)


def _finish_plan_2d(n_parts, n_elem, n_vert, part, locals_, dup,
                    asm_sbd, asm_elem, asm_a, asm_b, asm_row, asm_col):
    """Turn assembly tuples into the flat scalar scatter plan (shared by
    the overlapping element plan and the disjoint node plan)."""
    n_local_max = max(len(l) for l in locals_)
    n2 = -(-2 * n_local_max // 64) * 64            # pad to a multiple of 64
    n_local_max = n2 // 2
    local_to_global = np.zeros((n_parts, n_local_max), np.int32)
    local_valid = np.zeros((n_parts, n_local_max), bool)
    for p, l in enumerate(locals_):
        local_to_global[p, :len(l)] = l
        local_valid[p, :len(l)] = True

    # per-scalar gather/scatter: component (a*3+b)*4 + i*2+j of element e
    # lands at sbd*(n2^2) + (row*2+i)*n2 + col*2+j
    ij = np.indices((2, 2)).reshape(2, 4).T            # (4, 2)
    i4 = ij[:, 0][None, :]
    j4 = ij[:, 1][None, :]
    comp = (asm_a * 3 + asm_b)[:, None] * 4 + i4 * 2 + j4   # (nTup, 4)
    asm_src = (comp * n_elem + asm_elem[:, None]).reshape(-1)
    dest = (asm_sbd[:, None] * (n2 * n2)
            + (asm_row[:, None] * 2 + i4) * n2
            + asm_col[:, None] * 2 + j4).reshape(-1)
    dt_idx = np.int32 if n_parts * n2 * n2 < 2 ** 31 else np.int64
    l2g_flat = local_to_global.reshape(-1).astype(np.int64).copy()
    l2g_flat[~local_valid.reshape(-1)] = n_vert        # dump slot
    gath_perm = np.argsort(l2g_flat, kind="stable").astype(np.int32)
    gath_segids = l2g_flat[gath_perm].astype(np.int32)
    return Plan2D(
        n_parts=n_parts, n_local_max=n_local_max, n2=n2, part=part,
        local_to_global=local_to_global, local_valid=local_valid, dup=dup,
        asm_src=asm_src.astype(np.int32 if 36 * n_elem < 2 ** 31
                               else np.int64),
        asm_dest=dest.astype(dt_idx),
        gath_perm=gath_perm, gath_segids=gath_segids)


def build_node_plan_2d(mesh: Mesh2D, n_parts: int) -> Plan2D:
    """Disjoint NODE partition at dim 2 for the LBFGS-JH block-Jacobi
    initializer (reference: METIS::partMesh_nodes +
    LBFGSTimeStepper.cpp:70-95 at the DIM=2 instantiation): every vertex
    belongs to exactly one block (dup == 1); an element contributes its
    (a, b) 2x2 block iff both endpoints are in the same block."""
    from .partition import rcb_partition

    conn = mesh.conn.astype(np.int64)
    n_elem, n_vert = mesh.n_elem, mesh.n_vert
    vpart = (rcb_partition(mesh.V_rest, n_parts).astype(np.int32)
             if n_parts > 1 else np.zeros(n_vert, np.int32))
    n_parts = max(int(vpart.max()) + 1, 1)

    locals_ = [np.where(vpart == p)[0] for p in range(n_parts)]
    assert all(len(l) for l in locals_), "empty 2D node block"
    g2l = np.full(n_vert, -1, np.int32)
    for l in locals_:
        g2l[l] = np.arange(len(l), dtype=np.int32)

    corners = np.indices((3, 3)).reshape(2, 9).T
    aa = np.tile(corners[:, 0], n_elem).astype(np.int32)
    bb = np.tile(corners[:, 1], n_elem).astype(np.int32)
    ee = np.repeat(np.arange(n_elem, dtype=np.int64), 9)
    va = conn[ee, aa]
    vb = conn[ee, bb]
    keep = vpart[va] == vpart[vb]
    asm_sbd = vpart[va[keep]].astype(np.int64)
    asm_elem = ee[keep]
    asm_a = aa[keep].astype(np.int64)
    asm_b = bb[keep].astype(np.int64)
    asm_row = g2l[va[keep]].astype(np.int64)
    asm_col = g2l[vb[keep]].astype(np.int64)

    # element -> block map is meaningless for a node plan; give each
    # element the block of its first corner (only used for rendering)
    part = vpart[conn[:, 0]]
    dup = np.ones(n_vert, np.int32)
    return _finish_plan_2d(n_parts, n_elem, n_vert, part, locals_, dup,
                           asm_sbd, asm_elem, asm_a, asm_b, asm_row,
                           asm_col)


class System2D(StaticPytree):
    """Batched triangle-element energy/gradient/Hessian + the dense
    whole-mesh factor (reference roles: Energy dim==2 +
    Optimizer::computePrecondMtr/computeGradient at dim 2)."""

    def __init__(self, mesh: Mesh2D, cfg, dtype=jnp.float64, plan=None,
                 factor_dtype=None):
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.factor_dtype = factor_dtype or dtype
        self.plan = plan
        self.mat = soa2d.SOA2D_MATERIALS[cfg.energy]
        self.dt = float(cfg.dt)
        self.dt_sq = self.dt * self.dt
        self.n_vert = mesh.n_vert
        self.n_elem = mesh.n_elem
        self.n2 = 2 * mesh.n_vert

        conn = mesh.conn
        self.conn = tuple(jnp.asarray(conn[:, c]) for c in range(3))
        g = mesh.rest_tri_inv                       # (nE, 2, 2)
        self.g4 = tuple(jnp.asarray(g[:, i, j], dtype)
                        for i in range(2) for j in range(2))
        # D rows: corner 0 = -colsums of restTriInv; corners 1,2 = rows
        D = np.concatenate([-g.sum(axis=1, keepdims=True), g], axis=1)
        self.D = [[jnp.asarray(D[:, c, j], dtype) for j in range(2)]
                  for c in range(3)]
        self.w = jnp.asarray(mesh.area, dtype)      # per-elem weight
        self.u_e = jnp.asarray(mesh.u, dtype)
        self.lam_e = jnp.asarray(mesh.lam, dtype)
        self.mass = jnp.asarray(mesh.mass, dtype)
        self.gravity = jnp.asarray([0.0, GRAVITY_Y, 0.0], dtype)
        self.grav_dt_sq = self.gravity * self.dt_sq

        # dense-assembly scatter: flat (nE*36,) destinations into the
        # (n2+2)^2 buffer (+2 = dump rows for nothing here; exact fit)
        dof = np.stack([2 * conn[:, c] + i
                        for c in range(3) for i in range(2)], axis=1)
        rows = np.repeat(dof, 6, axis=1)            # (nE, 36)
        cols = np.tile(dof, (1, 6))
        self._hdest = jnp.asarray((rows.astype(np.int64) * self.n2
                                   + cols).reshape(-1))
        self._gdest = jnp.asarray(dof.reshape(-1))  # (nE*6,)

        # characteristic tolerance pieces (Optimizer.cpp:612-651)
        self._sqnorm_l = mesh.sqnorm_face_area_sums
        self._sqnorm_H_rest = self._compute_sqnorm_h_rest()

        # quadratic-form component -> corner-dof index maps (alpha-init):
        # component (a*3+b)*4 + i*2+j pairs corner dofs a*2+i and b*2+j
        comp = np.arange(36)
        ab, ij = comp // 4, comp % 4
        self._qf_row = jnp.asarray((ab // 3) * 2 + ij // 2)
        self._qf_col = jnp.asarray((ab % 3) * 2 + ij % 2)

        # decomposition plan (DOT / LBFGS-H family)
        self.n_parts = plan.n_parts if plan is not None else 0
        if plan is not None:
            self.n2p = plan.n2
            self.l2g = jnp.asarray(plan.local_to_global.astype(np.int64))
            self.local_valid = jnp.asarray(plan.local_valid)
            self.dup = jnp.asarray(plan.dup.astype(np.float64), dtype)
            self.asm_src = jnp.asarray(plan.asm_src)
            self.asm_dest = jnp.asarray(plan.asm_dest)
            self.gath_perm = jnp.asarray(plan.gath_perm)
            self.gath_segids = jnp.asarray(plan.gath_segids)
            self.mass_img = jnp.asarray(
                mesh.mass[plan.local_to_global] * plan.local_valid, dtype)

    # ------------------------------------------------------------------
    def _compute_sqnorm_h_rest(self):
        """||dP/dF(I)||_F^2 at dim 2, first element's Lame params, no SPD
        projection (pure numpy)."""
        u = np.asarray(self.mesh.u[:1])
        lam = np.asarray(self.mesh.lam[:1])
        one = (np.ones(1), np.ones(1))
        h00, h01, h11 = self.mat.d2psi(one, u, lam)
        dpsi = self.mat.dpsi(one, u, lam)
        bl = self.mat.b_left(one, u, lam)
        br = (dpsi[0] + dpsi[1]) / 4.0
        # rotated-basis M at F=I: A on the (00, 11) entries; the (01, 10)
        # pair block [[bl+br, bl-br], [bl-br, bl+br]]
        a = float(h00[0]) ** 2 + float(h11[0]) ** 2 + 2 * float(h01[0]) ** 2
        L, R = float(bl[0]), float(br[0])
        pair = 2 * (L + R) ** 2 + 2 * (L - R) ** 2
        return a + pair

    def target_g_res(self, rel_tol):
        n_free = self.n_vert - int(np.count_nonzero(self.mesh.fixed_mask))
        return (rel_tol * rel_tol * self._sqnorm_H_rest * self._sqnorm_l
                * (n_free / self.n_vert) * self.dt_sq * self.dt_sq)

    # ------------------------------------------------------------------
    def defgrad(self, x):
        """SoA F (4-tuple) at positions/directions x (nV, >=2)."""
        xT = (x[:, 0], x[:, 1])
        return soa2d.defgrad2_soa(xT, self.conn, self.g4)

    def fsvd(self, x):
        f = self.defgrad(x)
        U, s, V = soa2d.svd2_flip_soa(f)
        return f, U, s, V

    def energy(self, x, x_tilta, sigma):
        psi_w = self.mat.psi(sigma, self.u_e, self.lam_e) * self.w
        e_el = self.dt_sq * jnp.sum(psi_w)
        d = x - x_tilta
        return e_el + 0.5 * jnp.sum(self.mass * jnp.sum(d * d, axis=-1))

    def gradient(self, x, x_tilta, fixed, f, U, s, V):
        """(nV, 3) with z = 0, zero at fixed verts."""
        ge = soa2d.element_gradient2_soa(self.mat, f, U, s, V, self.D,
                                         self.u_e, self.lam_e, self.w)
        vals = jnp.stack([ge[c][i] for c in range(3) for i in range(2)],
                         axis=1).reshape(-1)
        acc = jnp.zeros((self.n2,), self.dtype).at[self._gdest].add(vals)
        g2 = acc.reshape(self.n_vert, 2) * jnp.asarray(self.dt_sq,
                                                       self.dtype)
        g = jnp.concatenate(
            [g2, jnp.zeros((self.n_vert, 1), self.dtype)], axis=1)
        g = g + self.mass[:, None] * (x - x_tilta)
        g = g.at[:, 2].set(0.0)
        return jnp.where(fixed[:, None], 0.0, g)

    def factorize(self, x, fixed):
        """Dense equilibrated Cholesky of the projected Hessian
        (M + dt^2 sum H_e, fixed rows -> identity)."""
        _, U, s, V = self.fsvd(x)
        H36 = soa2d.element_hessian2_soa(self.mat, U, s, V, self.D,
                                         self.u_e, self.lam_e, self.w)
        vals = jnp.stack(H36, axis=1).reshape(-1) \
            * jnp.asarray(self.dt_sq, self.dtype)
        H = jnp.zeros((self.n2 * self.n2,), self.dtype).at[
            self._hdest].add(vals).reshape(self.n2, self.n2)
        mdiag = jnp.repeat(self.mass, 2)
        idx = jnp.arange(self.n2)
        H = H.at[idx, idx].add(mdiag)
        free2 = jnp.repeat(jnp.logical_not(fixed).astype(self.dtype), 2)
        H = H * free2[:, None] * free2[None, :]
        H = H.at[idx, idx].add(1.0 - free2)
        d = jnp.sqrt(H[idx, idx])
        dinv = 1.0 / d
        L = jnp.linalg.cholesky(H * dinv[:, None] * dinv[None, :])
        return L, d

    def solve(self, L, d, g):
        """p = -H^{-1} g for the (nV, 3) gradient; z row zero."""
        r = (-g[:, :2].reshape(self.n2) / d)[:, None]
        y = jax.lax.linalg.triangular_solve(L, r, left_side=True,
                                            lower=True)
        z = jax.lax.linalg.triangular_solve(L, y, left_side=True,
                                            lower=True, transpose_a=True)
        p2 = (z[:, 0] / d).reshape(self.n_vert, 2)
        return jnp.concatenate(
            [p2, jnp.zeros((self.n_vert, 1), self.dtype)], axis=1)

    # ------------------------------------------------------------------
    # quasi-Newton System surface (the same contract steppers/core.System
    # exposes, so DOTStepper / LBFGSPD / LBFGS-H drive the 2D pipeline
    # unchanged; reference: the DIM=2 stepper instantiations,
    # DOTTimeStepper.cpp:853, LBFGSTimeStepper.cpp:853-analog)
    # ------------------------------------------------------------------
    @staticmethod
    def svd_flip(f):
        return soa2d.svd2_flip_soa(f)

    def gather_corners(self, x):
        """6-tuple of (nE,) corner values, order c*2+i."""
        return tuple(x[:, i][self.conn[c]]
                     for c in range(3) for i in range(2))

    def defgrad_from_corners(self, pe):
        e = [[pe[(k + 1) * 2 + i] - pe[i] for i in range(2)]
             for k in range(2)]
        g = self.g4
        return tuple(e[0][i] * g[j] + e[1][i] * g[2 + j]
                     for i in range(2) for j in range(2))

    def elastic_energy_sigma(self, sigma):
        psi_w = self.mat.psi(sigma, self.u_e, self.lam_e) * self.w
        return jnp.asarray(self.dt_sq, self.dtype) * jnp.sum(psi_w)

    def inertia_quad(self, x0, p, x_tilta):
        d0 = x0 - x_tilta
        c0 = 0.5 * jnp.sum(self.mass * jnp.sum(d0 * d0, axis=-1))
        c1 = jnp.sum(self.mass * jnp.sum(d0 * p, axis=-1))
        c2 = 0.5 * jnp.sum(self.mass * jnp.sum(p * p, axis=-1))
        return c0, c1, c2

    def element_hessians(self, U, s, V):
        """(36, nE) SPD-projected 6x6 element Hessians, dt^2-scaled,
        block-major component order (a*3+b)*4 + i*2+j."""
        H36 = soa2d.element_hessian2_soa(self.mat, U, s, V, self.D,
                                         self.u_e, self.lam_e, self.w)
        order = []
        for a in range(3):
            for b in range(3):
                for i in range(2):
                    for j in range(2):
                        order.append((a * 2 + i) * 6 + b * 2 + j)
        return (jnp.stack([H36[r] for r in order])
                * jnp.asarray(self.dt_sq, self.dtype))

    def quadratic_form(self, elem_h, p, pe=None):
        """p^T H_tr p incl. mass diagonal (DOT alpha-init,
        Optimizer.cpp:1075-1093)."""
        if pe is None:
            pe = self.gather_corners(p)
        pe_arr = jnp.stack(pe)                       # (6, nE)
        q_el = jnp.sum(elem_h * pe_arr[self._qf_row] * pe_arr[self._qf_col])
        q_m = jnp.sum(self.mass[:, None] * p * p)
        return q_el + q_m

    def hessian_diag(self, elem_h):
        """(nV, 3) diagonal of the preconditioner (the computePrecondMtr
        diagonal, Optimizer.cpp:545-582 at dim 2); z row set to 1 (z dofs
        are frozen, their gradient is 0)."""
        conn_all = jnp.concatenate([self.conn[c] for c in range(3)])
        cols = []
        for i in range(2):
            vals = jnp.concatenate([elem_h[(c * 3 + c) * 4 + 3 * i]
                                    for c in range(3)])
            acc = jnp.zeros((self.n_vert,), self.dtype).at[
                conn_all].add(vals)
            cols.append(acc + self.mass)
        cols.append(jnp.ones((self.n_vert,), self.dtype))
        return jnp.stack(cols, axis=-1)

    # ---- decomposed H0 (DOT / LBFGS-H family) --------------------------
    @property
    def _solve_dtype(self):
        return (jnp.float32 if self.factor_dtype == jnp.bfloat16
                else self.factor_dtype)

    def assemble_subdomains(self, elem_h, fixed):
        """Dense (P, n2p, n2p) subdomain Hessians with interface
        completion, lumped mass on free dofs, identity rows for
        fixed/padding (reference: fillInDecomposedHessians)."""
        P, n2 = self.n_parts, self.n2p
        vals = elem_h.reshape(-1)[self.asm_src]
        Hd = jnp.zeros((P * n2 * n2,), self.dtype).at[
            self.asm_dest].add(vals).reshape(P, n2, n2)
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        f2 = jnp.repeat(free.astype(self.dtype), 2, axis=-1)  # (P, n2)
        Hd = Hd * f2[:, :, None] * f2[:, None, :]
        diag = jnp.repeat(self.mass_img, 2, axis=-1) * f2 + (1.0 - f2)
        idx = jnp.arange(n2)
        return Hd.at[:, idx, idx].add(diag)

    def factorize_fast(self, Hd):
        """Jacobi-equilibrated batched dense Cholesky with a Levenberg
        NaN-rescue tier (same robustness contract as the 3D
        factorize_fast). bfloat16 factor_dtype = round the matrix to
        bf16, factorize f32 (the LBFGS-HI substitution)."""
        idx = jnp.arange(Hd.shape[-1])
        d = jnp.sqrt(Hd[:, idx, idx])
        dinv = 1.0 / d
        Hn = Hd * dinv[:, :, None] * dinv[:, None, :]
        if self.factor_dtype == jnp.bfloat16:
            Hn = Hn.astype(jnp.bfloat16).astype(jnp.float32)
        else:
            Hn = Hn.astype(self.factor_dtype)
        L = jnp.linalg.cholesky(Hn)
        eye = jnp.eye(Hd.shape[-1], dtype=Hn.dtype) * 1.0e-4
        L = jnp.where(jnp.isnan(L).any(),
                      jnp.linalg.cholesky(Hn + eye), L)
        return L, d

    def solve_local(self, L, r):
        rr = r[..., None].astype(self._solve_dtype)
        y = jax.lax.linalg.triangular_solve(L, rr, left_side=True,
                                            lower=True)
        z = jax.lax.linalg.triangular_solve(L, y, left_side=True,
                                            lower=True, transpose_a=True)
        return z[..., 0].astype(self.dtype)

    def local_gather_one(self, q, l2g_i, valid_i):
        """(nV, 3) -> (n2p,) local rhs of ONE subdomain (GSDD sweep);
        only the two in-plane dofs enter the factor."""
        r = q[l2g_i][:, :2] * valid_i[:, None]
        return r.reshape(self.n2p)

    def local_scatter_one(self, z, l2g_i, valid_i):
        p_l = z.reshape(-1, 2) * valid_i[:, None]
        idx = jnp.where(valid_i, l2g_i, self.n_vert)
        p2 = jnp.zeros((self.n_vert + 1, 2), self.dtype).at[idx].set(p_l)
        return jnp.concatenate(
            [p2[:self.n_vert],
             jnp.zeros((self.n_vert, 1), self.dtype)], axis=1)

    def h0_apply(self, L, d, rhs, kc=None, fixed=None):
        """Per-subdomain backsolve + duplicate averaging
        (DOTTimeStepper.cpp:406-450 at DIM=2)."""
        P = self.n_parts
        r = rhs[self.l2g][..., :2] * self.local_valid[..., None]
        r = r.reshape(P, self.n2p) / d
        z = self.solve_local(L, r)
        p_l = (z / d).reshape(-1, 2)[self.gath_perm]
        acc = jax.ops.segment_sum(p_l, self.gath_segids,
                                  num_segments=self.n_vert + 1,
                                  indices_are_sorted=True)[:self.n_vert]
        fine = acc / self.dup[:, None]
        return jnp.concatenate(
            [fine, jnp.zeros((self.n_vert, 1), self.dtype)], axis=1)

    def _rebuild_h0(self, x, fixed):
        _, U, s, V = self.fsvd(x)
        elem_h = self.element_hessians(U, s, V)
        Hd = self.assemble_subdomains(elem_h, fixed)
        L, d = self.factorize_fast(Hd)
        return elem_h, L, d, None

    def rebuild_h0(self, x, fixed):
        from .steppers.core import _rebuild_h0_jit
        return _rebuild_h0_jit(self, x, fixed)

    def init_state(self, script_data):
        from .steppers.core import SimState, LBFGS_HISTORY
        dtype = self.dtype
        x = jnp.asarray(script_data.x0, dtype)
        fixed = jnp.asarray(script_data.fixed0)
        v = jnp.zeros((self.n_vert, 3), dtype)
        x_tilta = self.compute_x_tilta(x, v, fixed)
        elem_h, L, d, kc = self.rebuild_h0(x, fixed)
        m = LBFGS_HISTORY
        return SimState(
            x=x, x_n=jnp.copy(x), v=v, x_tilta=x_tilta,
            dx_elastic=jnp.zeros((self.n_vert, 3), dtype), fixed=fixed,
            vel_sign=jnp.asarray(1.0, dtype), released=jnp.asarray(False),
            elem_h=elem_h, chol=L, equil=d,
            lb_s=jnp.zeros((m, self.n_vert, 3), dtype),
            lb_t=jnp.zeros((m, self.n_vert, 3), dtype),
            lb_rho=jnp.ones((m,), dtype),
            lb_valid=jnp.zeros((m,), dtype), kc_chol=kc)

    def be_update(self, state, x_new):
        dx_el = x_new - state.x_tilta
        v = (x_new - state.x_n) / self.dt
        x_tilta = self.compute_x_tilta(x_new, v, state.fixed)
        return state._replace(x=x_new,
                              x_n=jax.lax.optimization_barrier(x_new),
                              v=v, dx_elastic=dx_el, x_tilta=x_tilta)

    # ---- LBFGS-PD fixed initializer at dim 2 ---------------------------
    # (M + dt^2 D^T W D, w_e = area_e (2 mu_e + lambda_e); reference:
    # LBFGSTimeStepper::precompute, LBFGSTimeStepper.cpp:113-194)
    def build_pd_factor(self, fixed, w=None):
        return _pd2_factor_jit(self, fixed, w)

    def _build_pd_factor(self, fixed, w_e=None):
        n_v = self.n_vert
        conn = self.mesh.conn
        rows = np.repeat(conn, 3, axis=1).reshape(-1)       # (nE*9,)
        cols = np.tile(conn, (1, 3)).reshape(-1)
        dest = jnp.asarray(rows.astype(np.int64) * n_v + cols)
        if w_e is None:
            # LBFGS-PD weight; ADMM passes its Overby weights instead
            w_e = (jnp.asarray(self.dt_sq, self.dtype) * self.w
                   * (2.0 * self.u_e + self.lam_e))
        vals = jnp.stack(
            [w_e * (self.D[a][0] * self.D[b][0]
                    + self.D[a][1] * self.D[b][1])
             for a in range(3) for b in range(3)],
            axis=1).reshape(-1)
        S = jnp.zeros((n_v * n_v,), self.dtype).at[dest].add(vals)
        S = S.reshape(n_v, n_v)
        freef = jnp.logical_not(fixed).astype(self.dtype)
        S = S * freef[:, None] * freef[None, :]
        idx = jnp.arange(n_v)
        S = S.at[idx, idx].add(self.mass * freef + (1.0 - freef))
        d = jnp.sqrt(S[idx, idx])
        dinv = 1.0 / d
        L = jnp.linalg.cholesky(
            (S * dinv[:, None] * dinv[None, :]).astype(self._solve_dtype))
        return L, d

    def pd_solve(self, L, d, rhs):
        r = (rhs[:, :2] / d[:, None]).astype(self._solve_dtype)
        y = jax.lax.linalg.triangular_solve(L, r, left_side=True,
                                            lower=True)
        z = jax.lax.linalg.triangular_solve(L, y, left_side=True,
                                            lower=True, transpose_a=True)
        p2 = z.astype(self.dtype) / d[:, None]
        return jnp.concatenate(
            [p2, jnp.zeros((self.n_vert, 1), self.dtype)], axis=1)

    # ------------------------------------------------------------------
    def compute_x_tilta(self, x_n, v, fixed):
        return jnp.where(fixed[:, None], x_n,
                         x_n + self.dt * v + self.grav_dt_sq)

    # traced-path alias (same contract as steppers/core.System)
    _compute_x_tilta = compute_x_tilta

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
        else:
            raise NotImplementedError(f"warmStart {option} (2D)")
        return x + jnp.where(free, d, 0.0)

    def system_energy(self, x, x_n, sigma):
        psi_w = self.mat.psi(sigma, self.u_e, self.lam_e) * self.w
        e = jnp.sum(psi_w.astype(F64))
        d = (x - x_n).astype(F64)
        e += jnp.sum(self.mass.astype(F64)
                     * (0.5 * jnp.sum(d * d, axis=-1) / self.dt_sq
                        - (x.astype(F64) @ self.gravity.astype(F64))))
        return e


@jax.jit
def _pd2_factor_jit(sys, fixed, w=None):
    return sys._build_pd_factor(fixed, w)


class ADMMPD2D(ADMMPDStepper):
    """ADMM-PD at dim 2 — the DIM=2 instantiation of the reference's
    dimension-templated ADMMTimeStepper (ADMMTimeStepper.cpp:736):
    3-corner triangle elements, a 2-dof sigma-space local Newton per
    element, and the same dense scalar global factor M + D^T W D
    built by System2D.build_pd_factor with Overby weights."""

    name = "ADMM"
    DIM = 2
    N_CORNER = 3
    SIG_DIAG = (0, 2)         # diagonal of the packed sym2 (00, 01, 11)

    def _vol(self):
        return self.system.w          # triangle areas

    def _mat(self):
        return self.system.mat

    def _D_rows(self):
        return self.system.D

    def _defgrad(self, x):
        return self.system.defgrad(x)

    @staticmethod
    def _svd(f):
        return soa2d.svd2_flip_soa(f)

    @staticmethod
    def _make_pd(h):
        return soa2d.make_pd2_soa(h)

    @staticmethod
    def _solve_sym(h, g):
        return _solve_sym2(h, g)

    @staticmethod
    def _z_usv(U, s, V):
        return tuple(
            U[2 * i + 0] * s[0] * V[2 * j + 0]
            + U[2 * i + 1] * s[1] * V[2 * j + 1]
            for i in range(2) for j in range(2))

    def _scatter(self, ge):
        """(nV, 3) scatter (z row zero) via the dense 2D gradient
        destination map."""
        sys = self.system
        vals = jnp.stack([ge[c][i] for c in range(3) for i in range(2)],
                         axis=1).reshape(-1)
        acc = jnp.zeros((sys.n2,), sys.dtype).at[sys._gdest].add(vals)
        g2 = acc.reshape(sys.n_vert, 2)
        return jnp.concatenate(
            [g2, jnp.zeros((sys.n_vert, 1), sys.dtype)], axis=1)


class Newton2DStepper(StaticPytree):
    """Projected Newton at dim 2 — the reference Optimizer's
    solve/fullyImplicit/solve_oneStep/lineSearch loop
    (Optimizer.cpp:326-881) over 6-dof triangle elements."""

    name = "Newton2D"

    def __init__(self, system: System2D, script_data, warm_start_opt=2):
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = scripts.make_step_fn(script_data, system.dt)
        self._step = jax.jit(type(self)._step_impl, donate_argnums=(1,))

    def init_state(self):
        sys = self.system
        sd = self.script_data
        x = jnp.asarray(sd.x0, sys.dtype)
        fixed = jnp.asarray(sd.fixed0)
        v = jnp.zeros((sys.n_vert, 3), sys.dtype)
        return Sim2DState(
            x=x, x_n=jnp.copy(x), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=jnp.zeros((sys.n_vert, 3), sys.dtype),
            fixed=fixed, vel_sign=jnp.asarray(1.0, sys.dtype),
            released=jnp.asarray(False))

    def restore(self, x, v, dxe):
        st = self.init_state()
        sys = self.system
        xj = jnp.asarray(x, sys.dtype)
        vj = jnp.asarray(v, sys.dtype)
        return st._replace(x=xj, x_n=jnp.copy(xj), v=vj,
                           x_tilta=sys.compute_x_tilta(xj, vj, st.fixed),
                           dx_elastic=jnp.asarray(dxe, sys.dtype))

    def step(self, state, rel_tol=1.0e-5):
        tol = jnp.asarray(self.system.target_g_res(rel_tol), F64)
        return self._step(self, state, tol)

    def _step_impl(self, state: Sim2DState, tol):
        sys = self.system
        x, fixed, vel_sign, released, _bc = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state = state._replace(fixed=fixed, vel_sign=vel_sign,
                               released=released)
        x = sys.warm_start(self.warm_start_opt, x, state.v,
                           state.dx_elastic, fixed)
        f, U, s, V = sys.fsvd(x)
        e = sys.energy(x, state.x_tilta, s)
        g = sys.gradient(x, state.x_tilta, fixed, f, U, s, V)
        sqn_g = jnp.vdot(g.ravel(), g.ravel(), precision=HIGHEST).astype(F64)

        rows = jnp.zeros((STATS_CAP, 3), F64)
        rows = rows.at[0].set(jnp.stack([jnp.zeros((), F64),
                                         e.astype(F64), sqn_g]))

        def cond(c):
            (x, e, g, f, sqn_g, it, stopped, n_ls, rows) = c
            return jnp.logical_and(
                sqn_g > tol,
                jnp.logical_and(it < INNER_ITER_CAP,
                                jnp.logical_not(stopped)))

        def body(c):
            (x, e, g, f, sqn_g, it, stopped, n_ls, rows) = c
            L, d = sys.factorize(x, fixed)   # refactorize every iteration
            p = sys.solve(L, d, g)

            # line search: F is linear in positions, inertia quadratic
            fp = sys.defgrad(p)
            dvec = x - state.x_tilta
            c0 = 0.5 * jnp.sum(sys.mass * jnp.sum(dvec * dvec, axis=-1))
            c1 = jnp.sum(sys.mass * jnp.sum(dvec * p, axis=-1))
            c2 = 0.5 * jnp.sum(sys.mass * jnp.sum(p * p, axis=-1))

            def trial_e(alpha):
                ff = tuple(fk + alpha * fpk for fk, fpk in zip(f, fp))
                _, ss, _ = soa2d.svd2_flip_soa(ff)
                psi_w = sys.mat.psi(ss, sys.u_e, sys.lam_e) * sys.w
                return (jnp.asarray(sys.dt_sq, sys.dtype) * jnp.sum(psi_w)
                        + c0 + alpha * (c1 + alpha * c2))

            def ls_body(cc):
                alpha, ee, k = cc
                alpha = 0.5 * alpha
                return alpha, trial_e(alpha), k + 1

            def ls_cond(cc):
                _, ee, k = cc
                return jnp.logical_and(ee > e, k < LINE_SEARCH_CAP)

            a0 = jnp.asarray(1.0, sys.dtype)
            e1 = trial_e(a0)
            alpha, e_new, halv = jax.lax.while_loop(
                ls_cond, ls_body, (a0, e1, jnp.asarray(0, jnp.int32)))
            failed = e_new > e
            x_new = jnp.where(failed, x, x + alpha * p)
            ff = tuple(fk + jnp.where(failed, 0.0, alpha) * fpk
                       for fk, fpk in zip(f, fp))
            Uf, sf, Vf = soa2d.svd2_flip_soa(ff)
            g_new = sys.gradient(x_new, state.x_tilta, fixed, ff, Uf, sf, Vf)
            e_prev = e
            e = jnp.where(failed, e, e_new)
            # same early stop as the 3D Newton (allowEDecRelTol,
            # Optimizer.cpp:856-862): relative decrease against e_prev
            stopped = jnp.logical_or(
                failed, (e_prev - e) / e_prev < REL_EDEC_STOP)
            sqn_g = jnp.vdot(g_new.ravel(), g_new.ravel(),
                             precision=HIGHEST).astype(F64)
            it = it + 1
            row = jnp.stack([alpha.astype(F64), e.astype(F64), sqn_g])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (x_new, e, g_new, ff, sqn_g, it, stopped,
                    n_ls + halv, rows)

        init = (x, e, g, f, sqn_g, jnp.asarray(0, jnp.int32),
                jnp.asarray(False), jnp.asarray(0, jnp.int32), rows)
        (x, e, g, f, sqn_g, it, stopped, n_ls, rows) = jax.lax.while_loop(
            cond, body, init)

        # BE update (Optimizer.cpp:354-361)
        x_n_prev = state.x_n
        dx_el = x - state.x_tilta
        v = (x - state.x_n) / sys.dt
        x_tilta = sys.compute_x_tilta(x, v, fixed)
        state = state._replace(x=x, x_n=jax.lax.optimization_barrier(x),
                               v=v, dx_elastic=dx_el, x_tilta=x_tilta)
        _, _, s_fin, _ = sys.fsvd(x)
        sys_e = sys.system_energy(x, x_n_prev, s_fin)
        stats = StepStats(energy=e, sqn_g=sqn_g, inner_iters=it,
                          ls_halvings=n_ls, stopped=stopped, rows=rows)
        return state, (stats, sys_e)


ADMM_DD_ITER_CAP = 1000    # ADMMDDTimeStepper.cpp:632
ADMM_DD_H_REFRESH = 20     # ADMMDDTimeStepper.cpp:637
ADMM_DD_RELAX = 1.8        # boundaryConsensusSolve over-relaxation


class ADMMDD2D(StaticPytree):
    """ADMM-DD at dim 2 — the DIM=2 instantiation of the reference's
    dimension-templated ADMMDDTimeStepper (overlapping-subdomain
    consensus ADMM; ADMMDDTimeStepper.cpp:595-701, initWeights_fast
    :894-1033, subdomainSolve :1107-1232, boundaryConsensusSolve
    :1254-1344). Everything is batched DENSE: at 2D scene scale a
    subdomain is a few hundred dofs, so the interface weight matrices
    W_s, the consensus matrix, and the augmented local Hessians are
    plain (P, n2p, n2p)/(ns2, ns2) arrays — one batched op each — and
    the compact-W machinery of the 3D stepper would be pure overhead.
    Weights are refreshed once per time step from the incoming
    positions (the reference refreshes at step end — same states)."""

    name = "ADMMDD"

    def __init__(self, system: System2D, script_data, plan: Plan2D,
                 warm_start_opt=2):
        sys_ = system
        self.system = system
        self.script_data = script_data
        self.warm_start_opt = warm_start_opt
        self._anim = scripts.make_step_fn(script_data, system.dt)
        mesh = system.mesh
        conn = mesh.conn.astype(np.int64)
        P, N, n2p = plan.n_parts, plan.n_local_max, plan.n2
        n_vert, n_elem = mesh.n_vert, mesh.n_elem
        part = plan.part
        self.P, self.N, self.n2p = P, N, n2p
        dtype = sys_.dtype

        g2l = np.full((P, n_vert), -1, np.int32)
        locals_ = []
        for p in range(P):
            lv = np.where(plan.local_valid[p])[0]
            gl = plan.local_to_global[p, lv]
            g2l[p, gl] = lv.astype(np.int32)
            locals_.append(gl.astype(np.int64))

        # ---- padded per-subdomain element slabs -----------------------
        by_part = [np.where(part == p)[0] for p in range(P)]
        epad = max(8, -(-max(len(e) for e in by_part) // 8) * 8)
        elem_src = np.zeros((P, epad), np.int64)
        elem_valid = np.zeros((P, epad), bool)
        for p, e in enumerate(by_part):
            elem_src[p, :len(e)] = e
            elem_valid[p, :len(e)] = True
        es, ev = elem_src.reshape(-1), elem_valid.reshape(-1)
        self.epad = epad
        g = np.asarray(mesh.rest_tri_inv)[es] * ev[:, None, None]
        self.lg4 = tuple(jnp.asarray(g[:, i, j], dtype)
                         for i in range(2) for j in range(2))
        D = np.concatenate([-g.sum(axis=1, keepdims=True), g], axis=1)
        self.lD = [[jnp.asarray(D[:, c, j], dtype) for j in range(2)]
                   for c in range(3)]
        self.lw = jnp.asarray(np.asarray(mesh.area)[es] * ev, dtype)
        self.lu = jnp.asarray(np.asarray(mesh.u)[es], dtype)
        self.llam = jnp.asarray(np.asarray(mesh.lam)[es], dtype)
        pid = np.repeat(np.arange(P, dtype=np.int64), epad)
        lconn = g2l[pid[:, None], conn[es]]
        conn_local = np.where(ev[:, None], pid[:, None] * N + lconn, P * N)
        self.conn_local = tuple(jnp.asarray(conn_local[:, c].copy())
                                for c in range(3))

        # local own-element dense assembly plan (computeHessianProxy's
        # elasticity part): 9 corner-pair 2x2 blocks per slab element
        ij = np.indices((2, 2)).reshape(2, 4).T
        i4, j4 = ij[:, 0][None, :], ij[:, 1][None, :]
        slab_e = np.arange(P * epad, dtype=np.int64)
        srcs, dests = [], []
        for a in range(3):
            for b in range(3):
                comp = (a * 3 + b) * 4 + i4 * 2 + j4
                srcs.append(comp * (P * epad) + slab_e[:, None])
                d = (pid[:, None] * (n2p * n2p)
                     + (lconn[:, a][:, None] * 2 + i4) * n2p
                     + lconn[:, b][:, None] * 2 + j4)
                dests.append(np.where(ev[:, None], d, P * n2p * n2p))
        self.own_src = jnp.asarray(np.concatenate(srcs, 1).reshape(-1)
                                   .astype(np.int32))
        self.own_dest = jnp.asarray(np.concatenate(dests, 1).reshape(-1)
                                    .astype(np.int64))

        # subdomain lumped mass + interface maps
        mass_local = np.zeros((P, N))
        cm = np.asarray(mesh.area) * mesh.rho / 3.0
        for p, e in enumerate(by_part):
            np.add.at(mass_local[p], g2l[p, conn[e].ravel()],
                      np.repeat(cm[e], 3))
        self.mass_local = jnp.asarray(mass_local, dtype)
        dup = plan.dup
        is_shared_g = dup > 1
        is_dual = np.zeros((P, N), bool)
        owner_part = np.zeros(n_vert, np.int32)
        owner_local = np.zeros(n_vert, np.int32)
        seen = np.zeros(n_vert, bool)
        for p in range(P):
            lv = np.where(plan.local_valid[p])[0]
            gl = plan.local_to_global[p, lv]
            is_dual[p, lv] = is_shared_g[gl]
            new = ~seen[gl]
            owner_part[gl[new]] = p
            owner_local[gl[new]] = lv[new]
            seen[gl[new]] = True
        self.is_dual = jnp.asarray(is_dual)
        self.owner_flat = jnp.asarray(
            owner_part.astype(np.int64) * N + owner_local)
        shared_ids = np.where(is_shared_g)[0].astype(np.int64)
        n_shared = len(shared_ids)
        self.shared_ids = jnp.asarray(shared_ids)
        self.n_shared = n_shared
        self.ns2 = 2 * (n_shared + 1)
        shared_of = np.full(n_vert, n_shared, np.int64)
        shared_of[shared_ids] = np.arange(n_shared)
        l2shared = np.full((P, N), n_shared, np.int64)
        for p in range(P):
            lv = np.where(plan.local_valid[p])[0]
            l2shared[p, lv] = shared_of[plan.local_to_global[p, lv]]
        self.l2shared = jnp.asarray(l2shared)
        self.l2g = jnp.asarray(plan.local_to_global.astype(np.int64))
        self.local_valid = jnp.asarray(plan.local_valid)

        # ---- weight/consensus scatter plans over completion tuples ----
        c_sbd, c_elem, c_a, c_b, c_row, c_col = _completion_tuples_2d(
            conn, part, locals_, g2l, dup, P, n_vert)
        comp = ((c_a.astype(np.int64) * 3 + c_b)[:, None] * 4
                + i4 * 2 + j4)                         # (nC, 4)
        self.comp_gather = jnp.asarray(
            (comp * n_elem + c_elem[:, None]).reshape(-1).astype(np.int32))
        wd = (c_sbd.astype(np.int64)[:, None] * (n2p * n2p)
              + (c_row.astype(np.int64)[:, None] * 2 + i4) * n2p
              + c_col.astype(np.int64)[:, None] * 2 + j4)
        self.w_dest = jnp.asarray(wd.reshape(-1))
        srow = shared_of[plan.local_to_global[c_sbd, c_row]]
        scol = shared_of[plan.local_to_global[c_sbd, c_col]]
        cd = ((srow[:, None] * 2 + i4) * self.ns2
              + scol[:, None] * 2 + j4)
        self.c_dest = jnp.asarray(cd.reshape(-1))
        mass_dif = (np.asarray(mesh.mass)[plan.local_to_global]
                    * plan.local_valid - mass_local) * is_dual
        self.mass_dif = jnp.asarray(mass_dif, dtype)

        self._step = jax.jit(type(self)._step_impl, donate_argnums=(1,))

    # ------------------------------------------------------------------
    def _free2(self, fixed):
        free = jnp.logical_and(self.local_valid,
                               jnp.logical_not(fixed[self.l2g]))
        return jnp.repeat(free.astype(self.system.dtype), 2, axis=-1)

    def _weights(self, x, fixed):
        """Dense W_s (P, n2p, n2p), consensus factor (Lc, dc), and the
        global element Hessians at x (initWeights_fast +
        boundaryConsensusSolve's matrix)."""
        sys = self.system
        _, U, s, V = sys.fsvd(x)
        elem_h = sys.element_hessians(U, s, V)          # (36, nE)
        vals = elem_h.reshape(-1)[self.comp_gather]
        W = jnp.zeros((self.P * self.n2p * self.n2p + 1,), sys.dtype) \
            .at[self.w_dest].add(vals)[:-1] \
            .reshape(self.P, self.n2p, self.n2p)
        C = jnp.zeros((self.ns2 * self.ns2,), sys.dtype) \
            .at[self.c_dest].add(vals).reshape(self.ns2, self.ns2)
        md_sh = jnp.zeros((self.n_shared + 1,), sys.dtype).at[
            self.l2shared.reshape(-1)].add(self.mass_dif.reshape(-1))
        cidx = jnp.arange(self.ns2)
        C = C.at[cidx, cidx].add(jnp.repeat(md_sh, 2))
        sfree = jnp.concatenate(
            [jnp.logical_not(fixed[self.shared_ids]).astype(sys.dtype),
             jnp.zeros((1,), sys.dtype)])
        f2 = jnp.repeat(sfree, 2)
        C = C * f2[:, None] * f2[None, :]
        C = C.at[cidx, cidx].add(1.0 - f2)
        dc = jnp.sqrt(C[cidx, cidx])
        Lc = jnp.linalg.cholesky(C / dc[:, None] / dc[None, :])
        return elem_h, W, Lc, dc

    def _w_masked(self, W, free2f):
        f = free2f.reshape(self.P, self.n2p)
        return W * f[:, :, None] * f[:, None, :]

    def _md2f(self, free2f):
        md = jnp.repeat(self.mass_dif, 2, axis=-1).reshape(-1)
        return md * free2f

    def _w_matvec(self, Wm, free2f, aug):
        y = jnp.einsum("pij,pj->pi", Wm, aug, precision=HIGHEST)
        return y + (self._md2f(free2f) * aug.reshape(-1)).reshape(
            self.P, self.n2p)

    # ---- local (slab) element chain ----------------------------------
    def _local_fsvd(self, xl_flat):
        rows = [xl_flat[self.conn_local[c]] for c in range(3)]
        pe = tuple(rows[c][:, i] for c in range(3) for i in range(2))
        e = [[pe[(k + 1) * 2 + i] - pe[i] for i in range(2)]
             for k in range(2)]
        g = self.lg4
        return tuple(e[0][i] * g[j] + e[1][i] * g[2 + j]
                     for i in range(2) for j in range(2))

    def _local_psi_sum(self, s):
        psi_w = self.system.mat.psi(s, self.lu, self.llam) * self.lw
        return jnp.sum(psi_w.reshape(self.P, -1), axis=1) \
            * jnp.asarray(self.system.dt_sq, self.system.dtype)

    def _local_gradient(self, xl_flat, xhat_flat, z, u_loc, Wm, free2f,
                        f4, U, s, V):
        sys = self.system
        P, N = self.P, self.N
        ge = soa2d.element_gradient2_soa(sys.mat, f4, U, s, V, self.lD,
                                         self.lu, self.llam, self.lw)
        vals = jnp.stack([jnp.stack([ge[c][0], ge[c][1]], axis=-1)
                          for c in range(3)], axis=1)   # (nEl, 3, 2)
        conn_s = jnp.stack(self.conn_local, axis=1).reshape(-1)
        acc = jnp.zeros((P * N + 1, 2), sys.dtype).at[conn_s].add(
            vals.reshape(-1, 2))
        g = acc[:-1].reshape(P, N, 2) * jnp.asarray(sys.dt_sq, sys.dtype)
        d = (xl_flat - xhat_flat)[:-1].reshape(P, N, 2)
        g = g + self.mass_local[..., None] * d
        aug = self._aug_vec(xl_flat, z, u_loc)
        g = g + self._w_matvec(Wm, free2f, aug).reshape(P, N, 2)
        return g * free2f.reshape(P, N, 2)

    def _aug_vec(self, xl_flat, z, u_loc):
        zg = z[self.l2g][:, :, :2]                      # (P, N, 2)
        xl = xl_flat[:-1].reshape(self.P, self.N, 2)
        return (xl - zg + u_loc).reshape(self.P, self.n2p)

    def _to_flat(self, xl):
        return jnp.concatenate(
            [xl.reshape(self.P * self.N, 2),
             jnp.zeros((1, 2), self.system.dtype)], axis=0)

    def _local_h_factor(self, Wm, free2f, U, s, V):
        """Augmented local Hessian: own elasticity + subdomain mass + W,
        identity at fixed/pad rows (computeHessianProxy_subdomain)."""
        sys = self.system
        P, n2p = self.P, self.n2p
        H36 = soa2d.element_hessian2_soa(sys.mat, U, s, V, self.lD,
                                         self.lu, self.llam, self.lw)
        order = []
        for a in range(3):
            for b in range(3):
                for i in range(2):
                    for j in range(2):
                        order.append((a * 2 + i) * 6 + b * 2 + j)
        eh = jnp.stack([H36[r] for r in order]) \
            * jnp.asarray(sys.dt_sq, sys.dtype)          # (36, nEl)
        vals = eh.reshape(-1)[self.own_src]
        Hd = jnp.zeros((P * n2p * n2p + 1,), sys.dtype).at[
            self.own_dest].add(vals)[:-1].reshape(P, n2p, n2p)
        Hd = Hd * free2f.reshape(P, n2p)[:, :, None] \
            * free2f.reshape(P, n2p)[:, None, :]
        Hd = Hd + Wm
        ml2 = jnp.repeat(self.mass_local, 2, axis=-1)
        f = free2f.reshape(P, n2p)
        diag = (ml2 + self._md2f(free2f).reshape(P, n2p)) * f + (1.0 - f)
        idx = jnp.arange(n2p)
        Hd = Hd.at[:, idx, idx].add(diag)
        d = jnp.sqrt(Hd[:, idx, idx])
        dinv = 1.0 / d
        L = jnp.linalg.cholesky(Hd * dinv[:, :, None] * dinv[:, None, :])
        return L, d

    def _local_solve(self, L, d, g):
        r = (-g.reshape(self.P, self.n2p) / d)[..., None]
        y = jax.lax.linalg.triangular_solve(L, r, left_side=True,
                                            lower=True)
        zz = jax.lax.linalg.triangular_solve(L, y, left_side=True,
                                             lower=True, transpose_a=True)
        return (zz[..., 0] / d).reshape(self.P, self.N, 2)

    # ------------------------------------------------------------------
    def init_state(self):
        sys = self.system
        sd = self.script_data
        x = jnp.asarray(sd.x0, sys.dtype)
        fixed = jnp.asarray(sd.fixed0)
        v = jnp.zeros((sys.n_vert, 3), sys.dtype)
        return Sim2DState(
            x=x, x_n=jnp.copy(x), v=v,
            x_tilta=sys.compute_x_tilta(x, v, fixed),
            dx_elastic=jnp.zeros((sys.n_vert, 3), sys.dtype),
            fixed=fixed, vel_sign=jnp.asarray(1.0, sys.dtype),
            released=jnp.asarray(False))

    def restore(self, x, v, dxe):
        st = self.init_state()
        sys = self.system
        xj = jnp.asarray(x, sys.dtype)
        vj = jnp.asarray(v, sys.dtype)
        return st._replace(x=xj, x_n=jnp.copy(xj), v=vj,
                           x_tilta=sys.compute_x_tilta(xj, vj, st.fixed),
                           dx_elastic=jnp.asarray(dxe, sys.dtype))

    def step(self, state, rel_tol=1.0e-5):
        tol = jnp.asarray(self.system.target_g_res(rel_tol), F64)
        return self._step(self, state, tol)

    def _step_impl(self, state: Sim2DState, tol):
        sys = self.system
        P, N, n2p = self.P, self.N, self.n2p
        x0, fixed, vel_sign, released, _bc = self._anim(
            state.x, state.fixed, state.vel_sign, state.released)
        state = state._replace(fixed=fixed, vel_sign=vel_sign,
                               released=released)
        # weights at the incoming positions (the reference's step-end
        # refresh sees the same converged state)
        elem_h, W, Lc, dc = self._weights(x0, fixed)
        free2f = self._free2(fixed).reshape(-1)
        Wm = self._w_masked(W, free2f)

        # initPrimal
        x = sys.warm_start(self.warm_start_opt, x0, state.v,
                           state.dx_elastic, fixed)
        xhat_g = jnp.where(fixed[:, None], x, state.x_tilta)
        xl = x[self.l2g][:, :, :2] * self.local_valid[..., None]
        xhat_l = xhat_g[self.l2g][:, :, :2] * self.local_valid[..., None]
        xl_flat = self._to_flat(xl)
        xhat_flat = self._to_flat(xhat_l)
        z = x
        u_loc = jnp.zeros((P, N, 2), sys.dtype)

        f, U, s, V = sys.fsvd(x)
        e = sys.energy(x, state.x_tilta, s)
        g = sys.gradient(x, state.x_tilta, fixed, f, U, s, V)
        sqn_g = jnp.vdot(g.ravel(), g.ravel(), precision=HIGHEST).astype(F64)

        # initDual: u = W^{-1}(g_global - g_local) on interface dofs
        # (dense batched solve of W + I_offdual; ADMMDDTimeStepper:736-796)
        lf4 = self._local_fsvd(xl_flat)
        lU, ls_, lV = soa2d.svd2_flip_soa(lf4)
        g_loc = self._local_gradient(xl_flat, xhat_flat, z,
                                     jnp.zeros_like(u_loc), Wm, free2f,
                                     lf4, lU, ls_, lV)
        rhs_u = (g[self.l2g][:, :, :2] * self.local_valid[..., None]
                 - g_loc) * self.is_dual[..., None]
        dual2 = (jnp.repeat(self.is_dual.astype(sys.dtype), 2, axis=-1)
                 * free2f.reshape(P, n2p))
        wdg = jnp.einsum("pii->pi", Wm) + self._md2f(free2f).reshape(P, n2p)
        fix1 = jnp.where((wdg == 0.0) & (dual2 > 0.0), 1.0, 0.0)
        Wsolve = Wm + jnp.zeros_like(Wm)
        idx = jnp.arange(n2p)
        Wsolve = Wsolve.at[:, idx, idx].add(
            self._md2f(free2f).reshape(P, n2p) + (1.0 - dual2) + fix1)
        dw = jnp.sqrt(Wsolve[:, idx, idx])
        Lw = jnp.linalg.cholesky(Wsolve / dw[:, :, None] / dw[:, None, :])
        rw = (rhs_u.reshape(P, n2p) / dw)[..., None]
        yw = jax.lax.linalg.triangular_solve(Lw, rw, left_side=True,
                                             lower=True)
        zw = jax.lax.linalg.triangular_solve(Lw, yw, left_side=True,
                                             lower=True, transpose_a=True)
        u_loc = ((zw[..., 0] / dw).reshape(P, N, 2)
                 * dual2.reshape(P, N, 2))

        L0, d0 = self._local_h_factor(Wm, free2f, lU, ls_, lV)

        rows = jnp.zeros((STATS_CAP, 3), F64)
        rows = rows.at[0].set(jnp.stack([jnp.zeros((), F64),
                                         e.astype(F64), sqn_g]))

        def cond(c):
            sqn, it = c[5], c[6]
            return jnp.logical_and(sqn > tol, it < ADMM_DD_ITER_CAP)

        def body(c):
            (xl_flat, z, u_loc, L, d, sqn, it, e, rows, f4, U, s, V) = c
            L, d = jax.lax.cond(
                it % ADMM_DD_H_REFRESH == 0,
                lambda: self._local_h_factor(Wm, free2f, U, s, V),
                lambda: (L, d))

            # one local Newton iteration + linearized line search
            gl = self._local_gradient(xl_flat, xhat_flat, z, u_loc,
                                      Wm, free2f, f4, U, s, V)
            p = self._local_solve(L, d, gl) \
                * free2f.reshape(P, N, 2)
            p_flat = self._to_flat(p)
            fp4 = self._local_fsvd(p_flat)
            ml = self.mass_local[..., None]
            d0v = (xl_flat - xhat_flat)[:-1].reshape(P, N, 2)
            c0 = 0.5 * jnp.sum(ml * d0v * d0v, axis=(1, 2))
            c1 = jnp.sum(ml * d0v * p, axis=(1, 2))
            c2 = 0.5 * jnp.sum(ml * p * p, axis=(1, 2))
            aug0 = self._aug_vec(xl_flat, z, u_loc)
            pa = p.reshape(P, n2p)
            Wa0 = self._w_matvec(Wm, free2f, aug0)
            Wpa = self._w_matvec(Wm, free2f, pa)
            a0c = 0.5 * jnp.sum(aug0 * Wa0, axis=1)
            a1c = 0.5 * (jnp.sum(pa * Wa0, axis=1)
                         + jnp.sum(aug0 * Wpa, axis=1))
            a2c = 0.5 * jnp.sum(pa * Wpa, axis=1)

            def trial_e(alpha):
                ae = jnp.repeat(alpha.astype(sys.dtype), self.epad)
                ff = tuple(fk + ae * fpk for fk, fpk in zip(f4, fp4))
                _, ss, _ = soa2d.svd2_flip_soa(ff)
                return (self._local_psi_sum(ss)
                        + c0 + alpha * (c1 + alpha * c2)
                        + a0c + alpha * (a1c + alpha * a2c))

            e0 = self._local_psi_sum(s) + c0 + a0c

            def ls_body(cc):
                alpha, ee, k = cc
                alpha = jnp.where(ee > e0, 0.5 * alpha, alpha)
                return alpha, trial_e(alpha), k + 1

            def ls_cond(cc):
                _, ee, k = cc
                return jnp.logical_and(jnp.any(ee > e0),
                                       k < LINE_SEARCH_CAP)

            a1 = jnp.ones((P,), sys.dtype)
            alpha, _, _ = jax.lax.while_loop(
                ls_cond, ls_body, (a1, trial_e(a1),
                                   jnp.asarray(0, jnp.int32)))
            am = jnp.concatenate(
                [jnp.repeat(alpha, N), alpha[:1] * 0.0])[:, None]
            xl_flat = xl_flat + am * p_flat
            ae_f = jnp.repeat(alpha.astype(sys.dtype), self.epad)
            f4 = tuple(fk + ae_f * fpk for fk, fpk in zip(f4, fp4))
            U, s, V = soa2d.svd2_flip_soa(f4)

            # boundary consensus solve (relax 1.8)
            xl = xl_flat[:-1].reshape(P, N, 2)
            zg = z[self.l2g][:, :, :2]
            aug = (ADMM_DD_RELAX * xl + (1.0 - ADMM_DD_RELAX) * zg
                   + u_loc - zg).reshape(P, n2p)
            t = self._w_matvec(Wm, free2f, aug).reshape(P * N, 2)
            rhs_sh = jnp.zeros((self.n_shared + 1, 2), sys.dtype).at[
                self.l2shared.reshape(-1)].add(t)
            rhs_sh = rhs_sh.at[self.n_shared].set(0.0)
            rhs_sh = jnp.where(fixed[self.shared_ids][:, None], 0.0,
                               rhs_sh[:self.n_shared])
            rhs = jnp.concatenate(
                [rhs_sh, jnp.zeros((1, 2), sys.dtype)]).reshape(self.ns2)
            rc = (rhs / dc)[:, None]
            yc = jax.lax.linalg.triangular_solve(Lc, rc, left_side=True,
                                                 lower=True)
            zc = jax.lax.linalg.triangular_solve(Lc, yc, left_side=True,
                                                 lower=True,
                                                 transpose_a=True)
            dz = (zc[:, 0] / dc).reshape(-1, 2)

            z_owner2 = xl_flat[self.owner_flat]          # (nV, 2)
            is_sh = jnp.zeros((sys.n_vert,), bool).at[
                self.shared_ids].set(True)
            z2 = jnp.where(is_sh[:, None], z[:, :2], z_owner2)
            z2 = z2.at[self.shared_ids].add(dz[:self.n_shared])
            z_new = jnp.concatenate(
                [z2, jnp.zeros((sys.n_vert, 1), sys.dtype)], axis=1)

            zg_new = z_new[self.l2g][:, :, :2]
            du = (ADMM_DD_RELAX * xl + (1.0 - ADMM_DD_RELAX) * zg
                  - zg_new) * self.is_dual[..., None]
            u_loc = u_loc + du

            Fz, Uz, sz, Vz = sys.fsvd(z_new)
            gg = sys.gradient(z_new, state.x_tilta, fixed, Fz, Uz, sz, Vz)
            ee = sys.energy(z_new, state.x_tilta, sz)
            sqn = jnp.vdot(gg.ravel(), gg.ravel(),
                           precision=HIGHEST).astype(F64)
            it = it + 1
            row = jnp.stack([jnp.ones((), F64), ee.astype(F64), sqn])
            rows = rows.at[jnp.minimum(it, STATS_CAP - 1)].set(row)
            return (xl_flat, z_new, u_loc, L, d, sqn, it, ee, rows,
                    f4, U, s, V)

        init = (xl_flat, z, u_loc, L0, d0, sqn_g,
                jnp.asarray(0, jnp.int32), e, rows, lf4, lU, ls_, lV)
        (xl_flat, z, u_loc, _L, _d, sqn_g, it, e, rows,
         *_rest) = jax.lax.while_loop(cond, body, init)

        x = z
        x_n_prev = state.x_n
        dx_el = x - state.x_tilta
        v = (x - state.x_n) / sys.dt
        x_tilta = sys.compute_x_tilta(x, v, fixed)
        state = state._replace(x=x, x_n=jax.lax.optimization_barrier(x),
                               v=v, dx_elastic=dx_el, x_tilta=x_tilta)
        _, _, s_fin, _ = sys.fsvd(x)
        sys_e = sys.system_energy(x, x_n_prev, s_fin)
        stats = StepStats(energy=e, sqn_g=sqn_g, inner_iters=it,
                          ls_halvings=jnp.asarray(0, jnp.int32),
                          stopped=(it >= ADMM_DD_ITER_CAP), rows=rows)
        return state, (stats, sys_e)


class Sim2D:
    """2D frame-loop driver with the same per-run output contract as the
    3D Simulator (config.txt, <n>.obj, status<n>, iterStats.txt,
    log.txt, info.txt; reference: main.cpp:318-358)."""

    def __init__(self, cfg, output_dir, dtype=jnp.float64, save_every=1,
                 mute=False, render=True):
        self.cfg = cfg
        self.out = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.save_every = save_every
        self.mute = mute
        self.render = render

        self.mesh = Mesh2D.from_config(cfg)
        self.script_data = scripts.init_script(self.mesh, cfg.script)
        self.mesh.fixed_mask = self.script_data.fixed0.copy()
        self.stepper = self._make_stepper(cfg, dtype)
        self.system = self.stepper.system
        self.state = self.stepper.init_state()
        self.frame = 0
        self.frame_amt = int(cfg.duration / cfg.dt)
        self.inner_iter_total = 0
        self.ls_total = 0
        if cfg.restart:
            from .sim import parse_status
            x, v, dxe, frame = parse_status(cfg.status_path)
            self.state = self.stepper.restore(x, v, dxe)
            self.frame = frame
        cfg.save(os.path.join(output_dir, "config.txt"))
        self._iter_stats = open(os.path.join(output_dir, "iterStats.txt"),
                                "w")
        self._log = open(os.path.join(output_dir, "log.txt"), "w")

    def _make_stepper(self, cfg, dtype):
        """Stepper dispatch at dim 2 (the reference's DIM=2 template
        instantiations: DOTTimeStepper.cpp:853 and the per-stepper
        equivalents; main.cpp:905-938 dispatch)."""
        from .steppers.dot import DOTStepper
        from .steppers.lbfgs import LBFGSPD, LBFGSH, LBFGSHI
        from .partition import partition_amt_from_config

        st = cfg.time_stepper
        ws = cfg.warm_start
        if st == "Newton":
            system = System2D(self.mesh, cfg, dtype=dtype)
            return Newton2DStepper(system, self.script_data,
                                   warm_start_opt=ws)
        if st in ("DOT", "GSDD"):
            from .steppers.gsdd import GSDDStepper
            n_parts = partition_amt_from_config(cfg, self.mesh.n_vert)
            plan = build_plan_2d(self.mesh, n_parts)
            system = System2D(self.mesh, cfg, dtype=dtype, plan=plan)
            cls = GSDDStepper if st == "GSDD" else DOTStepper
            return cls(system, self.script_data, warm_start_opt=ws)
        if st == "LBFGS":
            system = System2D(self.mesh, cfg, dtype=dtype)
            return LBFGSPD(system, self.script_data, warm_start_opt=ws)
        if st in ("LBFGSH", "LBFGSHI"):
            plan = build_plan_2d(self.mesh, 1)
            fdt = jnp.bfloat16 if st == "LBFGSHI" else None
            system = System2D(self.mesh, cfg, dtype=dtype, plan=plan,
                              factor_dtype=fdt)
            cls = LBFGSHI if st == "LBFGSHI" else LBFGSH
            return cls(system, self.script_data, warm_start_opt=ws)
        if st == "LBFGSJH":
            from .steppers.lbfgs import LBFGSJH
            n_parts = partition_amt_from_config(cfg, self.mesh.n_vert)
            plan = build_node_plan_2d(self.mesh, n_parts)
            system = System2D(self.mesh, cfg, dtype=dtype, plan=plan)
            return LBFGSJH(system, self.script_data, warm_start_opt=ws)
        if st == "ADMM":
            system = System2D(self.mesh, cfg, dtype=dtype)
            return ADMMPD2D(system, self.script_data,
                            max_iter=cfg.max_iter_apd)
        if st == "ADMMDD":
            n_parts = partition_amt_from_config(cfg, self.mesh.n_vert)
            plan = build_plan_2d(self.mesh, n_parts)
            system = System2D(self.mesh, cfg, dtype=dtype, plan=plan)
            return ADMMDD2D(system, self.script_data, plan,
                            warm_start_opt=ws)
        raise NotImplementedError(
            f"2D timeStepper {st} (available: Newton, DOT, GSDD, ADMM, "
            "ADMMDD, LBFGS, LBFGSH, LBFGSHI, LBFGSJH)")

    def _rel_tol(self, frame):
        tol = self.cfg.tol
        if not tol:
            return 1.0e-5
        return tol[min(frame, len(tol) - 1)]

    def run(self, frames=None):
        n = self.frame_amt if frames is None else min(
            frames, self.frame_amt - self.frame)
        t0 = time.perf_counter()
        t_warm = None
        for i in range(n):
            if self.frame % self.save_every == 0:
                self.save_status()
            rel = self._rel_tol(self.frame)
            tol = self.system.target_g_res(rel)
            self.state, (stats, sys_e) = self.stepper.step(self.state, rel)
            self._record(self.frame, stats, sys_e, tol)
            self.frame += 1
            if i == 0:
                t_warm = time.perf_counter()  # first frame pays the compile
        wall = time.perf_counter() - t0
        self.steady_spf = ((time.perf_counter() - t_warm) / (n - 1)
                           if n > 1 else wall)
        if not self.mute:
            print(f"ran {n} 2D frames in {wall:.3f}s "
                  f"({wall / max(n, 1):.4f} s/frame)")
        return wall / max(n, 1)

    def _record(self, frame, stats, sys_e, tol):
        stats, sys_e = jax.device_get((stats, sys_e))
        it = int(stats.inner_iters)
        self.inner_iter_total += it
        self.ls_total += int(stats.ls_halvings)
        rows = np.asarray(stats.rows[:it + 1])
        for r in rows:
            self._iter_stats.write(
                f"{frame} {r[0]:.6g} {r[1]:.10e} {r[2]:.10e}\n")
        self._log.write(
            f"Timestep{frame} innerIterAmt = {self.inner_iter_total}, "
            f"accumulated line search steps {self.ls_total}\n")
        self._log.write(f"{frame}th tol: {tol:.6e}\n")
        self._log.write(f"sysE = {float(sys_e):.10e}\n")
        self._log.flush()
        self._iter_stats.flush()

    def save_status(self):
        x = np.asarray(self.state.x, np.float64)
        v = np.asarray(self.state.v, np.float64).reshape(-1)
        dxe = np.asarray(self.state.dx_elastic, np.float64)
        n = self.frame
        with open(os.path.join(self.out, f"status{n}"), "w") as f:
            f.write(f"timestep {n}\n")
            f.write(f"\nposition {x.shape[0]} 3\n")
            for r in x:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
            f.write(f"\nvelocity {v.size}\n")
            for val in v:
                f.write("%le\n" % val)
            f.write(f"\ndx_Elastic {dxe.shape[0]} 3\n")
            for r in dxe:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
        meshio.write_obj(os.path.join(self.out, f"{n}.obj"),
                         x, self.mesh.conn)

    def finalize(self):
        self.save_status()
        with open(os.path.join(self.out, "info.txt"), "w") as f:
            f.write(f"vertAmt {self.mesh.n_vert}\n"
                    f"elemAmt {self.mesh.n_elem}\n"
                    f"frames {self.frame}\n"
                    f"innerIterTotal {self.inner_iter_total}\n"
                    f"lineSearchTotal {self.ls_total}\n")
        if self.render:
            from .render import render_run_dir
            try:
                render_run_dir(self.out,
                               fps=max(1, round(1.0 / self.cfg.dt)))
            except Exception as exc:
                if not self.mute:
                    print(f"(render skipped: {exc})")
        self._iter_stats.close()
        self._log.close()


def run_script_2d(script_path, suffix="", frames=None,
                  output_root="output", dtype=None, save_every=1):
    from .config import Config
    from .sim import pick_dtype
    cfg = Config.load(script_path)
    name = cfg.output_folder_name()
    if suffix:
        name += "_" + suffix
    out = os.path.join(output_root, name)
    sim = Sim2D(cfg, out, dtype=pick_dtype(dtype), save_every=save_every)
    spf = sim.run(frames)
    sim.finalize()
    return sim, spf
