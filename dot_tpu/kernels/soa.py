"""Structure-of-arrays kernel core: all 3x3/12x12 element math as unrolled
scalar ops over long element vectors.

WHY: batched (N, 3, 3) matmuls make tiny, badly shaped matrix problems
for any accelerator's matrix units, and arrays with a trailing dim of 3
move poorly through memory. The SoA form — each matrix component a
separate contiguous (N,) vector — makes the whole chain (F -> flip-SVD ->
Psi/P -> rank-1 Hessian) one fused elementwise kernel with coalesced
loads. This is the same formulation as the reference's AVX2 batch kernel
(src/Utils/SVD_EFTYCHIOS/, SoA buffers at main.cpp:521-597). Whether it
also wins on the GPU is open (ROADMAP Queue 1.9).

Conventions:
  mat3 : tuple of 9 (N,) arrays, row-major (m00, m01, ..., m22)
  sym3 : tuple of 6 (N,) arrays (a00, a01, a02, a11, a12, a22)
  vec3 : tuple of 3 (N,) arrays

The 12x12 element Hessian is built as a sum of 9 rank-1 outer products
(3 eigen-directions of the SPD-projected diagonal-space block A + 2 per
twist/flip pair), which *is* the reference's compute_dP_div_dF + chain rule
(Energy.cpp:1129-1271) with the congruence transform expanded analytically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# tuple-matrix helpers
# ---------------------------------------------------------------------------


def mat_unstack(A):
    """(..., 3, 3) -> mat3 tuple."""
    return tuple(A[..., i, j] for i in range(3) for j in range(3))


def mat_stack(m):
    """mat3 tuple -> (..., 3, 3)."""
    rows = [jnp.stack(m[3 * i: 3 * i + 3], axis=-1) for i in range(3)]
    return jnp.stack(rows, axis=-2)


def mm(a, b):
    """mat3 @ mat3."""
    return tuple(
        a[3 * i + 0] * b[0 + j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def mmT(a, b):
    """mat3 @ mat3^T."""
    return tuple(
        a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] + a[3 * i + 2] * b[3 * j + 2]
        for i in range(3) for j in range(3))


def mTm_sym(a):
    """a^T a as sym3."""
    def col(j):
        return (a[j], a[3 + j], a[6 + j])
    c = [col(j) for j in range(3)]

    def dot(x, y):
        return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]
    return (dot(c[0], c[0]), dot(c[0], c[1]), dot(c[0], c[2]),
            dot(c[1], c[1]), dot(c[1], c[2]), dot(c[2], c[2]))


def det3(m):
    return (m[0] * (m[4] * m[8] - m[5] * m[7])
            - m[1] * (m[3] * m[8] - m[5] * m[6])
            + m[2] * (m[3] * m[7] - m[4] * m[6]))


def cofactor_soa(f):
    """Cofactor matrix (dJ/dF), columns = cross products of F's columns."""
    # column vectors
    c0 = (f[0], f[3], f[6])
    c1 = (f[1], f[4], f[7])
    c2 = (f[2], f[5], f[8])

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])
    k0, k1, k2 = cross(c1, c2), cross(c2, c0), cross(c0, c1)
    return (k0[0], k1[0], k2[0],
            k0[1], k1[1], k2[1],
            k0[2], k1[2], k2[2])


# ---------------------------------------------------------------------------
# symmetric 3x3 Jacobi eigendecomposition (SoA, branch-free)
# ---------------------------------------------------------------------------

_SWEEPS_F32 = 4
_SWEEPS_F64 = 10


def _givens(app, aqq, apq, eps):
    small = jnp.abs(apq) <= eps * jnp.sqrt(jnp.abs(app * aqq) + eps)
    tau = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = jax.lax.rsqrt(1.0 + t * t)
    s = t * c
    return jnp.where(small, 1.0, c), jnp.where(small, 0.0, s)


def jacobi_eigh_soa(a, sweeps=None):
    """sym3 -> (evals vec3 (unsorted), eigvecs mat3 with det +1)."""
    a00, a01, a02, a11, a12, a22 = a
    dtype = a00.dtype
    if sweeps is None:
        sweeps = _SWEEPS_F64 if dtype == jnp.float64 else _SWEEPS_F32
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    one = jnp.ones_like(a00)
    zero = jnp.zeros_like(a00)
    V = (one, zero, zero, zero, one, zero, zero, zero, one)

    def sweep(_, carry):
        # One cyclic sweep, unrolled over the three pairs. The sweeps loop
        # itself is rolled (lax.fori_loop): unrolling it makes XLA's CPU
        # pipeline go super-linear in the dependent-chain depth (minutes
        # to compile at 8+ sweeps in f64).
        (a00, a01, a02, a11, a12, a22), V = carry
        # pair (0, 1)
        c, s = _givens(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n01 = (c * c - s * s) * a01 + c * s * (a00 - a11)
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a01, a02, a11, a12 = n00, n01, n02, n11, n12
        V = _rotcols(V, 0, 1, c, s)
        # pair (0, 2)
        c, s = _givens(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n02 = (c * c - s * s) * a02 + c * s * (a00 - a22)
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a01, a02, a12, a22 = n00, n01, n02, n12, n22
        V = _rotcols(V, 0, 2, c, s)
        # pair (1, 2)
        c, s = _givens(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n12 = (c * c - s * s) * a12 + c * s * (a11 - a22)
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a01, a02, a11, a12, a22 = n01, n02, n11, n12, n22
        V = _rotcols(V, 1, 2, c, s)
        return (a00, a01, a02, a11, a12, a22), V

    (a00, a01, a02, a11, a12, a22), V = jax.lax.fori_loop(
        0, sweeps, sweep, ((a00, a01, a02, a11, a12, a22), V))
    return (a00, a11, a22), V


def _rotcols(V, p, q, c, s):
    """V <- V J, J the (p, q) Givens rotation."""
    V = list(V)
    for i in range(3):
        vp, vq = V[3 * i + p], V[3 * i + q]
        V[3 * i + p] = c * vp - s * vq
        V[3 * i + q] = s * vp + c * vq
    return tuple(V)


def _sort3_desc_soa(w, V):
    """Sort eigenvalues descending, permuting V columns."""
    w = list(w)
    V = list(V)

    def cswap(p, q):
        do = w[p] < w[q]
        w[p], w[q] = (jnp.where(do, w[q], w[p]), jnp.where(do, w[p], w[q]))
        for i in range(3):
            vp, vq = V[3 * i + p], V[3 * i + q]
            V[3 * i + p] = jnp.where(do, vq, vp)
            V[3 * i + q] = jnp.where(do, vp, vq)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    return tuple(w), tuple(V)


# ---------------------------------------------------------------------------
# flip-SVD (SoA)
# ---------------------------------------------------------------------------


def svd3_flip_soa(f, sweeps=None):
    """mat3 F -> (U mat3, sigma vec3, V mat3), flip convention:
    det(U)=det(V)=+1, s0 >= s1 >= |s2|, sign(s2) = sign(det F)."""
    dtype = f[0].dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    amax = f[0]
    for k in range(1, 9):
        amax = jnp.maximum(amax, jnp.abs(f[k]))
    amax = jnp.maximum(amax, jnp.abs(f[0]))
    scale = jnp.where(amax > 0, amax, 1.0)
    fn = tuple(x / scale for x in f)

    a = mTm_sym(fn)
    w, V = jacobi_eigh_soa(a, sweeps)
    w, V = _sort3_desc_soa(w, V)

    detV = det3(V)
    sgn = jnp.sign(detV)
    V = list(V)
    for i in range(3):
        V[3 * i + 2] = V[3 * i + 2] * sgn
    V = tuple(V)

    B = mm(fn, V)  # columns b_i = sigma_i u_i
    b0 = (B[0], B[3], B[6])
    b1 = (B[1], B[4], B[7])
    b2 = (B[2], B[5], B[8])
    tol = 16.0 * eps

    n0 = jnp.sqrt(b0[0] * b0[0] + b0[1] * b0[1] + b0[2] * b0[2])
    inv0 = 1.0 / jnp.maximum(n0, tol)
    ok0 = n0 > tol
    u0 = tuple(jnp.where(ok0, b0[d] * inv0, 1.0 if d == 0 else 0.0)
               for d in range(3))

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    b1o = tuple(b1[d] - d01 * u0[d] for d in range(3))
    n1 = jnp.sqrt(b1o[0] ** 2 + b1o[1] ** 2 + b1o[2] ** 2)
    ok1 = n1 > tol * jnp.maximum(n0, 1.0)
    inv1 = 1.0 / jnp.maximum(n1, tol)
    # fallback: unit vector orthogonal to u0 — cross with the axis least
    # aligned with u0
    au = [jnp.abs(u0[0]), jnp.abs(u0[1]), jnp.abs(u0[2])]
    m01 = au[0] < au[1]
    m = jnp.where(m01, jnp.where(au[0] < au[2], 0, 2),
                  jnp.where(au[1] < au[2], 1, 2))
    e = tuple((m == d).astype(u0[0].dtype) for d in range(3))
    fb = (u0[1] * e[2] - u0[2] * e[1],
          u0[2] * e[0] - u0[0] * e[2],
          u0[0] * e[1] - u0[1] * e[0])
    nf = jnp.sqrt(fb[0] ** 2 + fb[1] ** 2 + fb[2] ** 2)
    invf = 1.0 / jnp.maximum(nf, tol)
    u1 = tuple(jnp.where(ok1, b1o[d] * inv1, fb[d] * invf) for d in range(3))

    u2 = (u0[1] * u1[2] - u0[2] * u1[1],
          u0[2] * u1[0] - u0[0] * u1[2],
          u0[0] * u1[1] - u0[1] * u1[0])

    U = (u0[0], u1[0], u2[0],
         u0[1], u1[1], u2[1],
         u0[2], u1[2], u2[2])
    s0 = n0 * scale
    s1 = (u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2]) * scale
    s2 = (u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2]) * scale
    return U, (s0, s1, s2), V


def make_pd3_soa(a):
    """SPD projection of sym3 by eigenvalue clamping; returns sym3."""
    w, Q = jacobi_eigh_soa(a)
    w = tuple(jnp.maximum(x, 0.0) for x in w)
    out = []
    for i in range(3):
        for j in range(i, 3):
            out.append(w[0] * Q[3 * i] * Q[3 * j]
                       + w[1] * Q[3 * i + 1] * Q[3 * j + 1]
                       + w[2] * Q[3 * i + 2] * Q[3 * j + 2])
    return tuple(out)  # (00, 01, 02, 11, 12, 22)


# ---------------------------------------------------------------------------
# materials (SoA): diagonal-space primitives + first Piola-Kirchhoff
# ---------------------------------------------------------------------------


class FCR_SOA:
    """Fixed Co-Rotational (reference: FixedCoRotEnergy.cpp:82-183)."""

    @staticmethod
    def psi(s, u, lam):
        s0, s1, s2 = s
        sq = (s0 - 1) ** 2 + (s1 - 1) ** 2 + (s2 - 1) ** 2
        jm1 = s0 * s1 * s2 - 1.0
        return u * sq + 0.5 * lam * jm1 * jm1

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - 1.0)
        return (2 * u * (s0 - 1) + s1 * s2 * t,
                2 * u * (s1 - 1) + s2 * s0 * t,
                2 * u * (s2 - 1) + s0 * s1 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        pm1 = s0 * s1 * s2 - 1.0
        return (2 * u + lam * sp0 * sp0,
                lam * (s2 * pm1 + sp0 * sp1),
                lam * (s1 * pm1 + sp0 * sp2),
                2 * u + lam * sp1 * sp1,
                lam * (s0 * pm1 + sp2 * sp1),
                2 * u + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        pm1 = s0 * s1 * s2 - 1.0
        hl = 0.5 * lam
        return (u - hl * s2 * pm1, u - hl * s0 * pm1, u - hl * s1 * pm1)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        R = mmT(U, V)
        jm1 = s[0] * s[1] * s[2] - 1.0
        cof = cofactor_soa(f)
        t = lam * jm1
        return tuple(2 * u * (f[k] - R[k]) + t * cof[k] for k in range(9))


class SNH_SOA:
    """Stable Neo-Hookean, no-log variant
    (reference: StableNHEnergy.cpp:79-251)."""

    @staticmethod
    def psi(s, u, lam):
        s0, s1, s2 = s
        jma = s0 * s1 * s2 - (1.0 + u / lam)
        return 0.5 * (u * (s0 * s0 + s1 * s1 + s2 * s2 - 3.0) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - (1.0 + u / lam))
        return (u * s0 + s1 * s2 * t, u * s1 + s2 * s0 * t, u * s2 + s0 * s1 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        l2 = lam * (2.0 * s0 * s1 * s2 - (1.0 + u / lam))
        return (u + lam * sp0 * sp0, s2 * l2, s1 * l2,
                u + lam * sp1 * sp1, s0 * l2,
                u + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        t = lam * (s0 * s1 * s2 - (1.0 + u / lam))
        return (0.5 * (u - t * s2), 0.5 * (u - t * s0), 0.5 * (u - t * s1))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        jma = s[0] * s[1] * s[2] - (1.0 + u / lam)
        cof = cofactor_soa(f)
        t = lam * jma
        return tuple(u * f[k] + t * cof[k] for k in range(9))


class SNHWL_SOA:
    """Stable Neo-Hookean, regularized-log variant (the reference's
    SNH_WITHLOG compile-time build, Types.hpp:36;
    StableNHEnergy.cpp:84-96, 102-114, 134-170, 204-216, 237-243):
    Psi = u/2 (S - 3 - log(S+1)) + lam/2 (J - alpha)^2 with
    S = ||sigma||^2, alpha = 1 + 3u/(4 lam). log(S+1) is defined for
    every F — no sigma > 0 barrier."""

    @staticmethod
    def _parts(s, u, lam):
        s0, s1, s2 = s
        s_sq1 = s0 * s0 + s1 * s1 + s2 * s2 + 1.0
        t1 = u * (1.0 - 1.0 / s_sq1)
        jma = s0 * s1 * s2 - (1.0 + 0.75 * u / lam)
        return s_sq1, t1, jma

    @staticmethod
    def psi(s, u, lam):
        s_sq1, _, jma = SNHWL_SOA._parts(s, u, lam)
        return 0.5 * (u * (s_sq1 - 4.0 - jnp.log(s_sq1)) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1, s2 = s
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        t0 = lam * jma
        return (s0 * t1 + s1 * s2 * t0,
                s1 * t1 + s2 * s0 * t0,
                s2 * t1 + s0 * s1 * t0)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1, s2 = s
        s_sq1, t1, jma = SNHWL_SOA._parts(s, u, lam)
        cv = 2.0 * u / (s_sq1 * s_sq1)
        sp0, sp1, sp2 = s1 * s2, s2 * s0, s0 * s1
        l2 = lam * (s0 * s1 * s2 + jma)      # lam (2J - alpha)
        return (t1 + cv * s0 * s0 + lam * sp0 * sp0,
                cv * s0 * s1 + s2 * l2,
                cv * s0 * s2 + s1 * l2,
                t1 + cv * s1 * s1 + lam * sp1 * sp1,
                cv * s1 * s2 + s0 * l2,
                t1 + cv * s2 * s2 + lam * sp2 * sp2)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1, s2 = s
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        t0 = lam * jma
        return (0.5 * (t1 - t0 * s2), 0.5 * (t1 - t0 * s0),
                0.5 * (t1 - t0 * s1))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        _, t1, jma = SNHWL_SOA._parts(s, u, lam)
        cof = cofactor_soa(f)
        t0 = lam * jma
        return tuple(t1 * f[k] + t0 * cof[k] for k in range(9))


SOA_MATERIALS = {"FCR": FCR_SOA, "SNH": SNH_SOA, "SNHWL": SNHWL_SOA}


# ---------------------------------------------------------------------------
# element kernels (SoA)
# ---------------------------------------------------------------------------

_SUM_SIGMA_EPS = 1.0e-6  # reference: Energy.cpp:1112-1117


def defgrad_soa(xT, conn, g):
    """xT: (3, nV); conn: 4-tuple of (N,) corner index vectors (contiguous
    per corner — column slices of an (N, 4) array are strided reads); g: mat3 tuple of restTriInv.
    Returns F mat3 with F = Xt @ G, Xt columns = x_k - x_0."""
    if not isinstance(conn, (tuple, list)):
        conn = tuple(conn[:, c] for c in range(4))
    xc = [[xT[d][conn[c]] for d in range(3)] for c in range(4)]
    e = [[xc[k + 1][d] - xc[0][d] for d in range(3)] for k in range(3)]
    return tuple(
        e[0][i] * g[3 * 0 + j] + e[1][i] * g[3 * 1 + j] + e[2][i] * g[3 * 2 + j]
        for i in range(3) for j in range(3))


def element_gradient_soa(mat, f, U, s, V, D, u, lam, w):
    """D: list[4][3] of (N,) arrays. Returns g[c][d] list[4][3] of (N,)."""
    P = mat.first_piola(f, U, s, V, u, lam)
    Pw = tuple(p * w for p in P)
    return [[sum(D[c][j] * Pw[3 * d + j] for j in range(3)) for d in range(3)]
            for c in range(4)]


def element_hessian_soa(mat, U, s, V, D, u, lam, w, project_spd=True):
    """Returns H as list of 144 (N,) arrays, dof order (corner, xyz),
    row-major: H[(c*3+i)*12 + e*3+k].

    Rank-1 eigen form of the reference's diagonal-space construction:
    H = sum_a alpha_a y_a y_a^T + sum_k (L_k p_k p_k^T + R_k q_k q_k^T)
    where alpha/Q are the (clamped) eigen-pairs of d2Psi/dsigma2, and the
    twist/flip pairs contribute p = Wx + Wy, q = Wx - Wy with
    L/R = BLeftCoef -+ (dPsi_i + dPsi_j)/(2 (sigma_i + sigma_j)) clamped.
    """
    a6 = mat.d2psi(s, u, lam)
    alpha, Q = jacobi_eigh_soa(a6)
    dpsi = mat.dpsi(s, u, lam)
    bl = mat.b_left(s, u, lam)

    def right(ci, cj):
        ssum = s[ci] + s[cj]
        denom = jnp.where(ssum < _SUM_SIGMA_EPS, _SUM_SIGMA_EPS, ssum)
        return (dpsi[ci] + dpsi[cj]) / (2.0 * denom)

    rights = (right(0, 1), right(1, 2), right(2, 0))
    L = list(bl)
    R = list(rights)
    if project_spd:
        alpha = tuple(jnp.maximum(x, 0.0) for x in alpha)
        L = [jnp.maximum(x, 0.0) for x in L]
        R = [jnp.maximum(x, 0.0) for x in R]

    # DV[c][b] = sum_j D[c][j] V[j][b]
    DV = [[sum(D[c][j] * V[3 * j + b] for j in range(3)) for b in range(3)]
          for c in range(4)]

    # A-part vectors: y_a[(c,i)] = sum_d Q[d][a] U[i][d] DV[c][d]
    ys = []
    for a in range(3):
        y = []
        for c in range(4):
            for i in range(3):
                y.append(sum(Q[3 * d + a] * U[3 * i + d] * DV[c][d]
                             for d in range(3)))
        ys.append(y)

    # twist/flip vectors: for pair k over sigma coords (x, y):
    #   Wx[(c,i)] = U[i][x] DV[c][y],  Wy[(c,i)] = U[i][y] DV[c][x]
    pairs = ((0, 1), (1, 2), (2, 0))
    ps, qs = [], []
    for (x, y) in pairs:
        pv, qv = [], []
        for c in range(4):
            for i in range(3):
                wx = U[3 * i + x] * DV[c][y]
                wy = U[3 * i + y] * DV[c][x]
                pv.append(wx + wy)
                qv.append(wx - wy)
        ps.append(pv)
        qs.append(qv)

    # H = sum of 9 rank-1 terms, weighted by w at the end
    coeffs = ([alpha[a] for a in range(3)]
              + [L[k] for k in range(3)] + [R[k] for k in range(3)])
    vecs = ys + ps + qs

    H = [None] * 144
    for r in range(12):
        for c in range(r, 12):
            acc = coeffs[0] * vecs[0][r] * vecs[0][c]
            for t in range(1, 9):
                acc = acc + coeffs[t] * vecs[t][r] * vecs[t][c]
            acc = acc * w
            H[r * 12 + c] = acc
            if c != r:
                H[c * 12 + r] = acc
    return H
