"""2D (triangle-element) SoA kernels: 2x2 flip-SVD, sigma-space
materials, per-element gradient and 6x6 SPD-projected Hessian.

The reference is dimension-templated end-to-end (Mesh<2> + the dim == 2
branches of Energy.cpp / FixedCoRotEnergy.cpp / StableNHEnergy.cpp, the
2x2 AutoFlipSVD, and IglUtils::makePD2d, IglUtils.hpp:276-308); this
module is the dim-2 instantiation, built in the same
structure-of-arrays scalar form as the 3D kernels in soa.py (batched
(N,) vectors; no (N, 2, 2) matmuls — see soa.py for why).

Conventions: a 2x2 matrix is a 4-tuple (m00, m01, m10, m11) of (N,)
arrays; sigma = (s0, s1) with s0 >= |s1| and s1 signed negative under
inversion (flip-SVD: U, V proper rotations, det U = det V = +1).
"""

from __future__ import annotations

import jax.numpy as jnp

_SUM_SIGMA_EPS = 1.0e-6  # reference: Energy.cpp:1112-1117 (dim-2 analog)


# ---------------------------------------------------------------------------
# 2x2 linear algebra (SoA)
# ---------------------------------------------------------------------------
def cofactor2_soa(f):
    """dJ/dF for J = det F: ((f11, -f10, -f01, f00))."""
    f00, f01, f10, f11 = f
    return (f11, -f10, -f01, f00)


def mmT2(a, b):
    """A @ B^T for mat2 tuples."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b01, a00 * b10 + a01 * b11,
            a10 * b00 + a11 * b01, a10 * b10 + a11 * b11)


def svd2_flip_soa(f):
    """Branch-free closed-form 2x2 flip-SVD (reference: the 2x2 path of
    AutoFlipSVD.hpp): F = U diag(s0, s1) V^T with U, V proper rotations
    and s1 carrying the inversion sign (det F = s0 * s1), s0 >= |s1|.

    Uses the rotation-sum/difference decomposition: with
    E=(f00+f11)/2, Fm=(f00-f11)/2, G=(f10+f01)/2, H=(f10-f01)/2:
    s0 = Q+R, s1 = Q-R (Q = |(E,H)|, R = |(Fm,G)|), U = Rot((a2+a1)/2),
    V = Rot((a1-a2)/2) for a1 = atan2(G, Fm), a2 = atan2(H, E).
    """
    f00, f01, f10, f11 = f
    E = 0.5 * (f00 + f11)
    Fm = 0.5 * (f00 - f11)
    G = 0.5 * (f10 + f01)
    H = 0.5 * (f10 - f01)
    Q = jnp.sqrt(E * E + H * H)
    R = jnp.sqrt(Fm * Fm + G * G)
    s0 = Q + R
    s1 = Q - R
    a1 = jnp.arctan2(G, Fm)
    a2 = jnp.arctan2(H, E)
    gam = 0.5 * (a2 + a1)    # U angle
    bet = 0.5 * (a2 - a1)    # V^T angle -> V = Rot(-bet)
    cu, su = jnp.cos(gam), jnp.sin(gam)
    cv, sv = jnp.cos(bet), jnp.sin(bet)
    U = (cu, -su, su, cu)
    V = (cv, sv, -sv, cv)    # Rot(-bet)
    return U, (s0, s1), V


def eigh2_soa(a, b, c):
    """Symmetric 2x2 [[a, b], [b, c]] eigendecomposition, branch-free:
    returns (lam0, lam1), Q (mat2, columns = eigenvectors). The SPD
    projection (reference makePD2d, IglUtils.hpp:276-308) is eigenvalue
    clamping on these."""
    mean = 0.5 * (a + c)
    half = 0.5 * (a - c)
    r = jnp.sqrt(half * half + b * b)
    th = 0.5 * jnp.arctan2(2.0 * b, a - c)
    ct, st = jnp.cos(th), jnp.sin(th)
    # columns: v0 = (ct, st) for lam0 = mean + r, v1 = (-st, ct)
    return (mean + r, mean - r), (ct, -st, st, ct)


def make_pd2_soa(h3):
    """SPD projection of sym2 (h00, h01, h11) by eigenvalue clamping
    (reference: makePD2d, IglUtils.hpp:276-308); the dim-2 analog of
    soa.make_pd3_soa."""
    (l0, l1), Q = eigh2_soa(*h3)
    l0 = jnp.maximum(l0, 0.0)
    l1 = jnp.maximum(l1, 0.0)
    q00, q01, q10, q11 = Q       # columns: v0 = (q00, q10), v1 = (q01, q11)
    return (l0 * q00 * q00 + l1 * q01 * q01,
            l0 * q00 * q10 + l1 * q01 * q11,
            l0 * q10 * q10 + l1 * q11 * q11)


# ---------------------------------------------------------------------------
# sigma-space materials (dim-2 branches of the reference energies)
# ---------------------------------------------------------------------------
class FCR2D:
    """Fixed Co-Rotational, dim 2 (FixedCoRotEnergy.cpp dim==2 paths):
    Psi = u ||sigma - 1||^2 + lam/2 (J - 1)^2, J = s0 s1."""

    name = "FCR"

    @staticmethod
    def psi(s, u, lam):
        s0, s1 = s
        jm1 = s0 * s1 - 1.0
        return u * ((s0 - 1.0) ** 2 + (s1 - 1.0) ** 2) + 0.5 * lam * jm1 * jm1

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        t = lam * (s0 * s1 - 1.0)
        return (2.0 * u * (s0 - 1.0) + s1 * t,
                2.0 * u * (s1 - 1.0) + s0 * t)

    @staticmethod
    def d2psi(s, u, lam):
        """(h00, h01, h11)."""
        s0, s1 = s
        return (2.0 * u + lam * s1 * s1,
                lam * (2.0 * s0 * s1 - 1.0),
                2.0 * u + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1 = s
        return u - 0.5 * lam * (s0 * s1 - 1.0)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        R = mmT2(U, V)
        t = lam * (s[0] * s[1] - 1.0)
        cof = cofactor2_soa(f)
        return tuple(2.0 * u * (f[k] - R[k]) + t * cof[k] for k in range(4))


class SNH2D:
    """Stable Neo-Hookean (no-log), dim 2 (StableNHEnergy.cpp dim==2):
    Psi = u/2 (||sigma||^2 - 2) + lam/2 (J - alpha)^2, alpha = 1 + u/lam."""

    name = "SNH"

    @staticmethod
    def psi(s, u, lam):
        s0, s1 = s
        jma = s0 * s1 - (1.0 + u / lam)
        return 0.5 * (u * (s0 * s0 + s1 * s1 - 2.0) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        t = lam * (s0 * s1 - (1.0 + u / lam))
        return (u * s0 + s1 * t, u * s1 + s0 * t)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1 = s
        return (u + lam * s1 * s1,
                lam * (2.0 * s0 * s1 - (1.0 + u / lam)),
                u + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        s0, s1 = s
        return 0.5 * (u - lam * (s0 * s1 - (1.0 + u / lam)))

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        t = lam * (s[0] * s[1] - (1.0 + u / lam))
        cof = cofactor2_soa(f)
        return tuple(u * f[k] + t * cof[k] for k in range(4))


class SNHWL2D:
    """Stable Neo-Hookean, regularized-log variant, dim 2 (the SNH_WITHLOG
    build's dim==2 branches): Psi = u/2 (S - 2 - log(S+1)) +
    lam/2 (J - alpha)^2, S = ||sigma||^2, alpha = 1 + 3u/(4 lam)."""

    name = "SNHWL"

    @staticmethod
    def _parts(s, u, lam):
        s0, s1 = s
        s_sq1 = s0 * s0 + s1 * s1 + 1.0
        t1 = u * (1.0 - 1.0 / s_sq1)
        jma = s0 * s1 - (1.0 + 0.75 * u / lam)
        return s_sq1, t1, jma

    @staticmethod
    def psi(s, u, lam):
        s_sq1, _, jma = SNHWL2D._parts(s, u, lam)
        return 0.5 * (u * (s_sq1 - 3.0 - jnp.log(s_sq1)) + lam * jma * jma)

    @staticmethod
    def dpsi(s, u, lam):
        s0, s1 = s
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        t0 = lam * jma
        return (s0 * t1 + s1 * t0, s1 * t1 + s0 * t0)

    @staticmethod
    def d2psi(s, u, lam):
        s0, s1 = s
        s_sq1, t1, jma = SNHWL2D._parts(s, u, lam)
        cv = 2.0 * u / (s_sq1 * s_sq1)
        return (t1 + cv * s0 * s0 + lam * s1 * s1,
                cv * s0 * s1 + lam * (s0 * s1 + jma),
                t1 + cv * s1 * s1 + lam * s0 * s0)

    @staticmethod
    def b_left(s, u, lam):
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        return 0.5 * (t1 - lam * jma)

    @staticmethod
    def first_piola(f, U, s, V, u, lam):
        _, t1, jma = SNHWL2D._parts(s, u, lam)
        cof = cofactor2_soa(f)
        t0 = lam * jma
        return tuple(t1 * f[k] + t0 * cof[k] for k in range(4))


SOA2D_MATERIALS = {"FCR": FCR2D, "SNH": SNH2D, "SNHWL": SNHWL2D}


# ---------------------------------------------------------------------------
# element kernels
# ---------------------------------------------------------------------------
def defgrad2_soa(xT, conn, g):
    """xT: (2, nV); conn: 3-tuple of (N,) corner indices; g: mat2 tuple of
    restTriInv. F = Xt @ G with Xt columns = x_k - x_0
    (reference: Energy.cpp:396-415 at dim 2)."""
    xc = [[xT[d][conn[c]] for d in range(2)] for c in range(3)]
    e = [[xc[k + 1][d] - xc[0][d] for d in range(2)] for k in range(2)]
    return tuple(
        e[0][i] * g[2 * 0 + j] + e[1][i] * g[2 * 1 + j]
        for i in range(2) for j in range(2))


def element_gradient2_soa(mat, f, U, s, V, D, u, lam, w):
    """D: list[3][2] of (N,). Returns g[c][d] list[3][2] of (N,)."""
    P = mat.first_piola(f, U, s, V, u, lam)
    Pw = tuple(p * w for p in P)
    return [[sum(D[c][j] * Pw[2 * d + j] for j in range(2)) for d in range(2)]
            for c in range(3)]


def element_hessian2_soa(mat, U, s, V, D, u, lam, w, project_spd=True):
    """6x6 element Hessian as a list of 36 (N,) arrays, dof order
    (corner, xy), row-major H[(c*2+i)*6 + e*2+k].

    Same rank-1 eigen-sum form as the 3D kernel (soa.element_hessian_soa;
    reference construction: Energy.cpp:1129-1271 at dim 2 with makePD2d):
    H = sum_a alpha_a y_a y_a^T + L p p^T + R q q^T, with (alpha, Q) the
    clamped eigenpairs of d2Psi/dsigma2 and the single twist/flip pair
    contributing p = Wx + Wy, q = Wx - Wy,
    L/R = BLeftCoef -+ (dPsi_0 + dPsi_1)/(2 (s0 + s1)), clamped.
    """
    h00, h01, h11 = mat.d2psi(s, u, lam)
    alpha, Q = eigh2_soa(h00, h01, h11)
    dpsi = mat.dpsi(s, u, lam)
    bl = mat.b_left(s, u, lam)

    ssum = s[0] + s[1]
    denom = jnp.where(ssum < _SUM_SIGMA_EPS, _SUM_SIGMA_EPS, ssum)
    br = (dpsi[0] + dpsi[1]) / (2.0 * denom)

    L, R = bl, br
    if project_spd:
        alpha = tuple(jnp.maximum(x, 0.0) for x in alpha)
        L = jnp.maximum(L, 0.0)
        R = jnp.maximum(R, 0.0)

    # DV[c][b] = sum_j D[c][j] V[j][b]
    DV = [[sum(D[c][j] * V[2 * j + b] for j in range(2)) for b in range(2)]
          for c in range(3)]

    # A-part vectors y_a[(c,i)] = sum_d Q[d][a] U[i][d] DV[c][d]
    ys = []
    for a in range(2):
        y = []
        for c in range(3):
            for i in range(2):
                y.append(sum(Q[2 * d + a] * U[2 * i + d] * DV[c][d]
                             for d in range(2)))
        ys.append(y)

    # twist/flip pair over (0, 1)
    pv, qv = [], []
    for c in range(3):
        for i in range(2):
            wx = U[2 * i + 0] * DV[c][1]
            wy = U[2 * i + 1] * DV[c][0]
            pv.append(wx + wy)
            qv.append(wx - wy)

    coeffs = [alpha[0], alpha[1], L, R]
    vecs = [ys[0], ys[1], pv, qv]

    H = [None] * 36
    for r in range(6):
        for cidx in range(r, 6):
            acc = sum(cf * v[r] * v[cidx] for cf, v in zip(coeffs, vecs))
            acc = acc * w
            H[r * 6 + cidx] = acc
            if cidx != r:
                H[cidx * 6 + r] = acc
    return H
