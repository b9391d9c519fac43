"""Batched per-element kernels: deformation gradient, energy, gradient,
and the 12x12 SPD-projected element Hessian.

The implementation lives in `soa.py` (structure-of-arrays scalar form —
the layout the steppers run); this module provides the array-of-structures API
used by tests and by host-side precompute. See soa.py for the
reference-mapping documentation (Energy.cpp:294-780, 1129-1271).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import soa
from .svd3 import svd3x3_flip  # noqa: F401  (re-export for convenience)


def corner_basis(rest_tri_inv):
    """(nE, 4, 3) D with dF/dx_{c,d} = e_d (x) D[c, :]; row 0 is minus the
    column sums of restTriInv (reference: dF_div_dx_mult,
    IglUtils.hpp:385-483)."""
    g = rest_tri_inv
    row0 = -jnp.sum(g, axis=-2, keepdims=True)
    return jnp.concatenate([row0, g], axis=-2)


def deformation_gradient(x, conn, rest_tri_inv):
    """F (nE, 3, 3) = Xt @ restTriInv (reference: Energy.cpp:396-415)."""
    f = soa.defgrad_soa(x.T, conn, soa.mat_unstack(rest_tri_inv))
    return soa.mat_stack(f)


def svd_of_F(F):
    return svd3x3_flip(F)


def energy_per_element(material, sigma, u, lam, w):
    """w_e * Psi(sigma_e) — reference: Energy::getEnergyValPerElemBySVD."""
    mat = soa.SOA_MATERIALS[material.name]
    s = (sigma[..., 0], sigma[..., 1], sigma[..., 2])
    return mat.psi(s, u, lam) * w


def _unpack(material, F, U, sigma, V, D):
    mat = soa.SOA_MATERIALS[material.name]
    f = soa.mat_unstack(F) if F is not None else None
    u9 = soa.mat_unstack(U)
    v9 = soa.mat_unstack(V)
    s = (sigma[..., 0], sigma[..., 1], sigma[..., 2])
    Dl = [[D[..., c, j] for j in range(3)] for c in range(4)]
    return mat, f, u9, s, v9, Dl


def element_gradient(material, F, U, sigma, V, D, u, lam, w):
    """(nE, 4, 3) per-corner gradient contributions
    (reference: Energy::computeGradientByPK, Energy.cpp:704-737)."""
    mat, f, u9, s, v9, Dl = _unpack(material, F, U, sigma, V, D)
    g = soa.element_gradient_soa(mat, f, u9, s, v9, Dl, u, lam, w)
    rows = [jnp.stack(g[c], axis=-1) for c in range(4)]
    return jnp.stack(rows, axis=-2)


def element_hessian(material, U, sigma, V, D, u, lam, w, project_spd=True):
    """(nE, 12, 12) element Hessian, dof order (corner, xyz)
    (reference: Energy::computeHessianByPK, Energy.cpp:738-780)."""
    mat, _, u9, s, v9, Dl = _unpack(material, None, U, sigma, V, D)
    H = soa.element_hessian_soa(mat, u9, s, v9, Dl, u, lam, w,
                                project_spd=project_spd)
    cols = [jnp.stack(H[r * 12: (r + 1) * 12], axis=-1) for r in range(12)]
    return jnp.stack(cols, axis=-2)


def element_quadratic_form(H12, p, conn):
    """sum_e p_e^T H_e p_e (DOT alpha-init, Optimizer.cpp:1075-1093)."""
    pe = p[conn].reshape(conn.shape[0], 12)
    return jnp.sum(pe * jnp.einsum("eij,ej->ei", H12, pe))
