"""Batched 3x3 symmetric eigendecomposition and flip-SVD (AoS API).

The compute core is the SoA formulation in `soa.py` (see its docstring for
the layout rationale and the reference mapping —
src/Utils/AutoFlipSVD.hpp, src/Utils/SVD_EFTYCHIOS/). These wrappers
unpack (..., 3, 3) arrays into component tuples and back.

Flip-SVD convention (reference: AutoFlipSVD.hpp:41-82): U and V proper
rotations (det = +1), singular values sorted descending by magnitude, the
LAST singular value signed by det(F).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import soa


def eigh3x3(A, sweeps=None):
    """Symmetric (..., 3, 3) -> (w (unsorted), Q) with A ~= Q diag(w) Q^T."""
    a6 = (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
          A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    w, Q = soa.jacobi_eigh_soa(a6, sweeps)
    return jnp.stack(w, axis=-1), soa.mat_stack(Q)


def svd3x3_flip(F, sweeps=None):
    """Flip-aware SVD of (..., 3, 3): returns (U, sigma, V)."""
    U, s, V = soa.svd3_flip_soa(soa.mat_unstack(F), sweeps)
    return soa.mat_stack(U), jnp.stack(s, axis=-1), soa.mat_stack(V)


def make_pd3(A):
    """Project symmetric (..., 3, 3) to nearest PSD by eigenvalue clamping
    (reference: IglUtils::makePD, IglUtils.hpp:253-268)."""
    a6 = (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
          A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    p = soa.make_pd3_soa(a6)
    row0 = jnp.stack([p[0], p[1], p[2]], axis=-1)
    row1 = jnp.stack([p[1], p[3], p[4]], axis=-1)
    row2 = jnp.stack([p[2], p[4], p[5]], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def make_pd2_lr(left, right):
    """PSD projection of the twist/flip blocks [[L+R, L-R], [L-R, L+R]]:
    eigenpairs (2L, [1,1]), (2R, [1,-1]) -> clamp L and R at zero."""
    return jnp.maximum(left, 0.0), jnp.maximum(right, 0.0)
