"""Quadratic Generalized Moving Least Squares (Q-GMLS) shape functions.

One-time precompute that binds each entity (material point or integration
point) to its 8 surrounding kernel nodes and produces generalized shape
functions Nx [N,8,10] together with exact first (dNx [N,8,3,10]) and second
(ddNx [N,8,3,3,10]) spatial derivatives.

Each kernel node carries 10 generalized coordinates per spatial dimension
(value, 3 linear, 6 quadratic monomial coefficients), so a deformation map is

    phi(p) = sum_i sum_a Nx[p, i, a] * dof[topo[p, i], a]   (dof[.,a] in R^3)

Functional parity with the reference Warp kernels
(reference: simulator/func_utils.py:22-112, simulator/cpu_utils.py:3-264),
but fully vectorized in float64 numpy — no CPU<->GPU ping-pong, no per-thread
loops. Runs once at solver init; the per-step solver consumes the results as
f32/f64 device arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# symmetric quadratic-slot index map: slot of monomial x_a * x_b in the
# 10-vector basis [1, x, y, z, x^2, xy, xz, y^2, yz, z^2]
_QUAD_SLOT = np.zeros((3, 3), dtype=np.int64)
for _a in range(3):
    for _b in range(3):
        x, y = min(_a, _b), max(_a, _b)
        _QUAD_SLOT[_a, _b] = 4 + y if x == 0 else 5 + x + y


def quad_slot(a: int, b: int) -> int:
    return int(_QUAD_SLOT[a, b])


def basis(p: np.ndarray) -> np.ndarray:
    """Quadratic monomial basis P(p): [..., 3] -> [..., 10]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack(
        [np.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z],
        axis=-1,
    )


def basis_grad(p: np.ndarray) -> np.ndarray:
    """dP/dp_j: [..., 3] -> [..., 3, 10] (index j first)."""
    shape = p.shape[:-1]
    out = np.zeros(shape + (3, 10), dtype=p.dtype)
    for j in range(3):
        out[..., j, j + 1] = 1.0
        for i in range(3):
            out[..., j, _QUAD_SLOT[i, j]] += p[..., i]
        out[..., j, _QUAD_SLOT[j, j]] += p[..., j]
    return out


def basis_hess() -> np.ndarray:
    """d2P/dp_j dp_k (constant): [3, 3, 10]."""
    out = np.zeros((3, 3, 10))
    for j in range(3):
        for k in range(3):
            out[j, k, _QUAD_SLOT[j, k]] = 2.0 if j == k else 1.0
    return out


def kernel_weight(r: float, p: np.ndarray, q: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact cubic weight w = (1 - d^2)^3, d = |p-q|/r, with grad/Hessian.

    Returns (w [...], dw [..., 3], ddw [..., 3, 3]); all zero for d >= 1.
    """
    diff = p - q
    u = np.sum(diff * diff, axis=-1) / (r * r)  # d^2
    s = np.maximum(1.0 - u, 0.0)
    w = s**3
    t = diff / (r * r)
    dw = -6.0 * (s**2)[..., None] * t
    eye = np.eye(3)
    ddw = (-6.0 * (s**2) / (r * r))[..., None, None] * eye + (24.0 * s)[..., None, None] * (
        t[..., :, None] * t[..., None, :]
    )
    return w, dw, ddw


def _slot_matrix(q_basis: np.ndarray, q_grad: np.ndarray) -> np.ndarray:
    """Aggregate basis vectors into the 10 generalized-coordinate slots.

    Row 0 is P(q), rows 1..3 are dP/dx_a(q), rows 4..9 collapse the symmetric
    second-derivative vectors (which reduce to 2*e_slot for every pair).
    Shape: [..., 10 slots, 10 basis].
    """
    shape = q_basis.shape[:-1]
    B = np.zeros(shape + (10, 10), dtype=q_basis.dtype)
    B[..., 0, :] = q_basis
    B[..., 1:4, :] = q_grad
    for s in range(4, 10):
        B[..., s, s] = 2.0
    return B


def moment_matrices(pos: np.ndarray, topo: np.ndarray, kernel_pos: np.ndarray,
                    r: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted moment matrix G and its first/second derivatives.

    pos [N,3], topo [N,8] int, kernel_pos [K,3].
    Returns G [N,10,10], dG [N,3,10,10], ddG [N,3,3,10,10].
    """
    q = kernel_pos[topo]                    # [N, 8, 3]
    w, dw, ddw = kernel_weight(r, pos[:, None, :], q)

    Pq = basis(q)                           # [N, 8, 10]
    dPq = basis_grad(q)                     # [N, 8, 3, 10]
    ddP = basis_hess()                      # [3, 3, 10]

    # primitive_i = P P^T + sum_j Pj Pj^T + sum_jk Pjk Pjk^T   [N, 8, 10, 10]
    prim = np.einsum("nia,nib->niab", Pq, Pq, optimize=True)
    prim += np.einsum("nija,nijb->niab", dPq, dPq, optimize=True)
    prim = prim + np.einsum("jka,jkb->ab", ddP, ddP, optimize=True)

    G = np.einsum("ni,niab->nab", w, prim, optimize=True)
    dG = np.einsum("nix,niab->nxab", dw, prim, optimize=True)
    ddG = np.einsum("nixy,niab->nxyab", ddw, prim, optimize=True)
    return G, dG, ddG


def shape_functions(pos: np.ndarray, topo: np.ndarray, kernel_pos: np.ndarray,
                    r: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full Q-GMLS precompute.

    Returns (Nx [N,8,10], dNx [N,8,3,10], ddNx [N,8,3,3,10]) in float64.
    Matches reference semantics incl. the inverse-derivative identities for
    d(G^-1 P) (reference: simulator/cpu_utils.py:159-264).
    """
    pos = np.asarray(pos, np.float64)
    kernel_pos = np.asarray(kernel_pos, np.float64)
    G, dG, ddG = moment_matrices(pos, topo, kernel_pos, r)

    Gi = np.linalg.inv(G)                   # [N,10,10]
    Pp = basis(pos)                         # [N,10]
    dPp = basis_grad(pos)                   # [N,3,10]
    ddPp = basis_hess()                     # [3,3,10]

    Gp = np.einsum("nab,nb->na", Gi, Pp, optimize=True)    # [N,10]

    # dGp[x] = Gi dP_x - Gi dG_x Gi P
    Gi_dG = np.einsum("nab,nxbc->nxac", Gi, dG, optimize=True)        # [N,3,10,10]
    dGp = np.einsum("nab,nxb->nxa", Gi, dPp, optimize=True) - np.einsum("nxab,nb->nxa", Gi_dG, Gp, optimize=True)

    # ddGp[x,y] = Gi ddP_xy - Gi dG_x Gi dP_y - Gi dG_y Gi dP_x
    #             - Gi ddG_xy Gi P + Gi dG_y Gi dG_x Gi P + Gi dG_x Gi dG_y Gi P
    Gi_dPp = np.einsum("nab,nxb->nxa", Gi, dPp, optimize=True)        # [N,3,10]
    ddGp = (
        np.einsum("nab,xyb->nxya", Gi, ddPp, optimize=True)
        - np.einsum("nxab,nyb->nxya", Gi_dG, Gi_dPp, optimize=True)
        - np.einsum("nyab,nxb->nxya", Gi_dG, Gi_dPp, optimize=True)
        - np.einsum("nab,nxybc,nc->nxya", Gi, ddG, Gp, optimize=True)
        + np.einsum("nyab,nxbc,nc->nxya", Gi_dG, Gi_dG, Gp, optimize=True)
        + np.einsum("nxab,nybc,nc->nxya", Gi_dG, Gi_dG, Gp, optimize=True)
    )

    # per-(entity, node) weights and slot matrices
    q = kernel_pos[topo]                    # [N, 8, 3]
    w, dw, ddw = kernel_weight(r, pos[:, None, :], q)
    B = _slot_matrix(basis(q), basis_grad(q))          # [N,8,10,10]

    BGp = np.einsum("nisb,nb->nis", B, Gp, optimize=True)             # [N,8,10]
    BdGp = np.einsum("nisb,nxb->nixs", B, dGp, optimize=True)         # [N,8,3,10]
    BddGp = np.einsum("nisb,nxyb->nixys", B, ddGp, optimize=True)     # [N,8,3,3,10]

    Nx = w[..., None] * BGp
    dNx = dw[..., None] * BGp[:, :, None, :] + w[..., None, None] * BdGp
    ddNx = (
        ddw[..., None] * BGp[:, :, None, None, :]
        + dw[:, :, :, None, None] * BdGp[:, :, None, :, :]
        + dw[:, :, None, :, None] * BdGp[:, :, :, None, :]
        + w[..., None, None, None] * BddGp
    )
    return Nx, dNx, ddNx
