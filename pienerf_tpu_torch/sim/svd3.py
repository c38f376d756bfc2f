"""Batched 3x3 SVD by cyclic Jacobi eigendecomposition of F^T F.

Port of ``pienerf_tpu.sim.svd3``: the same fixed 6 sweeps, branchless
rotations and sorting network, so the corotated factors agree with the JAX
package to f32 rounding. ``corotated_delta`` keeps the scalar component
form (nested tuples of [N] tensors), which is what the sim step feeds it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _rot(a, v, p, q):
    """One Jacobi rotation zeroing A[p, q]. a: dict of the 6 symmetric
    components, v: dict of the 9 eigenvector-matrix components."""
    app = a[(p, p)]
    aqq = a[(q, q)]
    apq = a[(p, q)]
    theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
    c = torch.cos(theta)
    s = torch.sin(theta)
    cc, ss, cs = c * c, s * s, c * s

    r = 3 - p - q
    arp = a[(min(r, p), max(r, p))]
    arq = a[(min(r, q), max(r, q))]

    a_new = dict(a)
    a_new[(p, p)] = cc * app + 2.0 * cs * apq + ss * aqq
    a_new[(q, q)] = ss * app - 2.0 * cs * apq + cc * aqq
    a_new[(p, q)] = torch.zeros_like(apq)
    a_new[(min(r, p), max(r, p))] = c * arp + s * arq
    a_new[(min(r, q), max(r, q))] = -s * arp + c * arq

    v_new = dict(v)
    for i in range(3):
        vip, viq = v[(i, p)], v[(i, q)]
        v_new[(i, p)] = c * vip + s * viq
        v_new[(i, q)] = -s * vip + c * viq
    return a_new, v_new


def _jacobi(a, sweeps: int = 6):
    one = torch.ones_like(a[(0, 0)])
    zero = torch.zeros_like(one)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a, v = _rot(a, v, p, q)
    return a, v


def eigh3x3(A: torch.Tensor, sweeps: int = 6
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of [..., 3, 3]: (eigvals [..., 3],
    eigvecs [..., 3, 3] with vectors as columns), unordered."""
    a = {(i, j): A[..., i, j] for i in range(3) for j in range(i, 3)}
    a, v = _jacobi(a, sweeps)
    w = torch.stack([a[(0, 0)], a[(1, 1)], a[(2, 2)]], dim=-1)
    V = torch.stack(
        [torch.stack([v[(i, j)] for j in range(3)], dim=-1)
         for i in range(3)], dim=-2)
    return w, V


def corotated_delta(F, eps: float = 1e-12):
    """Corotated stress factors in component form.

    F: 3x3 nested tuple of [N] tensors, F[i][j] = d phi_i / d p_j.
    Returns (dR, dV), nested tuples of [N] tensors: dR = U V^T - I and
    dV = U diag(proj(S)) V^T - I, where proj is the 3-step Gauss-Newton
    det = 1 projection of the reference solver."""
    a = {}
    for i in range(3):
        for j in range(i, 3):
            a[(i, j)] = sum(F[k][i] * F[k][j] for k in range(3))
    a, v = _jacobi(a)
    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = (torch.where(swap, w[j], w[i]),
                      torch.where(swap, w[i], w[j]))
        for r in range(3):
            vi, vj = v[(r, i)], v[(r, j)]
            v[(r, i)] = torch.where(swap, vj, vi)
            v[(r, j)] = torch.where(swap, vi, vj)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)

    S = [torch.sqrt(torch.clamp(wc, min=0.0)) for wc in w]
    U = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for c in range(3):
            fv = sum(F[i][j] * v[(j, c)] for j in range(3))
            U[i][c] = fv / torch.clamp(S[c], min=eps)

    zero = torch.zeros_like(S[0])
    D = [zero, zero, zero]
    for _ in range(3):
        s0, s1, s2 = (S[0] + D[0], S[1] + D[1], S[2] + D[2])
        C = s0 * s1 * s2 - 1.0
        dC = [s1 * s2, s0 * s2, s0 * s1]
        coef = (sum(dC[c] * D[c] for c in range(3)) - C) \
            / sum(dC[c] * dC[c] for c in range(3))
        D = [coef * dC[c] for c in range(3)]
    Sp = [S[c] + D[c] for c in range(3)]

    dR = tuple(
        tuple(sum(U[i][c] * v[(j, c)] for c in range(3))
              - (1.0 if i == j else 0.0) for j in range(3))
        for i in range(3))
    dV = tuple(
        tuple(sum(U[i][c] * Sp[c] * v[(j, c)] for c in range(3))
              - (1.0 if i == j else 0.0) for j in range(3))
        for i in range(3))
    return dR, dV


def svd3x3(F: torch.Tensor, eps: float = 1e-12
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched SVD of [..., 3, 3] -> (U, S [..., 3] descending, Vt)."""
    A = torch.einsum("...ji,...jk->...ik", F, F)
    w, V = eigh3x3(A)

    def cswap(w, V, i, j):
        swap = w[..., i] < w[..., j]
        w = w.clone()
        V = V.clone()
        wi = torch.where(swap, w[..., j], w[..., i])
        wj = torch.where(swap, w[..., i], w[..., j])
        w[..., i], w[..., j] = wi, wj
        vi = torch.where(swap[..., None], V[..., :, j], V[..., :, i])
        vj = torch.where(swap[..., None], V[..., :, i], V[..., :, j])
        V[..., :, i], V[..., :, j] = vi, vj
        return w, V

    w, V = cswap(w, V, 0, 1)
    w, V = cswap(w, V, 0, 2)
    w, V = cswap(w, V, 1, 2)
    S = torch.sqrt(torch.clamp(w, min=0.0))
    U = (F @ V) / torch.clamp(S[..., None, :], min=eps)
    return U, S, V.transpose(-1, -2)
