"""Quadratic ray bending math: the closed-form 3x3 inverse and the Newton
rest-space solve that the exact-bending oracle uses.

Port of ``pienerf_tpu.ops.bending`` (``_inv3x3``, ``newton_invert``). For
a deformed sample x and an IP k, Newton solves
    F q + 1/2 (dF . q) q = x - p_def_k,   (dF . q)[d, c] = sum_j dF[j,d,c] q_j
for the rest offset q; p_rest = p_ori_k + q. The spatial-hash search
(``bend_points``) is not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _inv3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form 3x3 inverse. Returns (A_inv, ok mask)."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    ok = torch.abs(det) > 1e-20
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    adj = torch.stack([
        torch.stack([c00,
                     a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                     a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]],
                    -1),
        torch.stack([c01,
                     a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                     a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]],
                    -1),
        torch.stack([c02,
                     a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                     a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]],
                    -1),
    ], -2)
    return inv_det[..., None, None] * adj, ok


def newton_invert(
    x: torch.Tensor,             # [M, 3] deformed sample
    p_ori_k: torch.Tensor,       # [M, k, 3] rest IP positions
    p_def_k: torch.Tensor,       # [M, k, 3] deformed IP positions
    F_k: torch.Tensor,           # [M, k, 3, 3]
    dF_k: torch.Tensor,          # [M, k, 3, 3, 3]
    max_iter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, IP) Newton solve with convergence masking. Returns
    (p_rest [M, k, 3], ok [M, k] (all true, as in the JAX package))."""
    q_target = x[:, None, :] - p_def_k
    q = torch.zeros_like(q_target)
    alive = torch.ones(q.shape[:-1], dtype=torch.bool, device=q.device)
    for _ in range(max_iter):
        dFq = torch.einsum("mkjdc,mkj->mkdc", dF_k, q)
        J = F_k + dFq
        J_inv, ok = _inv3x3(J)
        Fq = torch.einsum("mkdc,mkc->mkd", F_k, q)
        dFq_q = torch.einsum("mkdc,mkc->mkd", dFq, q)
        r = Fq + 0.5 * dFq_q - q_target
        dq = torch.einsum("mkdc,mkc->mkd", J_inv, r)
        step_ok = ok & alive
        q = torch.where(step_ok[..., None], q - dq, q)
        converged = torch.sum(dq * dq, dim=-1) < 1e-12
        alive = alive & ok & ~converged
    return p_ori_k + q, torch.ones(q.shape[:-1], dtype=torch.bool,
                                   device=q.device)
